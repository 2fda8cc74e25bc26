"""Port parity: the styl3r_tpu_torch rasterizer vs styl3r_tpu's.

Projection, SH, binning and sorting against the JAX functions; the plain
compositor against the Pallas kernel run in interpret mode on the same
sorted attributes (color, depth, alpha, n_done, T_final), including a dense
saturating cloud where the tile early exit fires; render_many against JAX
impl="jnp" and against a brute-force per-pixel composite.

Tolerances: 1e-5 for f32 values of order 1 (projection, colors, images),
whose only differences are rounding and summation order; integer outputs
(tile ids, sort order, ranges, n_done) must be equal."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.ops.rasterizer import camera as jcam
from styl3r_tpu.ops.rasterizer import pallas_kernel as jpk
from styl3r_tpu.ops.rasterizer import project as jproj
from styl3r_tpu_torch.ops.rasterizer import camera as tcam
from styl3r_tpu_torch.ops.rasterizer import composite as tcomp
from styl3r_tpu_torch.ops.rasterizer import project as tproj

# The packages export a `render` function that shadows the module's name.
jr = importlib.import_module("styl3r_tpu.ops.rasterizer.render")
tr = importlib.import_module("styl3r_tpu_torch.ops.rasterizer.render")

TOL = dict(rtol=1e-5, atol=1e-5)
K = np.asarray([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _extrinsics(n, shift=0.05):
    ext = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ext[:, 0, 3] = shift * np.arange(n)
    return ext


def _cameras(ext, hw):
    n = ext.shape[0]
    intr = np.tile(K, (n, 1, 1))
    near, far = np.full(n, 0.1, np.float32), np.full(n, 100.0, np.float32)
    jc = jcam.make_raster_camera(jnp.asarray(ext), jnp.asarray(intr), jnp.asarray(near), jnp.asarray(far), hw)
    tc = tcam.make_raster_camera(_t(ext), _t(intr), _t(near), _t(far), hw)
    return jc, tc


def _scene(rng, g, spread=1.5, scale=(0.01, 0.08), sh_degree=0, opacity=(0.2, 0.95)):
    z = rng.uniform(1.0, 6.0, g)
    means = np.stack([rng.uniform(-spread, spread, g) * z / 3, rng.uniform(-spread, spread, g) * z / 3, z], -1)
    return dict(
        means=means.astype(np.float32),
        scales=rng.uniform(*scale, (g, 3)).astype(np.float32),
        rotations=rng.normal(size=(g, 4)).astype(np.float32),
        harmonics=rng.normal(scale=0.5, size=(g, 3, (sh_degree + 1) ** 2)).astype(np.float32),
        opacities=rng.uniform(*opacity, g).astype(np.float32),
    )


def _one(cam, i):
    return type(cam)(*(x[i] for x in cam))


@pytest.mark.parametrize("factors", [True, False], ids=["scales_rotations", "covariances"])
def test_project_gaussians(factors):
    from styl3r_tpu.geometry.gaussians import build_covariance

    rng = np.random.default_rng(0)
    s = _scene(rng, 300, spread=3.0)
    s["means"][:5, 2] = [-1.0, 0.1, 0.0, 1e-7, 0.3]  # behind, near-culled, z = 0
    jc, tc = _cameras(_extrinsics(2), (48, 64))
    if factors:
        kw_t = dict(scales=_t(s["scales"])[None].expand(2, -1, -1), rotations=_t(s["rotations"])[None].expand(2, -1, -1))
        tp = tproj.project_gaussians(tc, _t(s["means"])[None].expand(2, -1, -1), **kw_t)
    else:
        cov = np.asarray(build_covariance(jnp.asarray(s["scales"]), jnp.asarray(s["rotations"])))
        tp = tproj.project_gaussians(tc, _t(s["means"])[None].expand(2, -1, -1), _t(cov)[None].expand(2, -1, -1, -1))
    for i in range(2):
        if factors:
            jp = jproj.project_gaussians(
                _one(jc, i), jnp.asarray(s["means"]),
                scales=jnp.asarray(s["scales"]), rotations=jnp.asarray(s["rotations"]),
            )
        else:
            jp = jproj.project_gaussians(_one(jc, i), jnp.asarray(s["means"]), jnp.asarray(cov))
        for name in jp._fields:
            a, b = getattr(tp, name)[i].numpy(), np.asarray(getattr(jp, name))
            if name == "mask":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4 if name == "radii" else 1e-5)


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_eval_sh(sh_degree):
    rng = np.random.default_rng(1)
    sh = rng.normal(size=(2, 40, 3, (sh_degree + 1) ** 2)).astype(np.float32)
    d = rng.normal(size=(2, 40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tproj.eval_sh(_t(sh), _t(d)).numpy(), np.asarray(jproj.eval_sh(jnp.asarray(sh), jnp.asarray(d))), **TOL
    )


def test_build_pairs_matches_jax():
    rng = np.random.default_rng(2)
    s = _scene(rng, 400, scale=(0.01, 0.2), opacity=(0.0, 1.0))
    jc, tc = _cameras(_extrinsics(1), (64, 64))
    tp = tproj.project_gaussians(tc, _t(s["means"])[None], scales=_t(s["scales"])[None], rotations=_t(s["rotations"])[None])
    fields = ("mean_x", "mean_y", "radii", "depths", "mask")
    conic = dict(con_a=tp.con_a[0], con_b=tp.con_b[0], con_c=tp.con_c[0])
    t_out = tr._build_pairs(*(getattr(tp, f)[0] for f in fields), (4, 4), 6, opacities=_t(s["opacities"]), **conic)
    j_out = jr._build_pairs(
        *(jnp.asarray(getattr(tp, f)[0].numpy()) for f in fields), (4, 4), 6,
        opacities=jnp.asarray(s["opacities"]), **{k: jnp.asarray(v.numpy()) for k, v in conic.items()},
    )
    for a, b in zip(t_out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n_live = int((t_out[0] < 16).sum())
    assert 0 < n_live < t_out[0].numel()  # both kept and culled slots


@pytest.mark.parametrize("n_tiles", [64, 300_000], ids=["packed_key", "two_key_fallback"])
def test_sort_pairs_matches_jax(n_tiles):
    rng = np.random.default_rng(3)
    n = 6000
    tiles = rng.integers(0, min(n_tiles, 40) + 1, n).astype(np.int32)
    tiles[tiles == min(n_tiles, 40)] = n_tiles  # invalid slots
    depths = rng.choice(rng.uniform(0.5, 8.0, 200), n).astype(np.float32)  # many exact ties
    depths[:50] = depths[:50] * (1 + 1e-7)  # ties below a packed key's quantum
    gidx = rng.permutation(n).astype(np.int32)
    t_out = tr._sort_pairs(_t(tiles, torch.int32), _t(depths), _t(gidx, torch.int32), n_tiles)
    j_out = jr._sort_pairs(jnp.asarray(tiles), jnp.asarray(depths), jnp.asarray(gidx), n_tiles)
    for a, b in zip(t_out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _pallas_composite(attrs, starts, counts, bg, grid, max_per_tile, n_views):
    """The TPU kernel in interpret mode on the port's pair-major attributes."""
    a = np.asarray(attrs)
    n_pad = -(-a.shape[0] // jpk.WINDOW) * jpk.WINDOW
    table = np.zeros((jpk.ATTR_H, n_pad), np.float32)
    table[:10, : a.shape[0]] = a[:, :10].T
    out = jpk.composite_tiles_pallas(
        jnp.asarray(table), jnp.asarray(np.asarray(starts)), jnp.asarray(np.asarray(counts)),
        jnp.asarray(np.asarray(bg)), grid, max_per_tile=max_per_tile, interpret=True, n_views=n_views,
    )
    return [np.asarray(x) for x in out]


def _assert_composite_matches(ours, theirs, depth_scale=1.0):
    color, depth, alpha, n_done, t_final = theirs
    np.testing.assert_array_equal(ours.n_done.numpy(), n_done)
    np.testing.assert_allclose(ours.color.numpy(), color, **TOL)
    np.testing.assert_allclose(ours.alpha.numpy(), alpha, **TOL)
    np.testing.assert_allclose(ours.t_final.numpy(), t_final, **TOL)
    np.testing.assert_allclose(ours.depth.numpy(), depth, rtol=1e-5, atol=1e-5 * depth_scale)


def _random_tiles():
    """Random pair rows with unaligned, empty, multi-window and clamped
    ranges over 2 fused views of 2x2 tiles, as numpy arrays: attrs, starts,
    clamped counts, backgrounds, grid, max_per_tile, n_views."""
    rng = np.random.default_rng(4)
    grid, n_views, max_per_tile = (2, 2), 2, 256
    n_tiles = n_views * 4
    counts = np.asarray([0, 5, 130, 300, 0, 1, 77, 200], np.int32)
    starts = np.concatenate([[3], 3 + np.cumsum(counts[:-1])]).astype(np.int32)
    starts[4] = 128  # an empty range that starts on a window boundary
    n_pairs = int(starts[-1] + counts[-1] + 17)
    tile_of = np.zeros(n_pairs, np.int64)
    for t in range(n_tiles):
        tile_of[starts[t] : starts[t] + counts[t]] = t
    tv = tile_of % 4
    attrs = np.zeros((n_pairs, 12), np.float32)
    attrs[:, 0] = (tv % 2) * 16 + rng.uniform(-4, 20, n_pairs)
    attrs[:, 1] = (tv // 2) * 16 + rng.uniform(-4, 20, n_pairs)
    attrs[:, 2] = rng.uniform(0.01, 0.3, n_pairs)
    attrs[:, 3] = rng.uniform(-0.005, 0.005, n_pairs)
    attrs[:, 4] = rng.uniform(0.01, 0.3, n_pairs)
    attrs[:, 5] = rng.uniform(0.05, 0.6, n_pairs)
    attrs[:, 6:9] = rng.uniform(0, 1, (n_pairs, 3))
    attrs[:, 9] = rng.uniform(1, 5, n_pairs)
    bg = rng.uniform(0, 1, (n_views, 3)).astype(np.float32)
    return attrs, starts, np.minimum(counts, max_per_tile), bg, grid, max_per_tile, n_views


def test_plain_compositor_matches_pallas_interpret():
    attrs, starts, counts_c, bg, grid, max_per_tile, n_views = _random_tiles()
    ours = tcomp.composite_tiles(_t(attrs), _t(starts, torch.int32), _t(counts_c, torch.int32), _t(bg), grid, max_per_tile, n_views)
    theirs = _pallas_composite(attrs, starts, counts_c, bg, grid, max_per_tile, n_views)
    _assert_composite_matches(ours, theirs, depth_scale=5.0)
    assert ours.n_done.max() >= 3  # multi-window tiles


def _dense_cloud(rng, g, spread, scale):
    xy = rng.uniform(-spread, spread, (g, 2))
    z = 1.0 + 0.05 * rng.normal(size=g)
    return dict(
        means=np.concatenate([xy * z[:, None], z[:, None]], 1).astype(np.float32),
        scales=np.full((g, 3), scale, np.float32),
        rotations=np.tile(np.asarray([0.0, 0.0, 0.0, 1.0], np.float32), (g, 1)),
        harmonics=(0.5 + 0.1 * rng.normal(size=(g, 3, 1))).astype(np.float32),
        opacities=np.full(g, 0.95, np.float32),
    )


def _per_view(s, n):
    return {k: np.broadcast_to(v[None], (n,) + v.shape).copy() for k, v in s.items()}


def _dense_saturating_cloud():
    """A cloud sized so whole tiles saturate: it overfills the 32x32 frame of
    2 views with 3.2-pixel Gaussians at 2 per pixel (at 256^2, scale 0.02 is
    5 pixels). Returns the Gaussians per view, both packages' cameras and
    the port's compositor inputs."""
    rng = np.random.default_rng(7)
    n_views, hw, max_per_tile = 2, (32, 32), 512
    s = _per_view(_dense_cloud(rng, 2048, spread=0.6, scale=0.1), n_views)
    jc, tc = _cameras(_extrinsics(n_views, 0.02), hw)
    inputs = tr.composite_inputs(
        tc, _t(s["means"]), None, _t(s["harmonics"]), _t(s["opacities"]), hw,
        scales=_t(s["scales"]), rotations=_t(s["rotations"]),
        max_tiles_per_gaussian=8, max_per_tile=max_per_tile, pair_cap=4 * n_views * 2048,
    )
    return s, jc, tc, inputs


def test_dense_saturating_cloud_early_exit():
    """Every tile walks several windows and the tile early exit fires: the
    plain compositor's n_done and images equal the Pallas kernel's on the
    port's own sorted attributes, and the whole render equals JAX's."""
    n_views, hw, max_per_tile = 2, (32, 32), 512
    s, jc, tc, inputs = _dense_saturating_cloud()
    ours = tcomp.composite_tiles_plain(*inputs[:5], max_per_tile, inputs.n_views)
    theirs = _pallas_composite(inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds, inputs.grid, max_per_tile, n_views)
    _assert_composite_matches(ours, theirs, depth_scale=1.1)
    windows = (inputs.starts.long() % 128 + inputs.counts.long() + 127) // 128
    assert int(inputs.live_pairs) > 8 * 128
    assert bool((ours.n_done.long() < windows).any())  # the early exit fired
    assert float((ours.alpha > 0.99).float().mean()) > 0.3

    t_img = tr.render_many(
        tc, _t(s["means"]), None, _t(s["harmonics"]), _t(s["opacities"]), hw,
        scales=_t(s["scales"]), rotations=_t(s["rotations"]),
        max_tiles_per_gaussian=8, max_per_tile=max_per_tile, pair_cap=4 * n_views * 2048,
    )
    j_img = jr.render_many(
        jc, jnp.asarray(s["means"]), None, jnp.asarray(s["harmonics"]), jnp.asarray(s["opacities"]), hw,
        jnp.zeros((n_views, 3)), scales=jnp.asarray(s["scales"]), rotations=jnp.asarray(s["rotations"]),
        max_tiles_per_gaussian=8, max_per_tile=max_per_tile, pair_cap=4 * n_views * 2048, impl="pallas_interpret",
    )
    for name in ("color", "alpha"):
        np.testing.assert_allclose(getattr(t_img, name).numpy(), np.asarray(getattr(j_img, name)), **TOL)
    assert int(t_img.live_pairs) == int(j_img.live_pairs)


# Pairs of a window one thread of csrc/composite_fwd.cu takes (kWindow /
# kChunks): the kernel reduces each such run from T = 1 and folds the runs
# into the pixel's running state in order.
KERNEL_CHUNK = 16


def _sequential_composite(attrs, starts, counts, background, grid, max_per_tile, n_views, chunk=None):
    """The compositor pair by pair, as a thread per pixel would walk it: the
    plain version's masks and exit rule, T flushed below the smallest normal
    f32 after every pair. With `chunk`, each run of `chunk` consecutive
    pairs of a window is reduced from (T = 1, colour = 0) and then folded
    into the running state in order, with a flush after every fold: the
    forward kernel's grouping."""
    gy, gx = grid
    n_tiles = n_views * gy * gx
    run = chunk or tcomp.WINDOW
    starts, ends = starts.long(), starts.long() + counts.long()
    base = (starts // tcomp.WINDOW) * tcomp.WINDOW
    n_windows = torch.clamp((ends - base + tcomp.WINDOW - 1) // tcomp.WINDOW, max=tcomp.max_windows(max_per_tile))
    px, py = tcomp._pixel_coords(n_tiles, grid, attrs.device)
    px, py = px[..., 0], py[..., 0]  # (T, P)
    acc = torch.zeros(n_tiles, tcomp.P, 4)
    trans = torch.ones(n_tiles, tcomp.P)
    n_done = torch.zeros(n_tiles, dtype=torch.int32)
    active = torch.ones(n_tiles, dtype=torch.bool)
    for w in range(tcomp.max_windows(max_per_tile)):
        active = active & (w < n_windows) & (trans.amax(dim=1) > tcomp.T_EPS)
        for r in range(0, tcomp.WINDOW, run):
            if chunk is None:  # the running state itself
                c_acc, c_t = acc, trans
            else:
                c_acc, c_t = torch.zeros_like(acc), torch.ones_like(trans)
            for j in range(r, r + run):
                gidx = base + w * tcomp.WINDOW + j  # (T,)
                live = active & (gidx >= starts) & (gidx < ends)
                a = attrs[gidx.clamp(0, attrs.shape[0] - 1)][:, None, :]  # (T, 1, 12)
                dx, dy = px - a[..., 0], py - a[..., 1]
                power = -0.5 * (a[..., 2] * dx * dx + a[..., 4] * dy * dy) - a[..., 3] * dx * dy
                alpha = torch.clamp(a[..., 5] * torch.exp(torch.clamp(power, max=0.0)), max=tcomp.MAX_ALPHA)
                alpha = torch.where((power > 0) | (alpha < tcomp.MIN_ALPHA) | ~live[:, None], 0.0, alpha)
                c_acc = c_acc + (alpha * c_t)[..., None] * a[..., 6:10]
                c_t = c_t * (1.0 - alpha)
                c_t = torch.where(c_t < tcomp.T_MIN, 0.0, c_t)
            if chunk is None:
                acc, trans = c_acc, c_t
            else:
                acc = acc + trans[..., None] * c_acc
                trans = trans * c_t
                trans = torch.where(trans < tcomp.T_MIN, 0.0, trans)
        n_done = n_done + active.int()
    bg = background.float().reshape(n_views, 3)[torch.arange(n_tiles) // (gy * gx)]
    return tcomp.CompositeOutput(acc[..., :3] + trans[..., None] * bg[:, None, :], acc[..., 3], 1.0 - trans, n_done, trans)


def _chunk_edges():
    """1x2 tiles whose ranges start and end inside a kernel chunk: tile 0
    holds pairs [CHUNK + CHUNK/4, 3 CHUNK - CHUNK/4) of window 0, tile 1
    runs on from there into window 2. Low opacities keep both walking."""
    rng = np.random.default_rng(8)
    k = KERNEL_CHUNK
    starts = np.asarray([k + k // 4, 3 * k - k // 4], np.int32)
    ends = np.asarray([3 * k - k // 4, 2 * tcomp.WINDOW + k + 5], np.int32)
    n_pairs = int(ends[-1]) + 7
    attrs = np.zeros((n_pairs, 12), np.float32)
    attrs[:, 0] = rng.uniform(-4, 20, n_pairs)
    attrs[starts[1]:, 0] += 16
    attrs[:, 1] = rng.uniform(-4, 20, n_pairs)
    attrs[:, 2] = rng.uniform(0.01, 0.3, n_pairs)
    attrs[:, 3] = rng.uniform(-0.005, 0.005, n_pairs)
    attrs[:, 4] = rng.uniform(0.01, 0.3, n_pairs)
    attrs[:, 5] = rng.uniform(0.05, 0.4, n_pairs)
    attrs[:, 6:9] = rng.uniform(0, 1, (n_pairs, 3))
    attrs[:, 9] = rng.uniform(1, 5, n_pairs)
    bg = rng.uniform(0, 1, (1, 3)).astype(np.float32)
    return attrs, starts, ends - starts, bg, (1, 2), 512, 1


@pytest.mark.parametrize("case", ["random_tiles", "dense_saturating_cloud", "chunk_edges"])
def test_chunked_plain_compositor_matches_sequential(case):
    """composite_tiles_plain (a cumprod a window) against the pair-by-pair
    form and against the forward kernel's grouping (runs of KERNEL_CHUNK
    pairs folded in order), both test-local: the same n_done, and values
    within 1e-6 (depth within 1e-6 of its scale); only rounding differs, so
    the kernel's chunks leave the exit rule where the plain version has it."""
    if case == "dense_saturating_cloud":
        inputs = _dense_saturating_cloud()[3]
        args = (*inputs[:5], 512, inputs.n_views)
    else:
        attrs, starts, counts, bg, grid, max_per_tile, n_views = _random_tiles() if case == "random_tiles" else _chunk_edges()
        args = (_t(attrs), _t(starts, torch.int32), _t(counts, torch.int32), _t(bg), grid, max_per_tile, n_views)
    ours = tcomp.composite_tiles_plain(*args)
    assert int(ours.n_done.max()) >= 3
    for other in (_sequential_composite(*args), _sequential_composite(*args, chunk=KERNEL_CHUNK)):
        np.testing.assert_array_equal(ours.n_done.numpy(), other.n_done.numpy())
        for name in ("color", "alpha", "t_final"):
            np.testing.assert_allclose(getattr(ours, name).numpy(), getattr(other, name).numpy(), rtol=0, atol=1e-6)
        depth_scale = float(other.depth.abs().max())
        np.testing.assert_allclose(ours.depth.numpy(), other.depth.numpy(), rtol=0, atol=1e-6 * depth_scale)


@pytest.mark.parametrize("pair_cap", [None, 2000], ids=["no_cap", "pair_cap"])
def test_render_many_matches_jax_jnp(pair_cap):
    rng = np.random.default_rng(8)
    n_views, hw, g = 3, (48, 64), 150
    s = _per_view(_scene(rng, g, sh_degree=1), n_views)
    jc, tc = _cameras(_extrinsics(n_views), hw)
    bg = rng.uniform(0, 1, (n_views, 3)).astype(np.float32)
    kw = dict(max_tiles_per_gaussian=16, max_per_tile=256, pair_cap=pair_cap)
    t_img = tr.render_many(
        tc, _t(s["means"]), None, _t(s["harmonics"]), _t(s["opacities"]), hw, _t(bg),
        scales=_t(s["scales"]), rotations=_t(s["rotations"]), **kw,
    )
    j_img = jr.render_many(
        jc, jnp.asarray(s["means"]), None, jnp.asarray(s["harmonics"]), jnp.asarray(s["opacities"]), hw,
        jnp.asarray(bg), scales=jnp.asarray(s["scales"]), rotations=jnp.asarray(s["rotations"]), impl="jnp", **kw,
    )
    for name in ("color", "alpha"):
        np.testing.assert_allclose(getattr(t_img, name).numpy(), np.asarray(getattr(j_img, name)), **TOL)
    np.testing.assert_allclose(t_img.depth.numpy(), np.asarray(j_img.depth), rtol=1e-5, atol=6e-5)
    assert int(t_img.live_pairs) == int(j_img.live_pairs)
    assert int(t_img.pair_slots) == int(j_img.pair_slots)
    if pair_cap is not None:
        assert int(t_img.pair_slots) == 2048 < n_views * g * 16  # rounded up to 128


def brute_force_render(proj, colors, opacities, hw, bg):
    """Per-pixel front-to-back composite of every Gaussian in depth order,
    with the same 3-sigma tile-bbox truncation as the renderer."""
    h, w = hw
    mx, my, dep = proj.mean_x.numpy(), proj.mean_y.numpy(), proj.depths.numpy()
    ca, cb, cc = proj.con_a.numpy(), proj.con_b.numpy(), proj.con_c.numpy()
    rad, msk = proj.radii.numpy(), proj.mask.numpy()
    img = np.zeros((h, w, 3), np.float64)
    depth = np.zeros((h, w), np.float64)
    trans = np.ones((h, w), np.float64)
    ys, xs = np.mgrid[0:h, 0:w]
    gx, gy = w // 16, h // 16
    for i in np.argsort(dep, kind="stable"):
        if not msk[i] or rad[i] <= 0:
            continue
        tx0, tx1 = (int(np.clip(np.floor((mx[i] + sgn * rad[i]) / 16), 0, gx - 1)) for sgn in (-1, 1))
        ty0, ty1 = (int(np.clip(np.floor((my[i] + sgn * rad[i]) / 16), 0, gy - 1)) for sgn in (-1, 1))
        inside = (xs // 16 >= tx0) & (xs // 16 <= tx1) & (ys // 16 >= ty0) & (ys // 16 <= ty1)
        dx, dy = xs - mx[i], ys - my[i]
        power = -0.5 * (ca[i] * dx * dx + cc[i] * dy * dy) - cb[i] * dx * dy
        alpha = np.minimum(opacities[i] * np.exp(np.minimum(power, 0)), 0.99)
        alpha = np.where((power > 0) | (alpha < 1 / 255.0) | ~inside, 0.0, alpha)
        img += (alpha * trans)[..., None] * colors[i]
        depth += alpha * trans * dep[i]
        trans *= 1 - alpha
    return img + trans[..., None] * bg, depth, 1 - trans


def test_render_matches_brute_force():
    rng = np.random.default_rng(9)
    hw, g = (64, 64), 120
    s = _scene(rng, g)
    _, tc = _cameras(_extrinsics(1), hw)
    cam = _one(tc, 0)
    bg = np.asarray([0.2, 0.4, 0.6], np.float32)
    out = tr.render(
        cam, _t(s["means"]), None, _t(s["harmonics"]), _t(s["opacities"]), hw, _t(bg),
        scales=_t(s["scales"]), rotations=_t(s["rotations"]), max_tiles_per_gaussian=32, max_per_tile=1024,
    )
    proj = tproj.project_gaussians(cam, _t(s["means"]), scales=_t(s["scales"]), rotations=_t(s["rotations"]))
    dirs = _t(s["means"]) - cam.cam_pos
    colors = tproj.eval_sh(_t(s["harmonics"]), dirs / dirs.norm(dim=-1, keepdim=True)).numpy()
    img, depth, alpha = brute_force_render(proj, colors, s["opacities"], hw, bg)
    np.testing.assert_allclose(out.color.numpy(), img, **TOL)
    np.testing.assert_allclose(out.alpha.numpy(), alpha, **TOL)
    np.testing.assert_allclose(out.depth.numpy(), depth, rtol=1e-5, atol=6e-5)
    assert float(out.alpha.max()) > 0.5
