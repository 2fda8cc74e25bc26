"""Port parity for the compositor's gradient: the plain backward against the
Pallas backward kernel run in interpret mode, the Function against autograd
of the plain forward, and render_many's gradients against JAX's.

Tolerances, each with its reason:
  * plain backward vs Pallas (interpret), same sorted attributes: 1e-5 of
    each gradient column's largest magnitude on moderate clouds, 1e-4 on the
    dense saturating one. The two take the same window-level log-space
    reconstruction; the TPU kernel sums with a triangular matmul where the
    port takes a cumsum, and sums pixels in another order, and the dense
    cloud divides by window products near 1e-10, which amplifies that
    rounding (measured: 4e-6 and 2.2e-5). Pairs the reference leaves at
    exactly 0 are exactly 0.
  * the Function vs autograd of composite_tiles_plain: 1e-4 relative, on a
    cloud where no window attenuates a pixel by 1e12 (there the window-level
    reconstruction is exact up to rounding, which division by products of
    many (1 - alpha) amplifies).
  * render_many vs jax.grad(impl="pallas_interpret"): 1e-5 of each input's
    largest gradient (the same algorithm on the same sorted pairs); vs
    impl="jnp" autodiff, 1e-4 of the largest gradient, as
    tests/test_rasterizer.py holds the Pallas backward.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.ops.rasterizer import camera as jcam
from styl3r_tpu.ops.rasterizer import pallas_backward as jpb
from styl3r_tpu.ops.rasterizer import pallas_kernel as jpk
from styl3r_tpu_torch.ops.rasterizer import camera as tcam
from styl3r_tpu_torch.ops.rasterizer import composite as tcomp

jr = importlib.import_module("styl3r_tpu.ops.rasterizer.render")
tr = importlib.import_module("styl3r_tpu_torch.ops.rasterizer.render")

K = np.asarray([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _table(attrs):
    """Port pair-major rows -> the TPU kernel's (16, n_pad) attribute-major
    table."""
    a = np.asarray(attrs)
    n_pad = -(-a.shape[0] // jpk.WINDOW) * jpk.WINDOW
    table = np.zeros((jpk.ATTR_H, n_pad), np.float32)
    table[:10, : a.shape[0]] = a[:, :10].T
    return jnp.asarray(table)


def _pallas_backward(attrs, starts, counts, bg, grid, max_per_tile, n_views, dcolor, ddepth, dalpha):
    """The TPU forward and backward kernels in interpret mode, unpacked by
    gather_window_grads to (n_pairs, 10) rows."""
    table = _table(attrs)
    starts, counts = jnp.asarray(np.asarray(starts)), jnp.asarray(np.asarray(counts))
    _, _, _, n_done, t_final = jpk.composite_tiles_pallas(
        table, starts, counts, jnp.asarray(np.asarray(bg)), grid,
        max_per_tile=max_per_tile, interpret=True, n_views=n_views,
    )
    blocks = jpb.backward_tiles_pallas(
        table, starts, counts, n_done, jnp.asarray(dcolor), jnp.asarray(ddepth),
        jnp.asarray(dalpha), t_final, grid, max_per_tile=max_per_tile,
        interpret=True, n_views=n_views,
    )
    grads = jpb.gather_window_grads(blocks, starts, counts, table.shape[1])
    return np.asarray(grads)[:10, : np.asarray(attrs).shape[0]].T, np.asarray(n_done)


def _port_backward(attrs, starts, counts, bg, grid, max_per_tile, n_views, dcolor, ddepth, dalpha):
    fwd = tcomp.composite_tiles_plain(attrs, starts, counts, bg, grid, max_per_tile, n_views)
    grads = tcomp.composite_backward(
        attrs, starts, counts, fwd.n_done, fwd.t_final, _t(dcolor), _t(ddepth), _t(dalpha), grid, n_views,
        max_per_tile=max_per_tile,
    )
    return grads, fwd.n_done


def _random_pairs(rng, n_views=2, opacity=(0.05, 0.99)):
    """Unaligned, empty, multi-window and clamped pair ranges over 2 fused
    views of 2x2 tiles; neighbouring tiles share 128-pair windows."""
    counts = np.asarray([0, 5, 130, 300, 0, 1, 77, 200], np.int32)
    starts = np.concatenate([[3], 3 + np.cumsum(counts[:-1])]).astype(np.int32)
    n_pairs = int(starts[-1] + counts[-1] + 17)
    tile_of = np.zeros(n_pairs, np.int64)
    for t in range(len(counts)):
        tile_of[starts[t] : starts[t] + counts[t]] = t
    tv = tile_of % 4
    attrs = np.zeros((n_pairs, 12), np.float32)
    attrs[:, 0] = (tv % 2) * 16 + rng.uniform(-4, 20, n_pairs)
    attrs[:, 1] = (tv // 2) * 16 + rng.uniform(-4, 20, n_pairs)
    attrs[:, 2] = rng.uniform(0.01, 0.3, n_pairs)
    attrs[:, 3] = rng.uniform(-0.005, 0.005, n_pairs)
    attrs[:, 4] = rng.uniform(0.01, 0.3, n_pairs)
    attrs[:, 5] = rng.uniform(*opacity, n_pairs)
    attrs[:, 6:9] = rng.uniform(0, 1, (n_pairs, 3))
    attrs[:, 9] = rng.uniform(1, 5, n_pairs)
    bg = rng.uniform(0, 1, (n_views, 3)).astype(np.float32)
    return _t(attrs), _t(starts, torch.int32), _t(np.minimum(counts, 256), torch.int32), _t(bg), (2, 2), 256, n_views


def _dense_cloud_inputs(rng):
    """The dense saturating cloud of test_torch_rasterizer.py: every tile
    walks several windows and the tile early exit fires."""
    n_views, hw, g = 2, (32, 32), 2048
    xy = rng.uniform(-0.6, 0.6, (g, 2))
    z = 1.0 + 0.05 * rng.normal(size=g)
    means = np.concatenate([xy * z[:, None], z[:, None]], 1).astype(np.float32)
    ext = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    ext[:, 0, 3] = 0.02 * np.arange(n_views)
    cams = tcam.make_raster_camera(
        _t(ext), _t(np.tile(K, (n_views, 1, 1))), torch.full((n_views,), 0.1), torch.full((n_views,), 100.0), hw,
    )

    def per_view(x):
        return _t(np.broadcast_to(x[None], (n_views,) + x.shape).copy())

    inputs = tr.composite_inputs(
        cams, per_view(means), None, per_view((0.5 + 0.1 * rng.normal(size=(g, 3, 1))).astype(np.float32)),
        per_view(np.full(g, 0.95, np.float32)), hw,
        scales=per_view(np.full((g, 3), 0.1, np.float32)),
        rotations=per_view(np.tile(np.asarray([0.0, 0.0, 0.0, 1.0], np.float32), (g, 1))),
        max_tiles_per_gaussian=8, max_per_tile=512, pair_cap=4 * n_views * g,
    )
    return inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds, inputs.grid, 512, n_views


def _assert_grads_match(ours, theirs, tol):
    ours = ours.numpy()[:, :10]
    assert np.all(ours[theirs == 0] == 0), "pairs the reference leaves at 0 must be exactly 0"
    for c in range(10):
        scale = max(float(np.abs(theirs[:, c]).max()), 1e-30)
        err = float(np.abs(ours[:, c] - theirs[:, c]).max())
        assert err <= tol * scale, (c, err, scale)


@pytest.mark.parametrize("case", ["random", "dense_early_exit"])
def test_plain_backward_matches_pallas_interpret(case):
    rng = np.random.default_rng(21)
    args = _random_pairs(rng) if case == "random" else _dense_cloud_inputs(rng)
    n_tiles = args[1].shape[0]
    dcolor = rng.normal(size=(n_tiles, 256, 3)).astype(np.float32)
    ddepth = rng.normal(size=(n_tiles, 256)).astype(np.float32)
    dalpha = rng.normal(size=(n_tiles, 256)).astype(np.float32)
    ours, n_done = _port_backward(*args, dcolor, ddepth, dalpha)
    theirs, n_done_ref = _pallas_backward(*args, dcolor, ddepth, dalpha)
    np.testing.assert_array_equal(n_done.numpy(), n_done_ref)
    _assert_grads_match(ours, theirs, tol=1e-5 if case == "random" else 1e-4)
    walked = np.abs(theirs).sum(1) > 0
    assert walked.sum() > 100
    if case == "dense_early_exit":
        starts, counts = args[1].long(), args[2].long()
        windows = (starts % 128 + counts + 127) // 128
        assert bool((n_done.long() < windows).any())  # the early exit fired
        assert (~walked).sum() > 100  # ... and left pairs with no gradient
    else:
        assert int(n_done.max()) >= 3
        # Tile 3 holds 300 pairs clamped to 256: the rest get no gradient.
        clamped = slice(int(args[1][3]) + 256, int(args[1][3]) + 300)
        assert torch.equal(ours[clamped], torch.zeros_like(ours[clamped]))


def test_function_matches_autograd_of_plain_forward():
    """An independent oracle: torch.autograd through composite_tiles_plain
    (exact cumprod gradients) against the Function's window-level backward,
    on moderate opacities, for attrs and the per-view backgrounds."""
    rng = np.random.default_rng(22)
    attrs, starts, counts, bg, grid, max_per_tile, n_views = _random_pairs(rng, opacity=(0.05, 0.6))
    n_tiles = starts.shape[0]
    w_color = _t(rng.normal(size=(n_tiles, 256, 3)))
    w_depth = _t(rng.normal(size=(n_tiles, 256)))
    w_alpha = _t(rng.normal(size=(n_tiles, 256)))

    def loss(fn):
        a, b = attrs.clone().requires_grad_(), bg.clone().requires_grad_()
        out = fn(a, starts, counts, b, grid, max_per_tile, n_views)
        value = (out.color * w_color).sum() + (out.depth * w_depth).sum() + (out.alpha * w_alpha).sum()
        return torch.autograd.grad(value, (a, b))

    ref_a, ref_b = loss(tcomp.composite_tiles_plain)
    ours_a, ours_b = loss(tcomp.composite_tiles_diff)
    torch.testing.assert_close(ours_b, ref_b, rtol=1e-5, atol=1e-5)
    for c in range(10):
        scale = float(ref_a[:, c].abs().max())
        assert scale > 0
        torch.testing.assert_close(ours_a[:, c], ref_a[:, c], rtol=1e-4, atol=1e-4 * scale)
    assert torch.equal(ours_a[:, 10:], torch.zeros_like(ours_a[:, 10:]))


def _render_scene(seed, g=150, n_views=2):
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.5, 6.0, g)
    means = np.stack([rng.uniform(-1, 1, g) * z / 3, rng.uniform(-1, 1, g) * z / 3, z], -1).astype(np.float32)
    ext = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    ext[:, 0, 3] = 0.05 * np.arange(n_views)
    return dict(
        means=means,
        scales=rng.uniform(0.02, 0.1, (g, 3)).astype(np.float32),
        rotations=rng.normal(size=(g, 4)).astype(np.float32),
        harmonics=rng.normal(scale=0.5, size=(g, 3, 4)).astype(np.float32),
        opacities=rng.uniform(0.2, 0.9, g).astype(np.float32),
        backgrounds=rng.uniform(0, 1, (n_views, 3)).astype(np.float32),
        rot_delta=(0.01 * rng.normal(size=(n_views, 3))).astype(np.float32),
        trans_delta=(0.01 * rng.normal(size=(n_views, 3))).astype(np.float32),
        ext=ext,
        target=rng.uniform(0, 1, (n_views, 32, 48, 3)).astype(np.float32),
    )


GRAD_NAMES = ("means", "scales", "rotations", "harmonics", "opacities", "backgrounds", "rot_delta", "trans_delta")
RENDER_KW = dict(max_tiles_per_gaussian=16, max_per_tile=256, pair_cap=300)


def _loss_terms(color, depth, alpha, target):
    return ((color - target) ** 2).mean() + 0.1 * depth.mean() + 0.05 * alpha.mean()


def _jax_render_grads(s, impl, hw=(32, 48)):
    n = s["ext"].shape[0]

    def loss(means, scales, rotations, harmonics, opacities, backgrounds, rot_delta, trans_delta):
        cams = jcam.make_raster_camera(
            jnp.asarray(s["ext"]), jnp.asarray(np.tile(K, (n, 1, 1))), jnp.full((n,), 0.1), jnp.full((n,), 100.0), hw,
            cam_rot_delta=rot_delta, cam_trans_delta=trans_delta,
        )

        def per_view(x):
            return jnp.broadcast_to(x[None], (n,) + x.shape)

        out = jr.render_many(
            cams, per_view(means), None, per_view(harmonics), per_view(opacities), hw, backgrounds,
            scales=per_view(scales), rotations=per_view(rotations), impl=impl, **RENDER_KW,
        )
        return _loss_terms(out.color, out.depth, out.alpha, jnp.asarray(s["target"]))

    args = [jnp.asarray(s[k]) for k in GRAD_NAMES]
    return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=tuple(range(8))))(*args)]


def _port_render_grads(s, hw=(32, 48)):
    n = s["ext"].shape[0]
    args = {k: _t(s[k]).requires_grad_() for k in GRAD_NAMES}
    cams = tcam.make_raster_camera(
        _t(s["ext"]), _t(np.tile(K, (n, 1, 1))), torch.full((n,), 0.1), torch.full((n,), 100.0), hw,
        cam_rot_delta=args["rot_delta"], cam_trans_delta=args["trans_delta"],
    )

    def per_view(x):
        return x[None].expand(n, *x.shape)

    out = tr.render_many(
        cams, per_view(args["means"]), None, per_view(args["harmonics"]), per_view(args["opacities"]), hw,
        args["backgrounds"], scales=per_view(args["scales"]), rotations=per_view(args["rotations"]), **RENDER_KW,
    )
    assert int(out.live_pairs) > int(out.pair_slots)  # the cap drops pairs here
    loss = _loss_terms(out.color, out.depth, out.alpha, _t(s["target"]))
    return [g.numpy() for g in torch.autograd.grad(loss, [args[k] for k in GRAD_NAMES])]


def test_render_many_grads_match_jax():
    """Gradients of a loss on color, depth and alpha w.r.t. every input of
    a 2-view render with a pair_cap: against jax.grad through the Pallas
    kernels (interpret mode), tightly, and against jnp autodiff at 1e-4."""
    s = _render_scene(31)
    ours = _port_render_grads(s)
    pallas = _jax_render_grads(s, "pallas_interpret")
    exact = _jax_render_grads(s, "jnp")
    for name, a, b, c in zip(GRAD_NAMES, ours, pallas, exact):
        scale = float(np.abs(b).max())
        assert scale > 0, name
        assert float(np.abs(a - b).max()) <= 1e-5 * scale, (name, float(np.abs(a - b).max()), scale)
        assert float(np.abs(a - c).max()) <= 1e-4 * float(np.abs(c).max()), name


def _stack_front_sh_grad(n, impl):
    """n wide Gaussians of opacity 1 stacked in depth on the optical axis
    (32^2, max_per_tile 256): the gradient of the mean colour w.r.t. the
    front Gaussian's SH."""
    hw = (32, 32)
    means = np.zeros((n, 3), np.float32)
    means[:, 2] = 2.0 + 0.05 * np.arange(n)
    scales = np.full((n, 3), 0.5, np.float32)
    rotations = np.tile(np.asarray([0.0, 0.0, 0.0, 1.0], np.float32), (n, 1))
    sh = np.full((n, 3, 1), 0.3, np.float32)
    op = np.ones(n, np.float32)
    kw = dict(max_per_tile=256)
    if impl == "port":
        cam = tcam.make_raster_camera(torch.eye(4), _t(K), torch.tensor(0.1), torch.tensor(100.0), hw)
        sh_t = _t(sh).requires_grad_()
        out = tr.render(cam, _t(means), None, sh_t, _t(op), hw, scales=_t(scales), rotations=_t(rotations), **kw)
        return float(torch.autograd.grad(out.color.mean(), sh_t)[0][0, 0, 0])
    cam = jcam.make_raster_camera(jnp.eye(4), jnp.asarray(K), jnp.asarray(0.1), jnp.asarray(100.0), hw)

    def f(sh):
        out = jr.render(cam, jnp.asarray(means), None, sh, jnp.asarray(op), hw,
                        scales=jnp.asarray(scales), rotations=jnp.asarray(rotations), impl=impl, **kw)
        return out.color.mean()

    return float(jax.jit(jax.grad(f))(jnp.asarray(sh))[0, 0, 0])


def test_opaque_stack_keeps_the_reference_window_reconstruction():
    """24 opaque layers on one pixel attenuate it far below 1e-12 inside one
    window: the reference's backward rebuilds T from the clamped window
    product there and scales the front gradients down. The port reproduces
    the Pallas numbers, and both fall below jnp's exact autodiff."""
    port = _stack_front_sh_grad(24, "port")
    pallas = _stack_front_sh_grad(24, "pallas_interpret")
    exact = _stack_front_sh_grad(24, "jnp")
    assert port == pytest.approx(pallas, rel=1e-5)
    assert pallas < 0.95 * exact
    # With 4 layers no window underflows, and all three agree.
    four = [_stack_front_sh_grad(4, impl) for impl in ("port", "pallas_interpret", "jnp")]
    assert four[0] == pytest.approx(four[1], rel=1e-5)
    assert four[1] == pytest.approx(four[2], rel=1e-4)


def _stuck_tile():
    """One tile, one window: 40 wide pairs at alpha 0.9 take every pixel's
    transmittance into the denormals, then 88 at alpha 0.3 follow, under
    which a pair-by-pair product would stay at the smallest denormal
    (1.4e-45 * 0.7 rounds back to 1.4e-45)."""
    attrs = np.zeros((128, 12), np.float32)
    attrs[:, 0:2] = 7.5
    attrs[:, 2] = attrs[:, 4] = 1e-4
    attrs[:, 5] = np.where(np.arange(128) < 40, 0.9, 0.3)
    attrs[:, 6:10] = 0.5
    return _t(attrs), _t([0], torch.int32), _t([128], torch.int32), torch.zeros(1, 3), (1, 1), 256, 1


def test_denormal_transmittance_is_flushed():
    """The forward leaves no denormal transmittance, which the backward's
    division by window products clamped at 1e-12 would amplify: T is 0 as
    the TPU kernel's log-space product gives it."""
    args = _stuck_tile()
    ours = tcomp.composite_tiles_plain(*args)
    t = ours.t_final
    assert bool(((t == 0) | (t >= torch.finfo(torch.float32).tiny)).all())
    assert torch.equal(t, torch.zeros_like(t)) and torch.equal(ours.alpha, torch.ones_like(ours.alpha))
    theirs = _pallas_composite_t_final(*args)
    np.testing.assert_array_equal(t.numpy(), theirs)


def _pallas_composite_t_final(attrs, starts, counts, bg, grid, max_per_tile, n_views):
    out = jpk.composite_tiles_pallas(
        _table(attrs), jnp.asarray(starts.numpy()), jnp.asarray(counts.numpy()), jnp.asarray(bg.numpy()), grid,
        max_per_tile=max_per_tile, interpret=True, n_views=n_views,
    )
    return np.asarray(out[4])


def _one_pass_backward(attrs, starts, counts, n_done, t_final, dcolor, ddepth, dalpha, grid, n_views=1):
    """The backward as one walk over each tile's windows from n_done - 1
    down to 0, carrying T and the suffix of weight * q from window to window,
    in the TPU kernel's order: a second formulation to hold the phased plain
    version against."""
    gy, gx = grid
    n_tiles = n_views * gy * gx
    n_pairs = attrs.shape[0]
    grad = torch.zeros(n_pairs, 12)
    starts = starts.long()
    ends = starts + counts.long()
    base = (starts // 128) * 128
    n_done = n_done.long()
    tv = torch.arange(n_tiles) % (gy * gx)
    pix = torch.arange(256)
    px = ((tv % gx)[:, None] * 16 + pix % 16).float()[:, :, None]
    py = ((tv // gx)[:, None] * 16 + pix // 16).float()[:, :, None]
    t_cur = t_final.clone()
    s_q = torch.zeros(n_tiles, 256)
    for w in range(int(n_done.max()) - 1, -1, -1):
        act = torch.nonzero(w < n_done).squeeze(1)
        gidx = base[act, None] + w * 128 + torch.arange(128)
        in_range = (gidx >= starts[act, None]) & (gidx < ends[act, None])
        a = attrs[gidx.clamp(0, n_pairs - 1)][:, None]
        ca, cb, cc = a[..., 2], a[..., 3], a[..., 4]
        dx, dy = px[act] - a[..., 0], py[act] - a[..., 1]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        g_exp = torch.exp(torch.clamp(power, max=0.0))
        alpha_raw = a[..., 5] * g_exp
        alpha = torch.clamp(alpha_raw, max=0.99)
        composited = (power <= 0) & (alpha >= 1 / 255) & in_range[:, None, :]
        live = composited & (alpha_raw < 0.99)
        alpha_fwd = torch.where(composited, alpha, torch.zeros_like(alpha))
        lm = torch.log1p(-alpha_fwd)
        cum = torch.cumsum(lm, dim=2)
        t_ws = t_cur[act][..., None] / torch.clamp(torch.exp(cum[..., -1:]), min=1e-12)
        t_i = t_ws * torch.exp(cum - lm)
        weight = alpha_fwd * t_i
        dc, dd = dcolor[act], ddepth[act][..., None]
        q = dc[..., 0:1] * a[..., 6] + dc[..., 1:2] * a[..., 7] + dc[..., 2:3] * a[..., 8] + dd * a[..., 9]
        prefix = torch.cumsum(weight * q, dim=2)
        tot = prefix[..., -1:]
        s_q_i = (tot - prefix) + s_q[act][..., None]
        one_minus = torch.clamp(1.0 - alpha_fwd, min=0.01)
        dal = t_i * q - s_q_i / one_minus + dalpha[act][..., None] * (t_final[act][..., None] / one_minus)
        dal = torch.where(live, dal, torch.zeros_like(dal))
        dpower = torch.where(live, alpha, torch.zeros_like(alpha)) * dal
        rows = torch.stack([
            ((ca * dx + cb * dy) * dpower).sum(1), ((cb * dx + cc * dy) * dpower).sum(1),
            (-0.5 * dx * dx * dpower).sum(1), (-dx * dy * dpower).sum(1), (-0.5 * dy * dy * dpower).sum(1),
            (g_exp * dal).sum(1), (weight * dc[..., 0:1]).sum(1), (weight * dc[..., 1:2]).sum(1),
            (weight * dc[..., 2:3]).sum(1), (weight * dd).sum(1),
        ], dim=-1)
        grad[gidx[in_range], :10] = rows[in_range]
        t_cur[act] = t_ws[..., 0]
        s_q[act] = s_q[act] + tot[..., 0]
    return grad


def _clamped_windows_inputs(rng):
    """Two tiles of one view. Tile 0 holds 420 pairs from an unaligned
    start, opaque on its left columns and fading to nothing on its right
    ones: the left pixels meet windows that attenuate them by more than
    1e12 while the right ones keep the tile walking; tile 1 holds 60 pairs
    in the window the two tiles share."""
    counts = np.asarray([420, 60], np.int32)
    starts = np.asarray([37, 457], np.int32)
    n_pairs = 530
    attrs = np.zeros((n_pairs, 12), np.float32)
    attrs[:, 0] = rng.uniform(-2, 4, n_pairs)
    attrs[:, 1] = rng.uniform(0, 16, n_pairs)
    attrs[:, 2] = rng.uniform(0.05, 0.2, n_pairs)
    attrs[:, 3] = rng.uniform(-0.002, 0.002, n_pairs)
    attrs[:, 4] = rng.uniform(0.005, 0.02, n_pairs)
    attrs[:, 5] = rng.uniform(0.3, 1.0, n_pairs)
    attrs[:, 6:9] = rng.uniform(0, 1, (n_pairs, 3))
    attrs[:, 9] = rng.uniform(1, 5, n_pairs)
    attrs[457:, 0] += 16  # tile 1's pairs sit in tile 1
    return _t(attrs), _t(starts, torch.int32), _t(counts, torch.int32), torch.zeros(1, 3), (1, 2), 512, 1


def test_phased_plain_backward_matches_the_one_pass_form_where_the_clamp_fires():
    """The plain backward in the kernel's phases (window sums, the per-pixel
    chain of windows, the gradients) against the one-pass walk it replaced,
    on windows whose clamp at 1e-12 fires at pixels with T_final > 0: the
    same t_ws chain, and the suffix sums regrouped by window, so 1e-5 of
    each gradient column's largest magnitude and the same exact zeros."""
    rng = np.random.default_rng(23)
    attrs, starts, counts, bg, grid, max_per_tile, n_views = _clamped_windows_inputs(rng)
    fwd = tcomp.composite_tiles_plain(attrs, starts, counts, bg, grid, max_per_tile, n_views)
    n_tiles = starts.shape[0]
    dcolor = _t(rng.normal(size=(n_tiles, 256, 3)))
    ddepth = _t(rng.normal(size=(n_tiles, 256)))
    dalpha = _t(rng.normal(size=(n_tiles, 256)))
    args = (attrs, starts, counts, fwd.n_done, fwd.t_final, dcolor, ddepth, dalpha, grid, n_views)
    big_l, _ = tcomp.window_sums_plain(attrs, starts, counts, fwd.n_done, dcolor, ddepth, grid)
    clamped = (big_l < np.log(1e-12)).any(1) & (fwd.t_final > 0)
    assert int(fwd.n_done[0]) == 4 and int(clamped.sum()) >= 10
    ours = tcomp.composite_backward_plain(*args)
    theirs = _one_pass_backward(*args)
    assert torch.equal(ours == 0, theirs == 0)
    assert bool((ours[:37] == 0).all()) and int((ours[:, :10] != 0).any(1).sum()) > 400
    for c in range(10):
        scale = float(theirs[:, c].abs().max())
        assert scale > 0
        assert float((ours[:, c] - theirs[:, c]).abs().max()) <= 1e-5 * scale, c
