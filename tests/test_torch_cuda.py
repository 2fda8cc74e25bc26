"""The port's CUDA kernels against their plain versions, on the card, on
synthetic inputs and on each route's own (alignment, pose refinement, the
fit, orthographic projections), and the distillation stage's steps on the
card against the CPU.

These tests need an NVIDIA GPU and nvcc, and skip on a host without them.
On a machine with a card (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: forward 1e-5 for f32 values of order 1 (the kernel folds each
window's pairs in chunks of consecutive pairs, multiplied pair by pair, and
contracts multiply-adds, where the plain version takes a cumprod per window,
so only rounding differs; n_done must be equal). Backward 1e-4 of
each gradient column's largest magnitude (per-pair sums over 256 pixels in
another order, and the window-level reconstruction divides by products of
(1 - alpha)); pairs no window walked must be exactly 0.
"""

import json

import numpy as np
import pytest
import torch

from styl3r_tpu_torch.ops.rasterizer import composite
from styl3r_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda


def launches():
    """(forward, backward) compositor kernel launches so far: utils/trace.py's
    counters, in which each backward call launches its two phases."""
    c = trace.counters()
    return c["composite_fwd"], c["composite_bwd"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from styl3r_tpu_torch.utils import cuda_build

    try:
        cuda_build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def _inputs(seed, device):
    """Unaligned, empty, multi-window and clamped pair ranges over 2 fused
    views of 2x2 tiles."""
    rng = np.random.default_rng(seed)
    counts = np.asarray([0, 5, 130, 300, 0, 1, 77, 200], np.int32)
    starts = np.concatenate([[3], 3 + np.cumsum(counts[:-1])]).astype(np.int32)
    n_pairs = int(starts[-1] + counts[-1] + 17)
    attrs = np.zeros((n_pairs, 12), np.float32)
    attrs[:, 0:2] = rng.uniform(-4, 36, (n_pairs, 2))
    attrs[:, 2] = rng.uniform(0.01, 0.3, n_pairs)
    attrs[:, 3] = rng.uniform(-0.005, 0.005, n_pairs)
    attrs[:, 4] = rng.uniform(0.01, 0.3, n_pairs)
    attrs[:, 5] = rng.uniform(0.05, 0.99, n_pairs)
    attrs[:, 6:9] = rng.uniform(0, 1, (n_pairs, 3))
    attrs[:, 9] = rng.uniform(1, 5, n_pairs)
    bg = rng.uniform(0, 1, (2, 3)).astype(np.float32)

    def t(x):
        return torch.from_numpy(x).to(device)

    return t(attrs), t(starts), t(np.minimum(counts, 256)), t(bg), (2, 2), 256, 2


def test_composite_kernel_matches_plain(cuda):
    args = _inputs(0, cuda)
    before = launches()[0]
    ours = composite.composite_tiles(*args)
    ref = composite.composite_tiles_plain(*args)
    torch.cuda.synchronize()
    assert launches()[0] == before + 1
    assert torch.equal(ours.n_done, ref.n_done)
    assert int(ref.n_done.max()) >= 3
    for name in ("color", "alpha", "t_final"):
        torch.testing.assert_close(getattr(ours, name), getattr(ref, name), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ours.depth, ref.depth, rtol=1e-5, atol=5e-5)


@pytest.mark.parametrize("bad", ["f64_attrs", "i64_starts", "strided_attrs", "cpu_background"])
def test_composite_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    attrs, starts, counts, bg, grid, max_per_tile, n_views = _inputs(1, cuda)
    if bad == "f64_attrs":
        attrs = attrs.double()
    elif bad == "i64_starts":
        starts = starts.long()
    elif bad == "strided_attrs":
        attrs = torch.cat([attrs, attrs], 1)[:, ::2]
    else:
        bg = bg.cpu()
    with pytest.raises(ValueError):
        composite.composite_tiles(attrs, starts, counts, bg, grid, max_per_tile, n_views)


def _cotangents(seed, n_tiles, device):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(*shape, generator=g, device=device) for shape in ((n_tiles, 256, 3), (n_tiles, 256), (n_tiles, 256))]


def test_backward_kernel_matches_plain(cuda):
    attrs, starts, counts, bg, grid, max_per_tile, n_views = _inputs(2, cuda)
    fwd = composite.composite_tiles(attrs, starts, counts, bg, grid, max_per_tile, n_views)
    args = (attrs, starts, counts, fwd.n_done, fwd.t_final, *_cotangents(0, starts.shape[0], cuda), grid, n_views)
    before = launches()[1]
    ours = composite.composite_backward(*args, max_per_tile=max_per_tile)
    ref = composite.composite_backward_plain(*args)
    torch.cuda.synchronize()
    assert launches()[1] == before + 2  # the backward's two phases
    walked = torch.zeros(attrs.shape[0], dtype=torch.bool, device=cuda)
    for t in range(starts.shape[0]):
        s0, c = int(starts[t]), int(counts[t])
        walked[s0 : min(s0 + c, s0 // 128 * 128 + 128 * int(fwd.n_done[t]))] = True
    assert bool((ours[~walked] == 0).all()) and bool((ref[~walked] == 0).all())
    for c in range(composite.N_GRAD):
        scale = float(ref[:, c].abs().max())
        assert scale > 0
        assert float((ours[:, c] - ref[:, c]).abs().max()) <= 1e-4 * scale, c
    assert torch.equal(ours[:, composite.N_GRAD:], torch.zeros_like(ours[:, composite.N_GRAD:]))


def test_render_gradients_on_the_card_match_the_cpu(cuda):
    """render_many's gradients through both kernels against the same render
    through the plain versions on the CPU: 1e-3 of each input's largest
    gradient (projection rounds differently on the two devices)."""
    from styl3r_tpu_torch.ops.rasterizer.camera import make_raster_camera
    from styl3r_tpu_torch.ops.rasterizer.render import render_many

    rng = np.random.default_rng(3)
    g, n, hw = 300, 2, (64, 64)
    z = rng.uniform(1.5, 5.0, g)
    data = dict(
        means=np.stack([rng.uniform(-1, 1, g) * z / 3, rng.uniform(-1, 1, g) * z / 3, z], -1),
        scales=rng.uniform(0.02, 0.1, (g, 3)), rotations=rng.normal(size=(g, 4)),
        harmonics=rng.normal(scale=0.5, size=(g, 3, 1)), opacities=rng.uniform(0.2, 0.9, g),
    )
    ext = np.tile(np.eye(4), (n, 1, 1))
    ext[:, 0, 3] = [0.0, 0.05]
    k = np.tile(np.asarray([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (n, 1, 1))
    target = rng.uniform(0, 1, (n, *hw, 3))

    def grads(device):
        t = {key: torch.tensor(v, dtype=torch.float32, device=device, requires_grad=True) for key, v in data.items()}
        cams = make_raster_camera(torch.tensor(ext, dtype=torch.float32, device=device),
                                  torch.tensor(k, dtype=torch.float32, device=device),
                                  torch.full((n,), 0.1, device=device), torch.full((n,), 100.0, device=device), hw)
        out = render_many(
            cams, t["means"][None].expand(n, -1, -1), None, t["harmonics"][None].expand(n, -1, -1, -1),
            t["opacities"][None].expand(n, -1), hw, scales=t["scales"][None].expand(n, -1, -1),
            rotations=t["rotations"][None].expand(n, -1, -1), max_tiles_per_gaussian=16, max_per_tile=512,
        )
        loss = ((out.color - torch.tensor(target, dtype=torch.float32, device=device)) ** 2).mean() + 0.1 * out.depth.mean()
        return [x.cpu() for x in torch.autograd.grad(loss, list(t.values()))]

    before = launches()
    ours = grads(cuda)
    assert launches() == (before[0] + 1, before[1] + 2)
    for a, b in zip(ours, grads("cpu")):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 1e-3 * scale


@pytest.mark.parametrize("bad", ["f64_dcolor", "i64_n_done", "strided_dcolor", "cpu_t_final"])
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    attrs, starts, counts, bg, grid, max_per_tile, n_views = _inputs(3, cuda)
    fwd = composite.composite_tiles(attrs, starts, counts, bg, grid, max_per_tile, n_views)
    dcolor, ddepth, dalpha = _cotangents(1, starts.shape[0], cuda)
    n_done, t_final = fwd.n_done, fwd.t_final
    if bad == "f64_dcolor":
        dcolor = dcolor.double()
    elif bad == "i64_n_done":
        n_done = n_done.long()
    elif bad == "strided_dcolor":
        dcolor = torch.cat([dcolor, dcolor], 2)[..., ::2]
    else:
        t_final = t_final.cpu()
    with pytest.raises(ValueError):
        composite.composite_backward(attrs, starts, counts, n_done, t_final, dcolor, ddepth, dalpha, grid, n_views,
                                     max_per_tile=max_per_tile)


def test_forward_kernel_flushes_denormal_transmittance(cuda):
    """One tile whose transmittance falls into the denormals, then meets
    pairs at alpha 0.3: multiplied pair by pair, T would stick at 1.4e-45
    and the backward's window-level reconstruction would amplify it. The
    kernel flushes it to 0, as the plain version does, and both pipelines'
    gradients agree."""
    attrs = torch.zeros(128, 12)
    attrs[:, 0:2] = 7.5
    attrs[:, 2] = attrs[:, 4] = 1e-4
    attrs[:, 5] = torch.where(torch.arange(128) < 40, 0.9, 0.3)
    attrs[:, 6:10] = 0.5
    args = (attrs.to(cuda), torch.tensor([0], dtype=torch.int32, device=cuda),
            torch.tensor([128], dtype=torch.int32, device=cuda), torch.zeros(1, 3, device=cuda), (1, 1), 256, 1)
    ours, ref = composite.composite_tiles(*args), composite.composite_tiles_plain(*args)
    assert torch.equal(ours.t_final, torch.zeros_like(ours.t_final))
    assert torch.equal(ref.t_final, ours.t_final)
    cot = (*_cotangents(2, 1, cuda), (1, 1), 1)
    g = composite.composite_backward(*args[:3], ours.n_done, ours.t_final, *cot, max_per_tile=args[5])
    g_ref = composite.composite_backward_plain(*args[:3], ref.n_done, ref.t_final, *cot)
    torch.testing.assert_close(g, g_ref, rtol=1e-4, atol=1e-4 * float(g_ref.abs().max()))


def _walked(starts, counts, n_done, n_pairs):
    """(n_pairs,) bool: pairs in their tile's clamped range inside the
    windows its forward composited."""
    walked = torch.zeros(n_pairs, dtype=torch.bool, device=starts.device)
    for t in range(starts.shape[0]):
        s0, c = int(starts[t]), int(counts[t])
        walked[s0 : min(s0 + c, s0 // 128 * 128 + 128 * int(n_done[t]))] = True
    return walked


def _pipelines_agree(args, seed):
    """The kernels' pipeline (forward kernel, then the backward kernel on
    its n_done and t_final) against the plain one, at 1e-4 of each gradient
    column's largest magnitude, with exact zeros on pairs no window walked.
    Returns the kernel forward's outputs, the cotangents and both gradients."""
    attrs, starts, counts, bg, grid, max_per_tile, n_views = args
    fwd, fwd_ref = composite.composite_tiles(*args), composite.composite_tiles_plain(*args)
    assert torch.equal(fwd.n_done, fwd_ref.n_done)
    cot = _cotangents(seed, starts.shape[0], attrs.device)
    before = launches()[1]
    ours = composite.composite_backward(attrs, starts, counts, fwd.n_done, fwd.t_final, *cot, grid, n_views,
                                        max_per_tile=max_per_tile)
    ref = composite.composite_backward_plain(attrs, starts, counts, fwd_ref.n_done, fwd_ref.t_final, *cot, grid, n_views)
    torch.cuda.synchronize()
    assert launches()[1] == before + 2  # the backward's two phases
    walked = _walked(starts, counts, fwd.n_done, attrs.shape[0])
    assert bool((ours[~walked] == 0).all()) and bool((ref[~walked] == 0).all())
    assert torch.equal(ours[:, composite.N_GRAD:], torch.zeros_like(ours[:, composite.N_GRAD:]))
    for c in range(composite.N_GRAD):
        scale = float(ref[:, c].abs().max())
        assert scale > 0, c
        assert float((ours[:, c] - ref[:, c]).abs().max()) <= 1e-4 * scale, c
    return fwd, cot, ours, ref


def _seventeen_windows(device):
    """2x2 tiles: tile 0 walks all 17 windows of max_per_tile 2048 from an
    unaligned start (its far corner is never reached, so it never exits
    early; 78 pairs past its clamped count stay 0), tile 1 is empty at an
    aligned start (n_done 0), tiles 2 and 3 hold 1 and 3 pairs."""
    rng = np.random.default_rng(5)
    starts = np.asarray([50, 2176, 2176, 2177], np.int32)
    counts = np.asarray([2048, 0, 1, 3], np.int32)
    n_pairs = 2190
    attrs = np.zeros((n_pairs, 12), np.float32)
    attrs[:, 0:2] = rng.uniform(0, 6, (n_pairs, 2))
    attrs[:, 2] = rng.uniform(0.2, 0.5, n_pairs)
    attrs[:, 3] = rng.uniform(-0.01, 0.01, n_pairs)
    attrs[:, 4] = rng.uniform(0.2, 0.5, n_pairs)
    attrs[:, 5] = rng.uniform(0.02, 0.3, n_pairs)
    attrs[:, 6:9] = rng.uniform(0, 1, (n_pairs, 3))
    attrs[:, 9] = rng.uniform(1, 5, n_pairs)
    attrs[2176, 1] += 16  # tile 2's pair
    attrs[2177:2180, 0:2] += 16  # tile 3's
    bg = rng.uniform(0, 1, (1, 3)).astype(np.float32)

    def t(x):
        return torch.from_numpy(x).to(device)

    return t(attrs), t(starts), t(counts), t(bg), (2, 2), 2048, 1


def _unaligned_span(device):
    """1x2 tiles: tile 0's 200 pairs start at 100 and span three windows,
    the third shared with tile 1's 40 pairs; low opacities keep both
    walking."""
    rng = np.random.default_rng(6)
    starts = np.asarray([100, 300], np.int32)
    counts = np.asarray([200, 40], np.int32)
    n_pairs = 360
    attrs = np.zeros((n_pairs, 12), np.float32)
    attrs[:, 0] = rng.uniform(-4, 20, n_pairs)
    attrs[300:, 0] += 16
    attrs[:, 1] = rng.uniform(-4, 20, n_pairs)
    attrs[:, 2] = rng.uniform(0.01, 0.3, n_pairs)
    attrs[:, 3] = rng.uniform(-0.005, 0.005, n_pairs)
    attrs[:, 4] = rng.uniform(0.01, 0.3, n_pairs)
    attrs[:, 5] = rng.uniform(0.05, 0.5, n_pairs)
    attrs[:, 6:9] = rng.uniform(0, 1, (n_pairs, 3))
    attrs[:, 9] = rng.uniform(1, 5, n_pairs)

    def t(x):
        return torch.from_numpy(x).to(device)

    return t(attrs), t(starts), t(counts), torch.zeros(1, 3, device=device), (1, 2), 256, 1


def _opaque_stack(device, n=24):
    """n wide Gaussians of opacity 1 stacked in depth on the optical axis
    (32^2, max_per_tile 256): windows that attenuate the centre pixels far
    below 1e-12, where the reconstruction's clamp fires."""
    from styl3r_tpu_torch.ops.rasterizer.camera import make_raster_camera
    from styl3r_tpu_torch.ops.rasterizer.render import composite_inputs

    hw = (32, 32)
    means = torch.zeros(1, n, 3, device=device)
    means[..., 2] = 2.0 + 0.05 * torch.arange(n, device=device)
    k = torch.tensor([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]], device=device)
    cams = make_raster_camera(torch.eye(4, device=device)[None], k, torch.full((1,), 0.1, device=device),
                              torch.full((1,), 100.0, device=device), hw)
    inputs = composite_inputs(
        cams, means, None, torch.full((1, n, 3, 1), 0.3, device=device), torch.ones(1, n, device=device), hw,
        scales=torch.full((1, n, 3), 0.5, device=device),
        rotations=torch.tensor([0.0, 0.0, 0.0, 1.0], device=device).expand(1, n, 4), max_per_tile=256,
    )
    return inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds, inputs.grid, 256, 1


# Pairs of a window one thread of csrc/composite_fwd.cu takes (kWindow /
# kChunks).
_CHUNK = 16


def _chunk_edges(device):
    """1x2 tiles whose ranges start and end inside a chunk: tile 0 holds
    pairs [CHUNK + CHUNK/4, 3 CHUNK - CHUNK/4) of window 0, so the window's
    first chunk and the chunks after its third hold none of its pairs; tile
    1 runs on from there into window 2, ending inside a chunk. Low opacities
    keep both walking."""
    rng = np.random.default_rng(8)
    k = _CHUNK
    starts = np.asarray([k + k // 4, 3 * k - k // 4], np.int32)
    ends = np.asarray([3 * k - k // 4, 2 * composite.WINDOW + k + 5], np.int32)
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

    def t(x):
        return torch.from_numpy(x).to(device)

    return t(attrs), t(starts), t(ends - starts), t(bg), (1, 2), 512, 1


@pytest.mark.parametrize("case", ["seventeen_windows", "unaligned_span", "chunk_edges"])
def test_forward_kernel_matches_plain_on_window_and_chunk_edges(cuda, case):
    """The kernel against its plain version where ranges span many windows,
    start unaligned, or start and end inside a chunk and leave a chunk of a
    window empty: n_done equal, values within 1e-5 (depth within 1e-5 of its
    scale)."""
    args = {"seventeen_windows": _seventeen_windows, "unaligned_span": _unaligned_span,
            "chunk_edges": _chunk_edges}[case](cuda)
    before = launches()[0]
    ours = composite.composite_tiles(*args)
    ref = composite.composite_tiles_plain(*args)
    torch.cuda.synchronize()
    assert launches()[0] == before + 1
    assert torch.equal(ours.n_done, ref.n_done)
    assert ours.n_done.tolist() == {"seventeen_windows": [17, 0, 1, 1], "unaligned_span": [3, 1],
                                    "chunk_edges": [1, 3]}[case]
    for name in ("color", "alpha", "t_final"):
        torch.testing.assert_close(getattr(ours, name), getattr(ref, name), rtol=0, atol=1e-5)
    depth_scale = max(1.0, float(ref.depth.abs().max()))
    torch.testing.assert_close(ours.depth, ref.depth, rtol=0, atol=1e-5 * depth_scale)
    assert float(ref.alpha.max()) > 0.5


def test_forward_kernel_is_deterministic(cuda):
    """The chunk partials are folded in a fixed order: two calls on the same
    inputs give bitwise-equal outputs."""
    args = _seventeen_windows(cuda)
    first, second = composite.composite_tiles(*args), composite.composite_tiles(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["seventeen_windows", "unaligned_span", "opaque_stack"])
def test_backward_pipeline_matches_plain(cuda, case):
    args = {"seventeen_windows": _seventeen_windows, "unaligned_span": _unaligned_span,
            "opaque_stack": _opaque_stack}[case](cuda)
    fwd, cot, _, _ = _pipelines_agree(args, seed=4)
    n_done = fwd.n_done.tolist()
    if case == "seventeen_windows":
        assert n_done == [17, 0, 1, 1]
    elif case == "unaligned_span":
        assert n_done == [3, 1]
    else:
        attrs, starts, counts, _, grid, _, _ = args
        big_l, _ = composite.window_sums_plain(attrs, starts, counts, fwd.n_done, cot[0], cot[1], grid)
        assert bool((big_l < np.log(1e-12)).any())  # the clamp fires


def test_backward_kernel_is_deterministic(cuda):
    """No atomics: two calls on the same inputs give bitwise-equal grads."""
    attrs, starts, counts, bg, grid, max_per_tile, n_views = args = _seventeen_windows(cuda)
    fwd = composite.composite_tiles(*args)
    bwd = (attrs, starts, counts, fwd.n_done, fwd.t_final, *_cotangents(5, starts.shape[0], cuda), grid, n_views)
    first = composite.composite_backward(*bwd, max_per_tile=max_per_tile)
    second = composite.composite_backward(*bwd, max_per_tile=max_per_tile)
    assert torch.equal(first, second)
    assert int((first != 0).any(1).sum()) > 1000


def _alignment_scene(device, g=4000, v=3, hw=(64, 64)):
    """A cloud seen by v target views, each at its own pose near the
    identity, and target images rendered from other poses: what pose
    alignment works on."""
    from styl3r_tpu_torch.geometry.gaussians import Gaussians
    from styl3r_tpu_torch.geometry.se3 import se3_exp
    from styl3r_tpu_torch.models.decoder import render_gaussians

    rng = np.random.default_rng(8)
    z = rng.uniform(2, 6, g)
    data = [
        np.stack([rng.uniform(-1.5, 1.5, g), rng.uniform(-1.5, 1.5, g), z], -1), None,
        rng.normal(scale=0.5, size=(g, 3, 1)), rng.uniform(0.5, 1.0, g),
        rng.uniform(0.02, 0.08, (g, 3)), rng.normal(size=(g, 4)),
    ]
    gaussians = Gaussians(*(None if x is None else torch.tensor(x, dtype=torch.float32, device=device)[None]
                            for x in data))

    def cams(seed):
        tau = np.random.default_rng(seed).normal(0, 0.03, (v, 6))
        return se3_exp(torch.tensor(tau, dtype=torch.float32, device=device))[None]

    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], device=device).expand(1, v, 3, 3)
    near, far = torch.full((1, v), 0.1, device=device), torch.full((1, v), 100.0, device=device)
    with torch.no_grad():
        images = render_gaussians(gaussians, cams(1), k, near, far, hw, max_per_tile=512).color
    return gaussians, cams(2), k, near, far, images, hw


def test_camera_delta_gradients_match_plain(cuda, monkeypatch):
    """render_gaussians' MSE gradient w.r.t. three fused views' camera
    deltas through both kernels, against the same render on the card with
    composite_tiles and composite_backward swapped for their plain versions,
    each pipeline on its own state: 1e-3 of the largest component."""
    from styl3r_tpu_torch.models.decoder import render_gaussians

    gaussians, ext, k, near, far, images, hw = _alignment_scene(cuda)

    def grads():
        rot = torch.zeros(1, 3, 3, device=cuda, requires_grad=True)
        trans = torch.zeros(1, 3, 3, device=cuda, requires_grad=True)
        out = render_gaussians(gaussians, ext, k, near, far, hw, cam_rot_delta=rot, cam_trans_delta=trans,
                               max_per_tile=512)
        return torch.autograd.grad(((out.color - images) ** 2).mean(), (rot, trans))

    before = launches()
    ours = grads()
    assert launches() == (before[0] + 1, before[1] + 2)
    monkeypatch.setattr(composite, "composite_tiles", composite.composite_tiles_plain)
    monkeypatch.setattr(composite, "composite_backward",
                        lambda *args, max_per_tile: composite.composite_backward_plain(*args))
    plain = grads()
    assert launches() == (before[0] + 1, before[1] + 2)
    for a, b in zip(ours, plain):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 1e-3 * scale


def test_each_alignment_step_launches_each_kernel_once(cuda):
    from styl3r_tpu_torch.infer.pipeline import align_target_poses

    gaussians, ext, k, near, far, images, hw = _alignment_scene(cuda)
    for steps in (1, 3):
        before = launches()
        aligned = align_target_poses(gaussians, ext, k, near, far, images, hw, steps=steps, max_per_tile=512)
        assert (launches()[0] - before[0], launches()[1] - before[1]) == (steps, 2 * steps)
        assert bool(torch.isfinite(aligned).all()) and float((aligned - ext).abs().max()) > 0


def _refinement_step(device):
    """The first step of refine_pose_photometric on one view of the
    alignment scene (target rendered at one pose, start at another): its
    compositor inputs at zero camera deltas, its target image, and the
    plain forward's outputs."""
    from styl3r_tpu_torch.ops.rasterizer.camera import make_raster_camera
    from styl3r_tpu_torch.ops.rasterizer.render import composite_inputs

    gaussians, ext, k, near, far, images, hw = _alignment_scene(device, v=1)
    zeros = torch.zeros(1, 3, device=device)
    cams = make_raster_camera(ext[0], k[0], near[0], far[0], hw, cam_rot_delta=zeros, cam_trans_delta=zeros)
    inputs = composite_inputs(
        cams, gaussians.means, None, gaussians.harmonics, gaussians.opacities, hw, zeros,
        scales=gaussians.scales, rotations=gaussians.rotations, max_tiles_per_gaussian=8, max_per_tile=2048,
    )
    args = (inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds, inputs.grid, 2048, 1)
    return args, images[0, 0]


def test_kernels_match_plain_on_a_refinement_step(cuda):
    """Both kernels on pose refinement's first step against their plain
    versions, each pipeline on its own state: the forward within 1e-5, the
    backward on the cotangents of the refinement's loss (MSE + 0.2 (1 -
    SSIM), whose 11x11 filter gives nearly every pixel one) within 1e-4 of
    each gradient column's largest magnitude, with exact zeros where no
    window walked."""
    from styl3r_tpu_torch.eval.pose import photometric_loss
    from styl3r_tpu_torch.ops.rasterizer.render import _tiles_to_image

    args, target = _refinement_step(cuda)
    attrs, starts, counts, _, grid, max_per_tile, n_views = args
    fwd, ref = composite.composite_tiles(*args), composite.composite_tiles_plain(*args)
    assert torch.equal(fwd.n_done, ref.n_done) and int(fwd.n_done.max()) >= 2
    for name in ("color", "alpha", "t_final"):
        assert float((getattr(fwd, name) - getattr(ref, name)).abs().max()) <= 1e-5, name
    assert float((fwd.depth - ref.depth).abs().max()) <= 1e-5 * max(1.0, float(ref.depth.abs().max()))
    color = ref.color.detach().requires_grad_()
    (dcolor,) = torch.autograd.grad(photometric_loss(_tiles_to_image(color, 1, *grid)[0], target), color)
    assert float((dcolor != 0).any(-1).float().mean()) > 0.9
    zero = torch.zeros_like(ref.depth)
    ours = composite.composite_backward(attrs, starts, counts, fwd.n_done, fwd.t_final, dcolor, zero, zero, grid,
                                        n_views, max_per_tile=max_per_tile)
    plain = composite.composite_backward_plain(attrs, starts, counts, ref.n_done, ref.t_final, dcolor, zero, zero,
                                               grid, n_views)
    torch.cuda.synchronize()
    walked = _walked(starts, counts, fwd.n_done, attrs.shape[0])
    assert bool((ours[~walked] == 0).all()) and bool((plain[~walked] == 0).all())
    for c in range(composite.N_GRAD):
        scale = float(plain[:, c].abs().max())
        assert scale > 0 or c == composite.A_D, c  # the loss takes no depth
        assert float((ours[:, c] - plain[:, c]).abs().max()) <= 1e-4 * scale, c


def test_each_refinement_step_launches_each_kernel_once(cuda):
    from styl3r_tpu_torch.eval.pose import refine_pose_photometric

    gaussians, ext, k, near, far, images, hw = _alignment_scene(cuda, v=1)
    for steps in (1, 3):
        before = launches()
        refined = refine_pose_photometric(gaussians, ext[0, 0], k[0, 0], images[0, 0], float(near[0, 0]),
                                          float(far[0, 0]), steps=steps, max_per_tile=512)
        assert (launches()[0] - before[0], launches()[1] - before[1]) == (steps, 2 * steps)
        assert refined.shape == (4, 4) and bool(torch.isfinite(refined).all())
        assert float((refined - ext[0, 0]).abs().max()) > 0


def test_forward_kernel_matches_plain_on_orthographic_inputs(cuda):
    """Validation's orthographic projections of a cloud (front/top/side,
    cameras pulled back about 573x the view's width with a 0.1 degree field
    of view, so depths of order 1e3): the kernel against its plain version
    at the renderer's default caps, 1e-5 (depth: of its largest value)."""
    from styl3r_tpu_torch.models.decoder import orthographic_cameras
    from styl3r_tpu_torch.ops.rasterizer.camera import make_raster_camera
    from styl3r_tpu_torch.ops.rasterizer.render import composite_inputs
    from styl3r_tpu_torch.utils.viz import ortho_projection_cameras

    gaussians = _alignment_scene(cuda)[0]
    cams = [torch.from_numpy(c).to(cuda)[None] for c in ortho_projection_cameras(gaussians.means[0].cpu().numpy())]
    ext, k, near, far = orthographic_cameras(*cams)
    hw, v = (256, 256), 3

    def per_view(x):
        return x.expand(v, *x.shape[1:])

    inputs = composite_inputs(
        make_raster_camera(ext[0], k[0], near[0], far[0], hw), per_view(gaussians.means), None,
        per_view(gaussians.harmonics), per_view(gaussians.opacities), hw,
        scales=per_view(gaussians.scales), rotations=per_view(gaussians.rotations),
    )
    args = (inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds, inputs.grid, 4096, inputs.n_views)
    kern, plain = composite.composite_tiles(*args), composite.composite_tiles_plain(*args)
    torch.cuda.synchronize()
    assert int(inputs.live_pairs) > 1000 and float(plain.alpha.max()) > 0.5
    assert torch.equal(kern.n_done, plain.n_done)
    for name in ("color", "alpha", "t_final"):
        assert float((getattr(kern, name) - getattr(plain, name)).abs().max()) <= 1e-5, name
    depth_scale = float(plain.depth.abs().max())
    assert depth_scale > 100 and float((kern.depth - plain.depth).abs().max()) <= 1e-5 * depth_scale


def _fit_first_loss(device, tmp_path, monkeypatch, config="configs/experiment/re10k_3view_style.yaml",
                    overrides=(), teacher=False):
    """One step of `config` (by default stage 2, re10k_3view_style.yaml:
    style 10 + identity) of a tiny model from fixed weights on `device`, its
    dropout masks drawn on the CPU so that both devices draw the same; with
    `teacher`, a tiny distillation teacher, which the trainer draws on the
    CPU. Returns (the first step's logged metrics, compositor launches
    during the fit)."""
    from styl3r_tpu_torch.models import dpt
    from styl3r_tpu_torch.models.distiller import Dust3RTeacher
    from styl3r_tpu_torch.models.styl3r import Batch, Styl3rModel
    from styl3r_tpu_torch.train import trainer as trainer_mod
    from styl3r_tpu_torch.utils.config import load_config

    real_generator = trainer_mod.step_generator
    monkeypatch.setattr(trainer_mod, "step_generator", lambda seed, step, _device: real_generator(seed, step, "cpu"))

    def cpu_mask_dropout(x, p, training, generator, shard=(0, 1)):
        if not training or p == 0.0:
            return x
        rank, world = shard
        n = x.shape[0]
        keep = (torch.rand((world * n, *x.shape[1:]), generator=generator)[rank * n:(rank + 1) * n] >= p).to(x.device)
        return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))

    monkeypatch.setattr(dpt, "dropout", cpu_mask_dropout)
    tiny = dict(enc_depth=1, dec_depth=2, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2, head_feature_dim=16,
                head_last_dim=16, head_layer_dims=(8, 8, 16, 16))
    model = Styl3rModel(sh_degree=0, device=device, **tiny)
    model.load_state_dict(Styl3rModel(sh_degree=0, device="cpu", seed=3, **tiny).state_dict())
    rng = np.random.default_rng(4)
    k = np.asarray([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1.0]], np.float32)
    ext = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 2, 4, 4)).copy()
    ext[:, 1, 0, 3] = 0.1
    batch = Batch(rng.uniform(0, 1, (2, 2, 32, 32, 3)), np.broadcast_to(k, (2, 2, 3, 3)), ext,
                  np.broadcast_to(k, (2, 2, 3, 3)), np.full((2, 2), 0.5), np.full((2, 2), 100.0),
                  rng.uniform(0, 1, (2, 32, 32, 3)), rng.uniform(0.4, 0.6, (2, 2, 32, 32, 3)))
    out = tmp_path / device
    cfg = load_config(config, [
        f"checkpointing.output_dir={out}", "train.log_every_n_steps=1", "train.val_every_n_steps=100",
        "checkpointing.every_n_train_steps=100", "model.decoder.max_per_tile=512",
        "model.decoder.max_tiles_per_gaussian=8", *overrides,
    ])
    trainer = trainer_mod.Trainer(cfg, model=model, teacher=Dust3RTeacher(**dict(tiny, head_last_dim=8)) if teacher
                                  else None)
    before = launches()
    trainer.fit(max_steps=1, batches=iter([batch]))
    trainer.close()
    launched = (launches()[0] - before[0], launches()[1] - before[1])
    first = json.loads((out / "metrics.jsonl").read_text().splitlines()[0])
    return first, launched


def test_tiny_fit_on_the_card_launches_both_kernels_and_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """Trainer.fit's first stage-2 step on the card launches each kernel
    twice (the main and the identity render) and its loss agrees with the
    same step on the CPU within 1e-4 relative (f32 on both, TF32 off; the
    card's convolutions and matmuls sum in other orders)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu_first, cpu_launched = _fit_first_loss("cpu", tmp_path, monkeypatch)
    gpu_first, gpu_launched = _fit_first_loss("cuda", tmp_path, monkeypatch)
    assert cpu_launched == (0, 0) and gpu_launched == (2, 4)
    cpu_loss, gpu_loss = cpu_first["loss"], gpu_first["loss"]
    assert np.isfinite(gpu_loss) and abs(gpu_loss - cpu_loss) <= 1e-4 * abs(cpu_loss)


@pytest.mark.parametrize("stage", ["stage0", "stage1"])
def test_tiny_distillation_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch, stage):
    """The first step of stage 0 (re10k_style_distill.yaml: the teacher and
    Regr3D, no render) and of stage 1 with losses.distill=0.1, tiny model
    and teacher: stage 0 launches no kernel, stage 1 each kernel once; the
    loss and the distillation term agree with the CPU's within 1e-4
    relative (f32, TF32 off; the teacher's points agree to rounding, which
    moves no point across its quantile or confidence threshold here)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    if stage == "stage0":
        kw = dict(config="configs/experiment/re10k_style_distill.yaml", teacher=True)
    else:
        kw = dict(config="configs/experiment/re10k_2view_nvs.yaml", overrides=["losses.distill=0.1"], teacher=True)
    cpu_first, cpu_launched = _fit_first_loss("cpu", tmp_path, monkeypatch, **kw)
    gpu_first, gpu_launched = _fit_first_loss("cuda", tmp_path, monkeypatch, **kw)
    assert cpu_launched == (0, 0) and gpu_launched == ((0, 0) if stage == "stage0" else (1, 2))
    for key in ("loss", "distill"):
        assert gpu_first[key] > 0 and abs(gpu_first[key] - cpu_first[key]) <= 1e-4 * abs(cpu_first[key]), key


def test_posed_adapter_on_the_card_matches_the_cpu(cuda):
    """posed_gaussian_adapter on the card against the same call on the CPU,
    each output within 1e-5 of its largest magnitude (f32 elementwise math,
    rounded otherwise by the card's exp, rsqrt and 2x2 inverse), with one
    camera a view; then its Gaussians rendered through both kernels, whose
    gradients to the raw channels and depths are finite."""
    from styl3r_tpu_torch.geometry.projection import sample_image_grid
    from styl3r_tpu_torch.models.adapter import posed_gaussian_adapter, raw_gaussian_channels
    from styl3r_tpu_torch.models.decoder import render_gaussians

    rng = np.random.default_rng(3)
    hw, v = (32, 32), 2
    coords = sample_image_grid(hw)[0].reshape(1, -1, 2)
    ext = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    ext[1, 0, 3] = 0.1
    k = np.tile(np.asarray([[1.1, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1.0]], np.float32), (v, 1, 1))
    args = dict(
        extrinsics=torch.from_numpy(ext)[:, None], intrinsics=torch.from_numpy(k)[:, None], coordinates=coords,
        depths=torch.from_numpy(rng.uniform(1.0, 3.0, (v, 1024)).astype(np.float32)),
        opacities=torch.from_numpy(rng.uniform(0.2, 0.9, (v, 1024)).astype(np.float32)),
        raw=torch.from_numpy(rng.normal(size=(v, 1024, raw_gaussian_channels(0))).astype(np.float32)),
    )
    ref = posed_gaussian_adapter(**args, image_shape=hw, sh_degree=0)
    leaves = {name: x.to(cuda).requires_grad_(name in ("raw", "depths")) for name, x in args.items()}
    ours = posed_gaussian_adapter(**leaves, image_shape=hw, sh_degree=0)
    for name in ref._fields:
        a, b = getattr(ours, name).detach().cpu(), getattr(ref, name)
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), name
    flat = type(ours)(*(x.reshape(1, v * 1024, *x.shape[2:]) for x in ours))
    cam = torch.eye(4, device=cuda)[None, None]
    kt = torch.from_numpy(k[:1]).to(cuda)[None]
    before = launches()
    out = render_gaussians(flat, cam, kt, torch.full((1, 1), 0.1, device=cuda), torch.full((1, 1), 100.0, device=cuda),
                           hw, max_per_tile=512, max_tiles_per_gaussian=8)
    grads = torch.autograd.grad((out.color**2).mean(), (leaves["raw"], leaves["depths"]))
    torch.cuda.synchronize()
    assert launches() == (before[0] + 1, before[1] + 2)
    assert float(out.alpha.detach().max()) > 0.5
    assert all(bool(torch.isfinite(g).all()) and bool((g != 0).any()) for g in grads)


def test_serve_on_the_card_through_either_compositor(cuda, capsys):
    """python -m styl3r_tpu_torch.bench.serve --tiny on the card, through
    the kernel and through the plain compositor: the same scene gives the
    same live pairs and slots, and only the kernel route launches."""
    from styl3r_tpu_torch.bench import common, serve

    model = common.serving_model(cuda, common.TINY)
    records = {}
    for impl in ("pallas", "jnp"):
        before = launches()[0]
        records[impl] = serve.main(["--tiny", "--iters", "2", "--impl", impl], model=model)
        records[impl]["launched"] = launches()[0] - before
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metric"] == records[impl]["metric"]
    assert records["pallas"]["live_pairs_max"] == records["jnp"]["live_pairs_max"]
    assert records["pallas"]["pair_slots"] == records["jnp"]["pair_slots"]
    assert records["pallas"]["launched"] > 0 and records["jnp"]["launched"] == 0
    assert records["pallas"]["mfu"] > 0 and records["pallas"]["card"]


def test_overfit_colmap_on_the_card_through_either_compositor(cuda, tmp_path, monkeypatch):
    """python -m styl3r_tpu_torch.train.overfit_colmap at tiny widths on the
    card, on chip_smoke.py's synthetic COLMAP scene (16 frames at 64^2),
    through the kernels and through the plain compositor from the same seed:
    the first step's loss agrees within 1e-4 relative (f32, TF32 off; the
    routes differ only in the compositor) and its live pairs are equal; the
    kernel route launches each kernel once a stage-1 step and the forward
    once a held-out view, the plain route nothing."""
    import contextlib

    import chip_smoke
    from styl3r_tpu_torch.bench.common import plain_compositor
    from styl3r_tpu_torch.train import overfit_colmap as oc

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    scene = chip_smoke.overfit_scene(tmp_path / "scene", n_frames=16, size=64, n_points=300)
    make_train_step = oc.make_train_step
    first, current = {}, {}

    def recording(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def call(state, batch, generator):
            metrics = step(state, batch, generator)
            first.setdefault(current["route"], (float(metrics["loss"]), int(metrics["live_pairs"])))
            return metrics
        return call

    monkeypatch.setattr(oc, "make_train_step", recording)
    launched, records = {}, {}
    for route in ("kernels", "plain"):
        current["route"] = route
        before = launches()
        with plain_compositor() if route == "plain" else contextlib.nullcontext():
            records[route] = oc.main(["--scene-dir", str(scene), "--model", "tiny", "--size", "64", "--steps", "2",
                                      "--eval-every", "2", "--gap-min", "2", "--gap-max", "5",
                                      "--output", str(tmp_path / f"{route}.json")])
        launched[route] = (launches()[0] - before[0], launches()[1] - before[1])
    held_out = records["kernels"]["held_out"]
    assert launched == {"kernels": (2 + held_out, 4), "plain": (0, 0)}
    (loss_k, live_k), (loss_p, live_p) = first["kernels"], first["plain"]
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
    assert live_k == live_p > 0
    assert records["kernels"]["backend"] == "cuda" and records["kernels"]["card"]


# -- RoPE2D: csrc/rope2d.cu against ops/rope.py::apply_rope2d on the card ----
# The kernel rounds as the plain version's separate elementwise ops do (the
# same cosf/sinf, each product rounded to the token type before the sum), so
# forward and gradient must be bitwise equal.


def _rope_positions(device, b, views=1, extra=True):
    """The (y, x) positions of `views` 16x16 token grids, each followed by
    the intrinsics token at (16, 0) if `extra`, expanded over b (stride 0)."""
    from styl3r_tpu_torch.models.vit import token_grid_positions

    p = token_grid_positions(16, 16, device)
    if extra:
        p = torch.cat([p, torch.tensor([[16, 0]], dtype=torch.int32, device=device)])
    return p.repeat(views, 1)[None].expand(b, -1, -1)


def _rope_qk(device, case, dtype, heads, seed=0):
    """(q, qpos, k, kpos) at the serving shapes: "self" q and k of an
    Attention, strided views of its qkv output over b·v = 2 rows of 257
    tokens; "cross" the stylizer's cross-attention, 514 content tokens
    against 256 style tokens."""
    g = torch.Generator(device).manual_seed(seed)
    if case == "self":
        qkv = torch.randn(2, 257, 3 * heads * 64, generator=g, device=device).to(dtype)
        q, k, _ = qkv.reshape(2, 257, 3, heads, 64).unbind(2)
        pos = _rope_positions(device, 2)
        return q, pos, k, pos
    q = torch.randn(1, 514, heads, 64, generator=g, device=device).to(dtype)
    k = torch.randn(1, 256, heads, 64, generator=g, device=device).to(dtype)
    return q, _rope_positions(device, 1, views=2), k, _rope_positions(device, 1, extra=False)


def rope_launches():
    return trace.counters()["rope2d"]


@pytest.mark.parametrize("case", ["self", "cross"])
@pytest.mark.parametrize("heads", [16, 12])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_kernel_matches_plain(cuda, dtype, heads, case):
    from styl3r_tpu_torch.ops import rope

    q, qpos, k, kpos = _rope_qk(cuda, case, dtype, heads)
    before = rope_launches()
    with torch.no_grad():
        ours = rope.rope2d_qk(q, qpos, k, kpos)
        one_side = rope.rope2d_qk(q, None, k, kpos)
    torch.cuda.synchronize()
    assert rope_launches() == before + 2
    assert torch.equal(ours[0], rope.apply_rope2d(q, qpos))
    assert torch.equal(ours[1], rope.apply_rope2d(k, kpos))
    assert one_side[0] is q and torch.equal(one_side[1], ours[1])
    assert all(x.is_contiguous() and x.dtype == dtype for x in ours)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_backward_matches_autograd_through_plain(cuda, dtype):
    """The gradient (the kernel as the inverse rotation) is autograd's
    through apply_rope2d, for q and k of one qkv and for one side alone."""
    from styl3r_tpu_torch.ops import rope

    q, pos, k, _ = _rope_qk(cuda, "self", dtype, 16)
    g = torch.Generator(cuda).manual_seed(1)
    cot = [torch.randn(q.shape, generator=g, device=cuda).to(dtype) for _ in range(2)]
    qg, kg = q.detach().clone().requires_grad_(), k.detach().clone().requires_grad_()
    before = rope_launches()
    ours = torch.autograd.grad(rope.rope2d_qk(qg, pos, kg, pos), (qg, kg), cot)
    assert rope_launches() == before + 2
    plain = torch.autograd.grad((rope.apply_rope2d(qg, pos), rope.apply_rope2d(kg, pos)), (qg, kg), cot)
    assert all(torch.equal(a, b) for a, b in zip(ours, plain))
    (dk,) = torch.autograd.grad(rope.rope2d_qk(q, None, kg, pos)[1], kg, cot[1])
    assert torch.equal(dk, plain[1])


@pytest.mark.parametrize("block", ["Block", "DecoderBlock"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_blocks_with_the_rope_kernel_match_plain(cuda, monkeypatch, dtype, block):
    """A Block and a DecoderBlock (768 wide, 12 heads) forward and backward
    on the card, RoPE through the kernel and through apply_rope2d: the same
    outputs, and gradients within the card's run-to-run spread (the
    attention's backward); one launch per RoPE attention forward and one per
    backward."""
    from styl3r_tpu_torch.models import vit
    from styl3r_tpu_torch.ops.rope import apply_rope2d

    torch.manual_seed(0)
    module = getattr(vit, block)(768, 12, rope_base=100.0).to(cuda, dtype)
    g = torch.Generator(cuda).manual_seed(2)
    x = torch.randn(2, 257, 768, generator=g, device=cuda).to(dtype)
    y = torch.randn(2, 257, 768, generator=g, device=cuda).to(dtype)
    pos = _rope_positions(cuda, 2)
    args = (x, pos) if block == "Block" else (x, y, pos, pos)
    n_attn = 1 if block == "Block" else 2

    def run():
        out = module(*args)
        out = out if block == "Block" else out[0]
        grads = torch.autograd.grad((out.float() ** 2).mean(), list(module.parameters()))
        return out.detach(), grads

    before = rope_launches()
    ours = run()
    torch.cuda.synchronize()
    assert rope_launches() == before + 2 * n_attn

    def plain_qk(q, qpos, k, kpos, base):
        return (q if qpos is None else apply_rope2d(q, qpos, base), k if kpos is None else apply_rope2d(k, kpos, base))

    monkeypatch.setattr(vit, "rope2d_qk", plain_qk)
    before = rope_launches()
    plain = run()
    assert rope_launches() == before
    assert torch.equal(ours[0], plain[0])
    for a, b in zip(ours[1], plain[1]):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("bad", ["i64_pos", "head_dim_6", "strided_last_dim", "cpu_pos", "f64_tokens",
                                 "heads_differ"])
def test_rope_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    from styl3r_tpu_torch.ops import rope

    q, qpos, k, kpos = _rope_qk(cuda, "cross", torch.bfloat16, 12)
    if bad == "i64_pos":
        qpos = qpos.long()
    elif bad == "head_dim_6":
        q, k = q[..., :6].contiguous(), k[..., :6].contiguous()
    elif bad == "strided_last_dim":
        q = q[..., ::2]
        k = k[..., ::2]
    elif bad == "cpu_pos":
        kpos = kpos.cpu()
    elif bad == "f64_tokens":
        q, k = q.double(), k.double()
    else:
        k = k[:, :, :6]
    before = rope_launches()
    with pytest.raises(ValueError):
        rope.rope2d_qk(q, qpos, k, kpos)
    assert rope_launches() == before


# -- the DPT heads' 3x3 conv: csrc/conv3x3_f32.cu against F.conv2d ----------

# (images, cin, cout, h, w): every routed head shape of stage 2 (b = 6 over
# 3 views: 6, 12 and 18 images) and of serving's head["2"], and ragged ones.
CONV_SHAPES = [
    (6, 96, 256, 64, 64), (12, 192, 256, 32, 32), (18, 384, 256, 16, 16), (6, 768, 256, 8, 8),
    (1, 768, 256, 8, 8), (18, 256, 256, 8, 8), (6, 256, 256, 16, 16), (12, 256, 256, 32, 32),
    (18, 256, 256, 64, 64), (6, 256, 128, 128, 128), (12, 128, 128, 256, 256), (1, 128, 128, 256, 256),
    (18, 256, 256, 256, 256),
    (3, 32, 96, 17, 23), (1, 256, 96, 17, 23), (2, 5, 7, 9, 11), (2, 16, 24, 1, 3), (1, 130, 130, 13, 130),
]


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _conv_case(shape, bias, device, seed=0):
    n, cin, cout, h, w = shape
    gen = torch.Generator(device).manual_seed(seed)
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1, bias=bias).to(device)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen, device=device) / (9 * cin) ** 0.5)
        if bias:
            conv.bias.copy_(torch.randn(cout, generator=gen, device=device))
    return torch.randn(n, cin, h, w, generator=gen, device=device), conv


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("relu", [False, True], ids=["conv", "conv_relu"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_kernel_matches_f32_conv(cuda, no_tf32, shape, bias, relu):
    """Relative L2 at most 1e-5 from cuDNN's f32 conv: both sum 9 * cin
    products in f32, in other orders. One launch a call; two calls equal
    bit for bit (a fixed summation order, split K included)."""
    from styl3r_tpu_torch.ops import conv as tconv

    x, conv = _conv_case(shape, bias, cuda)
    before = trace.counters()["conv3x3_f32"]
    with torch.no_grad():
        a = tconv.conv3x3(x, conv, relu=relu)
        b = tconv.conv3x3(x, conv, relu=relu)
        want = torch.nn.functional.conv2d(x, conv.weight, conv.bias, padding=1)
    if relu:
        want = torch.relu(want)
    torch.cuda.synchronize()
    assert trace.counters()["conv3x3_f32"] - before == 2
    assert a.shape == want.shape and a.dtype == torch.float32 and a.is_contiguous()
    assert torch.equal(a, b)
    assert _rel_l2(a, want) <= 1e-5


@pytest.mark.parametrize("relu", [False, True], ids=["conv", "conv_relu"])
def test_conv3x3_gradient_is_f32_convs(cuda, no_tf32, monkeypatch, relu):
    """The Function's backward is convolution_backward on the saved input
    and weight: with cuDNN deterministic and the same cotangent, F.conv2d's
    gradients bit for bit (after the ReLU, where the two forwards' masks
    can differ on values that round across 0, to 1e-5)."""
    from styl3r_tpu_torch.ops import conv as tconv

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    x, conv = _conv_case((2, 64, 96, 33, 20), True, cuda, seed=3)
    x.requires_grad_()
    g = torch.randn(2, 96, 33, 20, generator=torch.Generator(cuda).manual_seed(4), device=cuda)
    params = (x, conv.weight, conv.bias)
    before = trace.counters()["conv3x3_f32"]
    ours = torch.autograd.grad(tconv.conv3x3(x, conv, relu=relu), params, g)
    assert trace.counters()["conv3x3_f32"] - before == 1
    y = torch.nn.functional.conv2d(x, conv.weight, conv.bias, padding=1)
    theirs = torch.autograd.grad(torch.relu(y) if relu else y, params, g)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b) if not relu else _rel_l2(a, b) <= 1e-5


@pytest.mark.parametrize("case", ["bf16", "tf32", "autocast", "stride2", "1x1"])
def test_conv3x3_launches_nothing_off_the_route(cuda, no_tf32, monkeypatch, case):
    """bfloat16, TF32 allowed, autocast and convs that are not 3x3 stride-1
    pad-1 take the module's own forward, bit for bit, and no launch."""
    from styl3r_tpu_torch.ops import conv as tconv

    x, conv = _conv_case((2, 16, 24, 12, 10), True, cuda)
    if case == "bf16":
        x, conv = x.bfloat16(), conv.bfloat16()
    elif case == "tf32":
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    elif case in ("stride2", "1x1"):
        conv = torch.nn.Conv2d(16, 24, 3 if case == "stride2" else 1, stride=2 if case == "stride2" else 1,
                               padding=1 if case == "stride2" else 0).to(cuda)
    before = trace.counters()["conv3x3_f32"]
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16, enabled=case == "autocast"):
        got = tconv.conv3x3(x, conv, relu=True)
        want = torch.relu(conv(x))
    assert trace.counters()["conv3x3_f32"] == before
    assert got.dtype == want.dtype and torch.equal(got, want)


# -- the encoder's CUDA graphs (models/encoder.py) -----------------------------

ENCODER_COUNTS = ("rope2d", "conv3x3_f32", "encoder_calls", "encoder_captures", "encoder_replays")


@pytest.fixture(scope="module")
def serving():
    """The full-width serving model (bench/common.py: bf16 trunks stored in
    bf16, the points heads' f32 head["2"]), built once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from styl3r_tpu_torch.bench import common

    return common.serving_model(torch.device("cuda"), {})


def _encoder_inputs(b, seed, device, hw=256, v=2):
    """Context images, intrinsics and a style image, as predict_gaussians
    hands them to the encoder."""
    gen = torch.Generator(device).manual_seed(seed)
    images = torch.rand(b, v, hw, hw, 3, generator=gen, device=device) * 2 - 1
    k = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], device=device)
    return images, k.expand(b, v, 3, 3).contiguous(), torch.rand(b, hw, hw, 3, generator=gen, device=device) * 2 - 1


def _counted(fn):
    """fn()'s result and what it added to the kernel and encoder counters."""
    before = trace.counters()
    out = fn()
    torch.cuda.synchronize()
    after = trace.counters()
    return out, {name: after[name] - before[name] for name in ENCODER_COUNTS}


def _same(a, b):
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def _eager(encoder, inputs):
    """The eager forward on the current stream (return_aux declines the
    graphs)."""
    return encoder(*inputs, return_aux=True)[0]


@pytest.mark.parametrize("b", [1, 8])
def test_replayed_gaussians_equal_the_eager_forward_bitwise(cuda, no_tf32, serving, b):
    """At the serving configuration: a signature's first call (eager, on the
    side stream), the call that captures and the replays give the eager
    forward's Gaussians bit for bit."""
    enc = serving.encoder
    enc._graphs.clear()
    x, y = _encoder_inputs(b, 0, cuda), _encoder_inputs(b, 1, cuda)
    with torch.inference_mode():
        want = [_eager(enc, x), _eager(enc, y)] * 2
        got = [enc(*x), enc(*y), enc(*x), enc(*y)]
    torch.cuda.synchronize()
    assert [_same(g, w) for g, w in zip(got, want)] == [True] * 4
    assert not _same(got[0], got[1])


def test_a_replay_leaves_the_gaussians_returned_before(cuda, no_tf32, serving):
    enc = serving.encoder
    enc._graphs.clear()
    x, y = _encoder_inputs(1, 2, cuda), _encoder_inputs(1, 3, cuda)
    with torch.inference_mode():
        want = _eager(enc, x)
        enc(*x), enc(*x)  # eager, then the capture
        first = enc(*x)
        second = enc(*y)
    torch.cuda.synchronize()
    assert _same(first, want) and not _same(second, first)


def test_an_eager_encoder_forward_does_not_synchronise(cuda, no_tf32, serving):
    """Three views at 192^2: the context-view index and the intrinsics
    token's position are built in the forward, on the device."""
    x = _encoder_inputs(1, 4, cuda, hw=192, v=3)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with torch.inference_mode():
        torch.cuda.set_sync_debug_mode("error")
        try:
            _eager(serving.encoder, x)
        finally:
            torch.cuda.set_sync_debug_mode(mode)


def test_each_signature_is_captured_once_and_replays_count_its_kernels(cuda, no_tf32, serving):
    """Inference mode and no_grad are two signatures: each is eager, then
    captured, then replayed; every forward counts one encoder call, 120 RoPE
    and 2 conv3x3_f32 launches, as the eager forward does."""
    enc = serving.encoder
    enc._graphs.clear()
    x = _encoder_inputs(1, 5, cuda)
    counts = []
    for scope in (torch.inference_mode, torch.no_grad):
        for _ in range(3):
            with scope():
                counts.append(_counted(lambda: enc(*x))[1])
    assert [c["encoder_captures"] for c in counts] == [0, 1, 0] * 2
    assert [c["encoder_replays"] for c in counts] == [0, 0, 1] * 2
    assert [(c["encoder_calls"], c["rope2d"], c["conv3x3_f32"]) for c in counts] == [(1, 120, 2)] * 6
    assert len(enc._graphs) == 2


@pytest.mark.parametrize("change", ["cast_dtypes", "load_in_place", "load_assign"])
def test_the_calls_after_new_weights_equal_the_eager_forward(cuda, no_tf32, change):
    """cast_dtypes and load_state_dict(assign=True) drop the graphs; an
    in-place load writes the storage the graphs read, so they replay on."""
    from styl3r_tpu_torch.bench import common

    model = common.serving_model(cuda, common.TINY_HEADS, keep_f32_params=True)
    enc = model.encoder
    x = _encoder_inputs(1, 6, cuda, hw=64)
    with torch.inference_mode():
        old = [enc(*x) for _ in range(3)][-1]  # eager, capture, replay
    if change == "cast_dtypes":
        model.cast_dtypes()
    else:
        state = {k: v * 1.5 if v.is_floating_point() else v for k, v in model.state_dict().items()}
        model.load_state_dict(state, assign=change == "load_assign")
    with torch.inference_mode():
        want = _eager(enc, x)
        got, counts = zip(*(_counted(lambda: enc(*x)) for _ in range(3)))
    assert change == "cast_dtypes" or not _same(want, old)
    assert [_same(g, want) for g in got] == [True] * 3
    replays = [c["encoder_replays"] for c in counts]
    assert replays == ([1, 1, 1] if change == "load_in_place" else [0, 0, 1])
