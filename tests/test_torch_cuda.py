"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc, and skip on a host without them.
On a machine with a card (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: forward 1e-5 for f32 values of order 1 (the kernel multiplies
the transmittance pair by pair where the plain version takes a cumprod per
window, so only rounding differs; n_done must be equal). Backward 1e-4 of
each gradient column's largest magnitude (per-pair sums over 256 pixels in
another order, and the window-level reconstruction divides by products of
(1 - alpha)); pairs no window walked must be exactly 0.
"""

import numpy as np
import pytest
import torch

from styl3r_tpu_torch.ops.rasterizer import composite

pytestmark = pytest.mark.cuda


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
    before = composite.launches
    ours = composite.composite_tiles(*args)
    ref = composite.composite_tiles_plain(*args)
    torch.cuda.synchronize()
    assert composite.launches == before + 1
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
    before = composite.backward_launches
    ours = composite.composite_backward(*args)
    ref = composite.composite_backward_plain(*args)
    torch.cuda.synchronize()
    assert composite.backward_launches == before + 1
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

    before = (composite.launches, composite.backward_launches)
    ours = grads(cuda)
    assert (composite.launches, composite.backward_launches) == (before[0] + 1, before[1] + 1)
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
        composite.composite_backward(attrs, starts, counts, n_done, t_final, dcolor, ddepth, dalpha, grid, n_views)


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
    g = composite.composite_backward(*args[:3], ours.n_done, ours.t_final, *cot)
    g_ref = composite.composite_backward_plain(*args[:3], ref.n_done, ref.t_final, *cot)
    torch.testing.assert_close(g, g_ref, rtol=1e-4, atol=1e-4 * float(g_ref.abs().max()))
