"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc, and skip on a host without them.
On a machine with a card (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance 1e-5 for f32 values of order 1: the kernel multiplies the
transmittance pair by pair where the plain version takes a cumprod per
window, so only rounding differs; n_done must be equal.
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
