"""Operations and bytes of a compositor call, counted from its inputs
(frozen copy of chip_smoke.py's composite_work and composite_bwd_work).

What the forward needs: for every tile, the (pixel, pair) evaluations of
its pairs in range, window by window, up to the window at which all its
pixels' transmittance has fallen to 1e-4 (the early exit). The windows are
walked by the reference's plain compositor on the same inputs; no figure
the kernel reports is used. Each pair row (48 bytes) is read once, the
per-tile ranges and the backgrounds once, and each pixel's color, depth,
alpha and final transmittance (24 bytes) written once with each tile's
window count.

The roofline bound of a call is the larger of its operations over the
float32 peak (the compositor runs on the CUDA cores) and its bytes over
the memory bandwidth."""

from __future__ import annotations

from typing import Tuple

import torch

from ..reference.composite import WINDOW, composite_tiles_plain

PEAK_F32_FLOPS = 67e12  # H100 SXM FP32 (non-tensor) peak, 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# Per (pixel, pair) evaluation of the forward: 11 for the quadratic power,
# 1 exp, 2 for the clamped alpha, 1 weight, 8 for four multiply-adds into
# r, g, b, depth, 2 for the transmittance update.
OPS_PER_EVAL = 25
# Per (pixel, pair) evaluation of the backward, each operation the
# function needs counted once: offsets 2, power 9, clamped alpha with its
# exp 4, masks 2, log1p 2, window sum 1, T_i 4, weight 1, q 7, color/depth
# grads 4, live 1, dalpha 9, geometry and opacity grads 18, suffix 2, and
# 10 for the sums over pixels of the ten gradient columns.
BWD_OPS_PER_EVAL = 76


def windows_walked(attrs, starts, counts, background, grid, max_per_tile, n_views) -> torch.Tensor:
    """(n_tiles,) windows each tile composites before its early exit, as
    the reference walks them."""
    return composite_tiles_plain(attrs, starts, counts, background, grid, max_per_tile, n_views).n_done


def forward_work(starts: torch.Tensor, counts: torch.Tensor, n_done: torch.Tensor, n_views: int) -> Tuple[int, int]:
    """(evaluations, bytes) of a forward call."""
    starts = starts.long()
    ends = starts + counts.long()
    walked = (starts // WINDOW) * WINDOW + WINDOW * n_done.long()
    pairs = int(torch.clamp(torch.minimum(ends, walked) - starts, min=0).sum())
    n_tiles = starts.numel()
    nbytes = pairs * 48 + n_tiles * 8 + n_views * 12 + n_tiles * (256 * 24 + 4)
    return pairs * 256, nbytes


def backward_work(starts: torch.Tensor, counts: torch.Tensor, n_done: torch.Tensor, n_views: int) -> Tuple[int, int]:
    """(evaluations, bytes) of a backward call (both of its kernels): each
    walked pair's row read once and its gradient row written once, the
    per-pixel final transmittance and cotangents and the per-tile ranges
    read once."""
    evals, _ = forward_work(starts, counts, n_done, n_views)
    n_tiles = starts.numel()
    return evals, 2 * (evals // 256) * 48 + n_tiles * (256 * 24 + 12)


def bound_seconds(evals: int, nbytes: int, ops_per_eval: int) -> Tuple[float, str]:
    """The least time the card could take, and what bounds it."""
    t_ops = evals * ops_per_eval / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def forward_bound(args) -> Tuple[float, str]:
    """The bound of one forward call, from its arguments (attrs, starts,
    counts, backgrounds, grid, max_per_tile, n_views)."""
    attrs, starts, counts, background, grid, max_per_tile, n_views = args
    n_done = windows_walked(attrs, starts, counts, background, grid, max_per_tile, n_views)
    evals, nbytes = forward_work(starts, counts, n_done, n_views)
    return bound_seconds(evals, nbytes, OPS_PER_EVAL)


def backward_bound(args) -> Tuple[float, str]:
    """The bound of one backward call, from its arguments (attrs, starts,
    counts, the forward's n_done and t_final, the cotangents, grid, n_views,
    max_per_tile): the windows walked are counted again from attrs, starts
    and counts; the forward kernel's n_done is not read."""
    attrs, starts, counts, _n_done, _t_final, _dcolor, _ddepth, _dalpha, grid, n_views, max_per_tile = args
    background = torch.zeros(n_views, 3, dtype=torch.float32, device=attrs.device)
    walk = windows_walked(attrs, starts, counts, background, grid, max_per_tile, n_views)
    evals, nbytes = backward_work(starts, counts, walk, n_views)
    return bound_seconds(evals, nbytes, BWD_OPS_PER_EVAL)
