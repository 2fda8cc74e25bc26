"""[Frozen copy of styl3r_tpu_torch/ops/rasterizer/composite.py, the benchmark's reference: it
imports nothing of the program.]

Per-tile alpha compositing and its gradient: the CUDA kernels' wrappers
and their plain PyTorch versions (counterpart of
styl3r_tpu/ops/rasterizer/pallas_kernel.py, pallas_backward.py and
render.py::composite_pallas_diff).

`pack_attrs` gathers per-pair attributes in sorted order, pair-major
(n_pairs, 12) f32, so a thread reads one pair's 48 contiguous bytes (the
JAX package packs attribute-major for the TPU's 128-lane DMA windows).

Only the plain version is kept here; autograd differentiates it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import Tensor


TILE = 16
P = TILE * TILE  # pixels per tile
WINDOW = 128  # pairs per window
N_ATTR = 12  # floats per packed pair row
A_MX, A_MY, A_CA, A_CB, A_CC, A_OP, A_R, A_G, A_B, A_D = range(10)
N_GRAD = A_D + 1  # gradient columns the backward writes; the pad stays 0
T_EPS = 1e-4  # tile early-exit transmittance
# Transmittance below the smallest normal f32 is flushed to 0, in the kernel
# and here (see csrc/composite_fwd.cu): a denormal T can get stuck in a
# product and the backward's window-level reconstruction would amplify it.
T_MIN = torch.finfo(torch.float32).tiny
MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.99


class CompositeOutput(NamedTuple):
    color: Tensor  # (n_tiles, P, 3)
    depth: Tensor  # (n_tiles, P)
    alpha: Tensor  # (n_tiles, P)
    n_done: Tensor  # (n_tiles,) i32 windows composited
    t_final: Tensor  # (n_tiles, P) final transmittance


def max_windows(max_per_tile: int) -> int:
    """Windows a tile may walk: its clamped count plus alignment slack."""
    return -(-max_per_tile // WINDOW) + 1


def pack_attrs(
    mean_x: Tensor, mean_y: Tensor, con_a: Tensor, con_b: Tensor, con_c: Tensor,
    opacities: Tensor, colors: Tensor, depths: Tensor, sorted_gidx: Tensor,
) -> Tensor:
    """Flat (g,) attributes + sorted pair -> gaussian ids -> (n_pairs, 12)
    f32 rows [mx, my, ca, cb, cc, op, r, g, b, depth, 0, 0]."""
    zero = torch.zeros_like(mean_x)
    table = torch.stack(
        [
            mean_x, mean_y, con_a, con_b, con_c, opacities,
            colors[:, 0], colors[:, 1], colors[:, 2], depths, zero, zero,
        ],
        dim=1,
    ).float()
    return table.index_select(0, sorted_gidx.long())


def _pixel_coords(n_tiles: int, grid: Tuple[int, int], dev) -> Tuple[Tensor, Tensor]:
    """Each tile's pixel x and y in its view, (n_tiles, P, 1) f32 each."""
    gy, gx = grid
    tv = torch.arange(n_tiles, device=dev) % (gy * gx)
    pix = torch.arange(P, device=dev)
    px = ((tv % gx)[:, None] * TILE + pix % TILE).float()[:, :, None]  # (T, P, 1)
    py = ((tv // gx)[:, None] * TILE + pix // TILE).float()[:, :, None]
    return px, py


def composite_tiles_plain(
    attrs: Tensor,
    starts: Tensor,
    counts: Tensor,
    background: Tensor,
    grid: Tuple[int, int],
    max_per_tile: int,
    n_views: int = 1,
) -> CompositeOutput:
    """All tiles at once, window by window, with the kernel's masks, its
    tile-level exit rule and its flush of denormal transmittance. Inside a
    window the transmittance is a cumprod over the pairs (the kernel
    multiplies sequentially)."""
    gy, gx = grid
    tiles_per_view = gy * gx
    n_tiles = n_views * tiles_per_view
    n_pairs = attrs.shape[0]
    dev = attrs.device
    starts = starts.long()
    ends = starts + counts.long()
    base = (starts // WINDOW) * WINDOW
    n_windows = torch.clamp((ends - base + WINDOW - 1) // WINDOW, max=max_windows(max_per_tile))

    view = torch.arange(n_tiles, device=dev) // tiles_per_view
    px, py = _pixel_coords(n_tiles, grid, dev)
    lane = torch.arange(WINDOW, device=dev)

    acc = torch.zeros(n_tiles, P, 4, device=dev)
    trans = torch.ones(n_tiles, P, device=dev)
    n_done = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    active = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    for w in range(max_windows(max_per_tile)):
        active = active & (w < n_windows) & (trans.amax(dim=1) > T_EPS)
        if not bool(active.any()):
            break
        gidx = base[:, None] + w * WINDOW + lane  # (T, W)
        live = (gidx >= starts[:, None]) & (gidx < ends[:, None]) & active[:, None]
        a = attrs[gidx.clamp(0, max(n_pairs - 1, 0))]  # (T, W, 12)
        a = a[:, None]  # (T, 1, W, 12) broadcasts over pixels
        dx = px - a[..., A_MX]
        dy = py - a[..., A_MY]
        power = -0.5 * (a[..., A_CA] * dx * dx + a[..., A_CC] * dy * dy) - a[..., A_CB] * dx * dy
        alpha = torch.clamp(a[..., A_OP] * torch.exp(torch.clamp(power, max=0.0)), max=MAX_ALPHA)
        alpha = torch.where(
            (power > 0) | (alpha < MIN_ALPHA) | ~live[:, None, :],
            torch.zeros_like(alpha), alpha,
        )
        cp = torch.cumprod(1.0 - alpha, dim=2)  # (T, P, W)
        excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=2)
        weight = alpha * excl * trans[..., None]
        acc = acc + torch.einsum("tpw,twc->tpc", weight, a[:, 0, :, A_R : A_D + 1])
        trans = trans * cp[..., -1]
        trans = torch.where(trans < T_MIN, torch.zeros_like(trans), trans)
        n_done = n_done + active.int()

    bg = background.float().reshape(n_views, 3)[view]  # (T, 3)
    return CompositeOutput(
        color=acc[..., :3] + trans[..., None] * bg[:, None, :],
        depth=acc[..., 3],
        alpha=1.0 - trans,
        n_done=n_done,
        t_final=trans,
    )


def composite_tiles_diff(attrs, starts, counts, background, grid, max_per_tile, n_views=1) -> CompositeOutput:
    """The plain compositor, differentiable by autograd through its ops."""
    return composite_tiles_plain(attrs, starts, counts, background, grid, max_per_tile, n_views)
