"""Per-tile alpha compositing: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of styl3r_tpu/ops/rasterizer/pallas_kernel.py,
forward half).

`pack_attrs` gathers per-pair attributes in sorted order, pair-major
(n_pairs, 12) f32, so a thread reads one pair's 48 contiguous bytes (the
JAX package packs attribute-major for the TPU's 128-lane DMA windows).

`composite_tiles` launches csrc/composite_fwd.cu for CUDA tensors and runs
`composite_tiles_plain` for CPU tensors; there is no other path. Both walk
each tile's pair range in 128-pair windows aligned to global multiples of
128 and stop a tile once all its pixels have transmittance <= 1e-4, so they
return the same n_done as the TPU kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
from torch import Tensor

from ...utils import cuda_build

TILE = 16
P = TILE * TILE  # pixels per tile
WINDOW = 128  # pairs per window
N_ATTR = 12  # floats per packed pair row
A_MX, A_MY, A_CA, A_CB, A_CC, A_OP, A_R, A_G, A_B, A_D = range(10)
T_EPS = 1e-4  # tile early-exit transmittance

# Launches of the CUDA kernel since the count was last set to 0.
launches = 0


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


def composite_tiles_plain(
    attrs: Tensor,
    starts: Tensor,
    counts: Tensor,
    background: Tensor,
    grid: Tuple[int, int],
    max_per_tile: int,
    n_views: int = 1,
) -> CompositeOutput:
    """All tiles at once, window by window, with the kernel's masks and its
    tile-level exit rule. Inside a window the transmittance is a cumprod
    over the pairs (the kernel multiplies sequentially)."""
    gy, gx = grid
    tiles_per_view = gy * gx
    n_tiles = n_views * tiles_per_view
    n_pairs = attrs.shape[0]
    dev = attrs.device
    starts = starts.long()
    ends = starts + counts.long()
    base = (starts // WINDOW) * WINDOW
    n_windows = torch.clamp((ends - base + WINDOW - 1) // WINDOW, max=max_windows(max_per_tile))

    t = torch.arange(n_tiles, device=dev)
    view = t // tiles_per_view
    tv = t % tiles_per_view
    pix = torch.arange(P, device=dev)
    px = ((tv % gx)[:, None] * TILE + pix % TILE).float()[:, :, None]  # (T, P, 1)
    py = ((tv // gx)[:, None] * TILE + pix // TILE).float()[:, :, None]
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
        alpha = torch.clamp(a[..., A_OP] * torch.exp(torch.clamp(power, max=0.0)), max=0.99)
        alpha = torch.where(
            (power > 0) | (alpha < 1.0 / 255.0) | ~live[:, None, :],
            torch.zeros_like(alpha), alpha,
        )
        cp = torch.cumprod(1.0 - alpha, dim=2)  # (T, P, W)
        excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=2)
        weight = alpha * excl * trans[..., None]
        acc = acc + torch.einsum("tpw,twc->tpc", weight, a[:, 0, :, A_R : A_D + 1])
        trans = trans * cp[..., -1]
        n_done = n_done + active.int()

    bg = background.float().reshape(n_views, 3)[view]  # (T, 3)
    return CompositeOutput(
        color=acc[..., :3] + trans[..., None] * bg[:, None, :],
        depth=acc[..., 3],
        alpha=1.0 - trans,
        n_done=n_done,
        t_final=trans,
    )


_kernel = None


def _kernel_fn():
    """The C entry point, built and bound at first use."""
    global _kernel
    if _kernel is None:
        fn = cuda_build.load("composite_fwd").composite_fwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel = fn
    return _kernel


def _check(name: str, x: Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"composite_tiles: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}"
        )


def composite_tiles(
    attrs: Tensor,
    starts: Tensor,
    counts: Tensor,
    background: Tensor,
    grid: Tuple[int, int],
    max_per_tile: int,
    n_views: int = 1,
) -> CompositeOutput:
    """Composite every tile of `n_views` fused views.

    attrs: (n_pairs, 12) f32 from pack_attrs; starts/counts: (n_views*gy*gx,)
    i32 pair ranges; background: (n_views, 3) f32; grid: (gy, gx) per view.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if attrs.device.type == "cpu":
        return composite_tiles_plain(attrs, starts, counts, background, grid, max_per_tile, n_views)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_tiles: unsupported device {attrs.device}")
    gy, gx = grid
    n_tiles = n_views * gy * gx
    dev = attrs.device
    if attrs.dim() != 2:
        raise ValueError(f"composite_tiles: attrs must be (n_pairs, {N_ATTR}), got {tuple(attrs.shape)}")
    _check("attrs", attrs, torch.float32, (attrs.shape[0], N_ATTR), dev)
    _check("starts", starts, torch.int32, (n_tiles,), dev)
    _check("counts", counts, torch.int32, (n_tiles,), dev)
    _check("background", background, torch.float32, (n_views, 3), dev)

    color = torch.empty(n_tiles, P, 3, device=dev)
    depth = torch.empty(n_tiles, P, device=dev)
    alpha = torch.empty(n_tiles, P, device=dev)
    t_final = torch.empty(n_tiles, P, device=dev)
    n_done = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the kernel launches on the tensors' device
        rc = _kernel_fn()(
            attrs.data_ptr(), starts.data_ptr(), counts.data_ptr(), background.data_ptr(),
            color.data_ptr(), depth.data_ptr(), alpha.data_ptr(), n_done.data_ptr(),
            t_final.data_ptr(), n_tiles, attrs.shape[0], gy * gx, gx,
            max_windows(max_per_tile), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed with CUDA error {rc}")
    global launches
    launches += 1
    return CompositeOutput(color, depth, alpha, n_done, t_final)
