"""Per-tile alpha compositing and its gradient: the CUDA kernels' wrappers
and their plain PyTorch versions (counterpart of
styl3r_tpu/ops/rasterizer/pallas_kernel.py, pallas_backward.py and
render.py::composite_pallas_diff).

`pack_attrs` gathers per-pair attributes in sorted order, pair-major
(n_pairs, 12) f32, so a thread reads one pair's 48 contiguous bytes (the
JAX package packs attribute-major for the TPU's 128-lane DMA windows).

`composite_tiles` launches csrc/composite_fwd.cu for CUDA tensors and runs
`composite_tiles_plain` for CPU tensors; there is no other path. Both walk
each tile's pair range in 128-pair windows aligned to global multiples of
128 and stop a tile once all its pixels have transmittance <= 1e-4, so they
return the same n_done as the TPU kernel.

`composite_backward` (csrc/composite_bwd.cu, or `composite_backward_plain`
on the CPU) replays those windows and returns per-pair gradients in the
layout of `attrs`: first each window's per-pixel sums, then the chain of
windows per pixel, then each window's gradients. `composite_tiles_diff`
ties both together as a torch.autograd.Function.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import Tensor

from ...utils import cuda_build

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


class _WindowEval(NamedTuple):
    """One window w of the tiles that walked it, every pixel against every
    pair slot: (A, P, W) per-evaluation tensors, A the active tiles."""
    act: Tensor  # (A,) tile indices
    gidx: Tensor  # (A, W) pair indices
    in_range: Tensor  # (A, W)
    a: Tensor  # (A, 1, W, 12) pair rows
    dx: Tensor
    dy: Tensor
    g_exp: Tensor
    alpha: Tensor  # clamped at 0.99
    live: Tensor
    alpha_fwd: Tensor  # the forward's alpha, 0 where not composited
    lm: Tensor  # log1p(-alpha_fwd)
    cum: Tensor  # inclusive cumsum of lm over the window
    q: Tensor  # <dcolor, rgb> + ddepth * depth
    dc: Tensor  # (A, P, 3)
    dd: Tensor  # (A, P, 1)


def _window_eval(attrs, starts, ends, base, n_done, dcolor, ddepth, px, py, w: int) -> _WindowEval:
    n_pairs = attrs.shape[0]
    act = torch.nonzero(w < n_done).squeeze(1)
    gidx = base[act, None] + w * WINDOW + torch.arange(WINDOW, device=attrs.device)
    in_range = (gidx >= starts[act, None]) & (gidx < ends[act, None])
    a = attrs[gidx.clamp(0, n_pairs - 1)][:, None]
    ca, cb, cc = a[..., A_CA], a[..., A_CB], a[..., A_CC]
    dx = px[act] - a[..., A_MX]
    dy = py[act] - a[..., A_MY]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    g_exp = torch.exp(torch.clamp(power, max=0.0))
    alpha_raw = a[..., A_OP] * g_exp
    alpha = torch.clamp(alpha_raw, max=MAX_ALPHA)
    composited = (power <= 0) & (alpha >= MIN_ALPHA) & in_range[:, None, :]
    live = composited & (alpha_raw < MAX_ALPHA)  # the 0.99 clamp has no gradient
    alpha_fwd = torch.where(composited, alpha, torch.zeros_like(alpha))
    lm = torch.log1p(-alpha_fwd)
    cum = torch.cumsum(lm, dim=2)
    dc = dcolor[act].float()
    dd = ddepth[act].float()[..., None]
    q = dc[..., 0:1] * a[..., A_R] + dc[..., 1:2] * a[..., A_G] + dc[..., 2:3] * a[..., A_B] + dd * a[..., A_D]
    return _WindowEval(act, gidx, in_range, a, dx, dy, g_exp, alpha, live, alpha_fwd, lm, cum, q, dc, dd)


def window_sums_plain(
    attrs: Tensor, starts: Tensor, counts: Tensor, n_done: Tensor, dcolor: Tensor, ddepth: Tensor,
    grid: Tuple[int, int],
) -> Tuple[Tensor, Tensor]:
    """Phase 1 of the backward: per (tile, window) and pixel, L_w = the sum
    of log1p(-alpha) over the composited pairs, and U_w = sum of alpha_j *
    exp(sum of log1p(-alpha) over the pairs in front of j) * q_j, the
    window's sum of weight * q divided by its entry transmittance. Two
    (n_tiles, max(n_done), P) f32 tensors, 0 for windows not walked."""
    n_tiles = starts.shape[0]
    dev = attrs.device
    n_win = int(n_done.max()) if n_tiles else 0
    big_l = torch.zeros(n_tiles, n_win, P, device=dev)
    big_u = torch.zeros(n_tiles, n_win, P, device=dev)
    if attrs.shape[0] == 0:
        return big_l, big_u
    starts = starts.long()
    ends = starts + counts.long()
    base = (starts // WINDOW) * WINDOW
    n_done = n_done.long()
    px, py = _pixel_coords(n_tiles, grid, dev)
    for w in range(n_win):
        e = _window_eval(attrs, starts, ends, base, n_done, dcolor, ddepth, px, py, w)
        big_l[e.act, w] = e.cum[..., -1]
        big_u[e.act, w] = (e.alpha_fwd * torch.exp(e.cum - e.lm) * e.q).sum(2)
    return big_l, big_u


def composite_backward_plain(
    attrs: Tensor,
    starts: Tensor,
    counts: Tensor,
    n_done: Tensor,
    t_final: Tensor,
    dcolor: Tensor,
    ddepth: Tensor,
    dalpha: Tensor,
    grid: Tuple[int, int],
    n_views: int = 1,
) -> Tensor:
    """The backward kernel's function, in the kernel's phases
    (pallas_backward.py::_backward_kernel walks a tile's windows n_done - 1
    down to 0 in series; the phases cut that chain):

      1. per (tile, window) and pixel, L_w and U_w (`window_sums_plain`);
      2. per pixel, from the last walked window down to the first, the
         window's entry transmittance t_ws(w) = t_ws(w + 1) / max(exp(L_w),
         1e-12) with t_ws(n_done) = T_final, and the sum of weight * q over
         the windows behind it, S_w = sum over v > w of t_ws(v) * U_v;
      3. each window's gradients from its t_ws(w) and S_w, with T_i from a
         log-space cumsum, as the TPU kernel takes it with its scan matmul.

    The clamp is the reference's: where a window attenuates by more than
    1e12 this is not the exact gradient, and the port keeps the reference's
    numbers. `dalpha` is the folded dL/dalpha - dL/dcolor . background.
    Returns (n_pairs, 12) f32 gradients in the layout of `attrs`; pairs no
    window reached, or outside every tile's clamped range, stay exactly 0."""
    n_tiles = n_views * grid[0] * grid[1]
    n_pairs = attrs.shape[0]
    dev = attrs.device
    grad = torch.zeros(n_pairs, N_ATTR, device=dev)
    if n_tiles == 0 or n_pairs == 0:
        return grad
    n_done = n_done.long()
    big_l, big_u = window_sums_plain(attrs, starts, counts, n_done, dcolor, ddepth, grid)
    n_win = big_l.shape[1]

    t_ws = torch.zeros(n_tiles, n_win, P, device=dev)
    behind = torch.zeros(n_tiles, n_win, P, device=dev)
    t = t_final.float().clone()
    s_q = torch.zeros(n_tiles, P, device=dev)
    for v in range(n_win - 1, -1, -1):
        act = (v < n_done)[:, None]
        t = torch.where(act, t / torch.clamp(torch.exp(big_l[:, v]), min=1e-12), t)
        t_ws[:, v] = t
        behind[:, v] = s_q
        s_q = torch.where(act, s_q + t * big_u[:, v], s_q)

    starts = starts.long()
    ends = starts + counts.long()
    base = (starts // WINDOW) * WINDOW
    px, py = _pixel_coords(n_tiles, grid, dev)
    for w in range(n_win):
        e = _window_eval(attrs, starts, ends, base, n_done, dcolor, ddepth, px, py, w)
        t_i = t_ws[e.act, w][..., None] * torch.exp(e.cum - e.lm)  # transmittance in front of each pair
        weight = e.alpha_fwd * t_i
        prefix = torch.cumsum(weight * e.q, dim=2)
        s_q_i = (prefix[..., -1:] - prefix) + behind[e.act, w][..., None]  # strictly behind each pair
        one_minus = torch.clamp(1.0 - e.alpha_fwd, min=0.01)
        tfin = t_final[e.act].float()[..., None]
        dal = t_i * e.q - s_q_i / one_minus + dalpha[e.act].float()[..., None] * (tfin / one_minus)
        dal = torch.where(e.live, dal, torch.zeros_like(dal))
        dpower = torch.where(e.live, e.alpha, torch.zeros_like(e.alpha)) * dal
        a, dx, dy = e.a, e.dx, e.dy
        ca, cb, cc = a[..., A_CA], a[..., A_CB], a[..., A_CC]
        rows = torch.stack([
            ((ca * dx + cb * dy) * dpower).sum(1),
            ((cb * dx + cc * dy) * dpower).sum(1),
            (-0.5 * dx * dx * dpower).sum(1),
            (-dx * dy * dpower).sum(1),
            (-0.5 * dy * dy * dpower).sum(1),
            (e.g_exp * dal).sum(1),
            (weight * e.dc[..., 0:1]).sum(1),
            (weight * e.dc[..., 1:2]).sum(1),
            (weight * e.dc[..., 2:3]).sum(1),
            (weight * e.dd).sum(1),
        ], dim=-1)  # (A, W, 10)
        # Tiles own disjoint pair ranges, so each pair is written once.
        grad[e.gidx[e.in_range], :N_GRAD] = rows[e.in_range]
    return grad


def _check(fn: str, name: str, x: Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
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
    fn = "composite_tiles"
    _check(fn, "attrs", attrs, torch.float32, (attrs.shape[0], N_ATTR), dev)
    _check(fn, "starts", starts, torch.int32, (n_tiles,), dev)
    _check(fn, "counts", counts, torch.int32, (n_tiles,), dev)
    _check(fn, "background", background, torch.float32, (n_views, 3), dev)

    color = torch.empty(n_tiles, P, 3, device=dev)
    depth = torch.empty(n_tiles, P, device=dev)
    alpha = torch.empty(n_tiles, P, device=dev)
    t_final = torch.empty(n_tiles, P, device=dev)
    n_done = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    cuda_build.launch(
        "composite_fwd", dev, attrs.data_ptr(), starts.data_ptr(), counts.data_ptr(), background.data_ptr(),
        color.data_ptr(), depth.data_ptr(), alpha.data_ptr(), n_done.data_ptr(), t_final.data_ptr(),
        n_tiles, attrs.shape[0], gy * gx, gx, max_windows(max_per_tile),
    )
    return CompositeOutput(color, depth, alpha, n_done, t_final)


def composite_backward(
    attrs: Tensor,
    starts: Tensor,
    counts: Tensor,
    n_done: Tensor,
    t_final: Tensor,
    dcolor: Tensor,
    ddepth: Tensor,
    dalpha: Tensor,
    grid: Tuple[int, int],
    n_views: int = 1,
    *,
    max_per_tile: int,
) -> Tensor:
    """Per-pair gradients (n_pairs, 12) f32 of the compositor, given the
    forward's inputs, its n_done and t_final, and the cotangents dcolor
    (n_tiles, P, 3), ddepth (n_tiles, P) and the folded dalpha (n_tiles, P).

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    two phases (two launches in utils/trace.py's counter). The grid of
    (tile, window) blocks and the (n_tiles, n_windows, P, 2) f32 scratch of
    the window sums are sized by n_windows = max_windows(max_per_tile), the
    bound on n_done of the forward that took this `max_per_tile`, without
    reading the device; blocks of windows a tile did not walk exit at once."""
    if attrs.device.type == "cpu":
        return composite_backward_plain(
            attrs, starts, counts, n_done, t_final, dcolor, ddepth, dalpha, grid, n_views
        )
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_backward: unsupported device {attrs.device}")
    gy, gx = grid
    n_tiles = n_views * gy * gx
    dev = attrs.device
    if attrs.dim() != 2:
        raise ValueError(f"composite_backward: attrs must be (n_pairs, {N_ATTR}), got {tuple(attrs.shape)}")
    fn = "composite_backward"
    _check(fn, "attrs", attrs, torch.float32, (attrs.shape[0], N_ATTR), dev)
    for name, x in (("starts", starts), ("counts", counts), ("n_done", n_done)):
        _check(fn, name, x, torch.int32, (n_tiles,), dev)
    _check(fn, "dcolor", dcolor, torch.float32, (n_tiles, P, 3), dev)
    for name, x in (("t_final", t_final), ("ddepth", ddepth), ("dalpha", dalpha)):
        _check(fn, name, x, torch.float32, (n_tiles, P), dev)

    grad = torch.zeros(attrs.shape[0], N_ATTR, device=dev)
    n_windows = max_windows(max_per_tile)
    sums = torch.empty(n_tiles, n_windows, P, 2, device=dev)
    cuda_build.launch(
        "composite_bwd", dev, attrs.data_ptr(), starts.data_ptr(), counts.data_ptr(), n_done.data_ptr(),
        t_final.data_ptr(), dcolor.data_ptr(), ddepth.data_ptr(), dalpha.data_ptr(),
        sums.data_ptr(), grad.data_ptr(), n_tiles, attrs.shape[0], gy * gx, gx, n_windows,
    )
    return grad


class CompositeTiles(torch.autograd.Function):
    """composite_tiles with composite_backward as its gradient, w.r.t.
    attrs and the per-view backgrounds (render.py::composite_pallas_diff).
    n_done and t_final are returned for the record and carry no gradient;
    differentiate through alpha = 1 - t_final instead."""

    @staticmethod
    def forward(ctx, attrs, starts, counts, background, grid, max_per_tile, n_views):
        out = composite_tiles(attrs, starts, counts, background, grid, max_per_tile, n_views)
        ctx.save_for_backward(attrs, starts, counts, background, out.n_done, out.t_final)
        ctx.grid, ctx.n_views, ctx.max_per_tile = grid, n_views, max_per_tile
        ctx.mark_non_differentiable(out.n_done, out.t_final)
        return tuple(out)

    @staticmethod
    def backward(ctx, dcolor, ddepth, dalpha, _n_done, _t_final):
        attrs, starts, counts, background, n_done, t_final = ctx.saved_tensors
        n_views = ctx.n_views
        n_tiles = starts.shape[0]
        dcolor = dcolor.float().contiguous()
        grad_attrs = grad_bg = None
        if ctx.needs_input_grad[0]:
            # d/dalpha_i of the T_final * bg color term is
            # -T_final * bg / (1 - alpha_i): fold it into the dalpha channel.
            bg_tile = background.float().reshape(n_views, 3).repeat_interleave(n_tiles // n_views, dim=0)
            da_eff = dalpha.float() - torch.einsum("tpc,tc->tp", dcolor, bg_tile)
            grad_attrs = composite_backward(
                attrs, starts, counts, n_done, t_final, dcolor, ddepth.float().contiguous(),
                da_eff.contiguous(), ctx.grid, n_views, max_per_tile=ctx.max_per_tile,
            )
        if ctx.needs_input_grad[3]:
            per_tile = torch.einsum("tpc,tp->tc", dcolor, t_final)
            grad_bg = per_tile.reshape(n_views, -1, 3).sum(1).reshape(background.shape).to(background.dtype)
        return grad_attrs, None, None, grad_bg, None, None, None


def composite_tiles_diff(
    attrs: Tensor,
    starts: Tensor,
    counts: Tensor,
    background: Tensor,
    grid: Tuple[int, int],
    max_per_tile: int,
    n_views: int = 1,
) -> CompositeOutput:
    """composite_tiles, differentiable w.r.t. attrs and background. Without
    a gradient to record (inference), it is composite_tiles itself."""
    if not (torch.is_grad_enabled() and (attrs.requires_grad or background.requires_grad)):
        return composite_tiles(attrs, starts, counts, background, grid, max_per_tile, n_views)
    return CompositeOutput(*CompositeTiles.apply(attrs, starts, counts, background, grid, max_per_tile, n_views))
