"""2D rotary position embeddings (counterpart of styl3r_tpu/ops/rope.py;
reference `src/model/encoder/backbone/croco/pos_embed.py:112-159`).

The head dim D splits into a Y half and an X half; each half of size F gets
1D RoPE with inv_freq[f] = 1 / base**(2f/F), the cos/sin vector is
cat(freqs, freqs) and rotate_half maps (x1, x2) -> (-x2, x1). Positions are
integer (y, x) token-grid coordinates.

`rope2d_qk` rotates an attention's q and k: one launch of csrc/rope2d.cu for
CUDA tensors (forward, and backward through `_Rope2D`), `apply_rope2d` on
each side for CPU tensors; there is no other path. The kernel rounds as the
plain version's separate ops do, so both give the same bits.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from ..utils import cuda_build


def _inv_freq(f: int, base: float, device) -> Tensor:
    """The f/2 inverse frequencies of a 1D RoPE over f channels, (f/2,) f32."""
    exponent = torch.arange(0, f, 2, dtype=torch.float32, device=device) / f
    return 1.0 / (base**exponent)


def _rope1d(tokens: Tensor, pos: Tensor, base: float) -> Tensor:
    """1D RoPE over (..., n, h, f) tokens with integer positions (..., n)."""
    f = tokens.shape[-1]
    half = f // 2
    angles = pos.to(torch.float32)[..., None] * _inv_freq(f, base, tokens.device)  # (..., n, f/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cat([cos, cos], dim=-1).to(tokens.dtype)
    sin = torch.cat([sin, sin], dim=-1).to(tokens.dtype)
    x1, x2 = tokens[..., :half], tokens[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return tokens * cos + rotated * sin


def apply_rope2d(tokens: Tensor, positions: Tensor, base: float = 100.0) -> Tensor:
    """Rotate (..., n, heads, d) q/k tokens by their (..., n, 2) integer
    (y, x) grid positions; d % 4 == 0."""
    d = tokens.shape[-1]
    y_out = _rope1d(tokens[..., : d // 2], positions[..., 0], base)
    x_out = _rope1d(tokens[..., d // 2 :], positions[..., 1], base)
    return torch.cat([y_out, x_out], dim=-1)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_tables: Dict[tuple, Tensor] = {}  # (d, base, device) -> inv_freq on the device
_NO_SIDE = (None, 0, 0, None, 0, 0, None, 0)  # the kernel's second side, when there is none


def _heads_contiguous(shape, strides) -> bool:
    return strides[3] == 1 and (strides[2] == shape[3] or shape[2] == 1)


def _check(x: Tensor, pos: Tensor, like: Tensor) -> None:
    """Raises unless the kernel takes (x, pos): x (b, n, heads, d) float32 or
    bfloat16 with each token's (heads, d) contiguous, d % 4 == 0, and the
    dtype, device, b, heads and d of `like`; pos int32 (b, n, 2) with its
    last dim contiguous, on x's device. Runs on every call, so it keeps to
    plain comparisons: the host's time is what the kernel saves."""
    shape, like_shape, strides = x.shape, like.shape, x.stride()
    if (len(shape) != 4 or shape[3] % 4 or shape[0] != like_shape[0] or shape[2:] != like_shape[2:]
            or x.dtype is not like.dtype or x.dtype not in _DTYPES or not _heads_contiguous(shape, strides)):
        raise ValueError(f"rope2d: tokens must be float32 or bfloat16 (b, n, heads, d), d % 4 == 0, "
                         f"each token's (heads, d) contiguous, with the dtype, b, heads and d of {like.dtype} "
                         f"{tuple(like_shape)}; got {x.dtype} {tuple(shape)} strides {strides}")
    device = x.device
    if (device != like.device or pos.device != device or pos.dtype is not torch.int32
            or pos.shape != (shape[0], shape[1], 2) or pos.stride(2) != 1):
        raise ValueError(f"rope2d: positions must be int32 ({shape[0]}, {shape[1]}, 2) with the last dim "
                         f"contiguous, on the tokens' device {device} (and {like.device}); got {pos.dtype} "
                         f"{tuple(pos.shape)} strides {pos.stride()} on {pos.device}")


def _launch(base: float, inverse: bool, x: Tensor, pos: Tensor,
            y: Optional[Tensor] = None, ypos: Optional[Tensor] = None) -> Tuple[Tensor, Optional[Tensor]]:
    """One kernel launch over (x, pos) and, if given, (y, ypos); returns the
    rotated (by -angle with `inverse`) contiguous tensors."""
    b, n, heads, d = x.shape
    dev = x.device
    key = (d, base, dev)
    table = _tables.get(key)
    if table is None:
        table = _tables[key] = _inv_freq(d // 2, base, dev)
    out = x.new_empty(x.shape)
    side_a = (x.data_ptr(), x.stride(0), x.stride(1), pos.data_ptr(), pos.stride(0), pos.stride(1),
              out.data_ptr(), n)
    if y is None:
        out_y, side_b = None, _NO_SIDE
    else:
        out_y = y.new_empty(y.shape)
        side_b = (y.data_ptr(), y.stride(0), y.stride(1), ypos.data_ptr(), ypos.stride(0), ypos.stride(1),
                  out_y.data_ptr(), y.shape[1])
    cuda_build.launch("rope2d", dev, _DTYPES[x.dtype], b, heads, d, int(inverse), table.data_ptr(),
                      *side_a, *side_b)
    return out, out_y


class _Rope2D(torch.autograd.Function):
    """The kernel on (x, pos) and optionally (y, ypos); its gradient is the
    kernel again with the angle negated (the inverse rotation), which rounds
    as autograd through apply_rope2d does. Saves only the positions."""

    @staticmethod
    def forward(ctx, base, x, pos, y, ypos):
        ctx.base = base
        ctx.save_for_backward(pos, ypos)
        return _launch(base, False, x, pos, y, ypos)

    @staticmethod
    def backward(ctx, gx, gy):
        pos, ypos = ctx.saved_tensors
        want_x, want_y = ctx.needs_input_grad[1], ctx.needs_input_grad[3]
        sides = [(g if _heads_contiguous(g.shape, g.stride()) else g.contiguous(), p)
                 for g, p, want in ((gx, pos, want_x), (gy, ypos, want_y)) if want]
        if not sides:
            return None, None, None, None, None
        grads = list(_launch(ctx.base, True, *sides[0], *(sides[1] if len(sides) > 1 else ())))
        dx = grads.pop(0) if want_x else None
        dy = grads[0] if want_y else None
        return None, dx, None, dy, None


def _rotate(base: float, x: Tensor, pos: Tensor, y: Optional[Tensor] = None,
            ypos: Optional[Tensor] = None) -> Tuple[Tensor, Optional[Tensor]]:
    _check(x, pos, x)
    if y is not None:
        _check(y, ypos, x)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"rope2d: unsupported device {x.device}")
        return apply_rope2d(x, pos, base), None if y is None else apply_rope2d(y, ypos, base)
    if torch.is_grad_enabled() and (x.requires_grad or (y is not None and y.requires_grad)):
        return _Rope2D.apply(base, x, pos, y, ypos)
    return _launch(base, False, x, pos, y, ypos)


def rope2d_qk(q: Tensor, qpos: Optional[Tensor], k: Tensor, kpos: Optional[Tensor],
              base: float = 100.0) -> Tuple[Tensor, Tensor]:
    """q (b, nq, heads, d) rotated by qpos (b, nq, 2) and k (b, nk, heads, d)
    by kpos (b, nk, 2), int32 (y, x) grid positions; a side whose positions
    are None is returned as it is. CUDA tensors take one kernel launch for
    both sides; CPU tensors take apply_rope2d. Raises on what the kernel does
    not take (`_check`), on the CPU too."""
    if qpos is None or kpos is None:
        if qpos is None and kpos is None:
            return q, k
        if kpos is None:
            return _rotate(base, q, qpos)[0], k
        return q, _rotate(base, k, kpos)[0]
    return _rotate(base, q, qpos, k, kpos)
