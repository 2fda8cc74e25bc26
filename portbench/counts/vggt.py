"""The FLOPs of a VGGT forward (a multiply-add counts 2), counted from the
configuration's widths and the request's shape, and its attention calls.
Elementwise work, norms, softmax and the activations are not counted.

`forward_flops` gives each part: the DINOv2 patch embedding, the frame and
global blocks (each split into linears and attention), the camera head and
the two DPT heads. `attention_calls` lists every SDPA call of a forward as
(batch, tokens, heads, head_dim), and `attention_flops` counts one such
call: 4 * batch * heads * tokens^2 * head_dim (q k^T and the weighted sum
of v)."""

from __future__ import annotations

from typing import Dict, List, Tuple


def _down(n: int) -> int:
    """A 3x3 stride-2 convolution's output size with padding 1."""
    return (n - 1) // 2 + 1


def attention_flops(call: Tuple[int, int, int, int]) -> float:
    b, n, heads, d = call
    return 4.0 * b * heads * n * n * d


def attention_calls(w: dict, b: int, s: int, h: int, width: int) -> List[Tuple[int, int, int, int]]:
    """Every attention of a forward: the DINOv2 trunk's and the frame
    blocks' over each frame, the global blocks' over each scene, the camera
    trunk's over each scene's camera tokens."""
    dim, heads = w["embed_dim"], w["num_heads"]
    patches = (h // w["patch_size"]) * (width // w["patch_size"])
    per_frame = 1 + w["num_register_tokens"] + patches  # DINOv2: class + registers; VGGT: camera + registers
    d = dim // heads
    calls = [(b * s, per_frame, heads, d)] * w["patch_embed_depth"]
    for _ in range(w["depth"]):
        calls += [(b * s, per_frame, heads, d), (b, s * per_frame, heads, d)]
    calls += [(b, s, heads, 2 * dim // heads)] * (w["camera_trunk_depth"] * w["camera_iterations"])
    return calls


def _block_linears(tokens: int, dim: int, mlp_ratio: float) -> float:
    """qkv, proj, fc1 and fc2 of one block over `tokens` tokens."""
    return 2.0 * tokens * (4 * dim * dim + 2 * dim * int(dim * mlp_ratio))


def dpt_head_flops(w: dict, frames: int, h: int, width: int, out_dim: int) -> float:
    """One DPT head over `frames` frames of h x width."""
    p, f = w["patch_size"], w["head_features"]
    oc = w["head_out_channels"]
    ph, pw = h // p, width // p
    c_in = 2 * w["embed_dim"]
    px = ph * pw
    total = sum(2.0 * px * c_in * c for c in oc)  # the 1x1 projections
    total += 2.0 * px * oc[0] * oc[0] * 16 + 2.0 * px * oc[1] * oc[1] * 4  # the transposed convs
    h4, w4 = _down(ph), _down(pw)
    total += 2.0 * h4 * w4 * oc[3] * oc[3] * 9  # the stride-2 conv
    sizes = [(4 * ph, 4 * pw), (2 * ph, 2 * pw), (ph, pw), (h4, w4)]
    total += sum(2.0 * a * bb * c * f * 9 for (a, bb), c in zip(sizes, oc))  # layer*_rn
    unit = lambda a, bb: 2 * 2.0 * a * bb * f * f * 9  # noqa: E731  a residual unit: two 3x3 convs
    # refinenet4 (one unit at layer 4's size, out_conv at layer 3's), 3, 2 and 1
    # (two units each), the last out_conv at twice layer 1's size.
    total += unit(*sizes[3]) + 2.0 * sizes[2][0] * sizes[2][1] * f * f
    total += 2 * unit(*sizes[2]) + 2.0 * sizes[1][0] * sizes[1][1] * f * f
    total += 2 * unit(*sizes[1]) + 2.0 * sizes[0][0] * sizes[0][1] * f * f
    total += 2 * unit(*sizes[0]) + 2.0 * (2 * sizes[0][0]) * (2 * sizes[0][1]) * f * f
    total += 2.0 * (8 * ph) * (8 * pw) * f * (f // 2) * 9  # output_conv1
    full = (ph * p) * (pw * p)
    total += 2.0 * full * (f // 2) * 32 * 9 + 2.0 * full * 32 * out_dim  # output_conv2
    return frames * total


def forward_flops(w: dict, b: int, s: int, h: int, width: int) -> Dict[str, float]:
    """FLOPs of one forward of b scenes of s frames at h x width, by part,
    and their `total`."""
    dim, ratio = w["embed_dim"], w["mlp_ratio"]
    p = w["patch_size"]
    patches = (h // p) * (width // p)
    per_frame = 1 + w["num_register_tokens"] + patches
    frames = b * s
    calls = attention_calls(w, b, s, h, width)
    n_dino, n_agg = w["patch_embed_depth"], 2 * w["depth"]
    attn = [attention_flops(c) for c in calls]
    out = {
        "patch_embed": 2.0 * frames * patches * dim * 3 * p * p
        + n_dino * _block_linears(frames * per_frame, dim, ratio) + sum(attn[:n_dino]),
        "frame_blocks": w["depth"] * _block_linears(frames * per_frame, dim, ratio)
        + sum(attn[n_dino:n_dino + n_agg:2]),
        "global_blocks": w["depth"] * _block_linears(frames * per_frame, dim, ratio)
        + sum(attn[n_dino + 1:n_dino + n_agg:2]),
    }
    c2 = 2 * dim
    camera_iter = (2.0 * frames * 9 * c2 + 2.0 * frames * c2 * 3 * c2
                   + w["camera_trunk_depth"] * _block_linears(frames, c2, ratio)
                   + 2.0 * frames * (c2 * (c2 // 2) + (c2 // 2) * 9))
    out["camera_head"] = w["camera_iterations"] * camera_iter + sum(attn[n_dino + n_agg:])
    out["heads"] = dpt_head_flops(w, frames, h, width, 2) + dpt_head_flops(w, frames, h, width, 4)
    out["attention"] = sum(attn)
    out["total"] = sum(out[k] for k in ("patch_embed", "frame_blocks", "global_blocks", "camera_head", "heads"))
    return out
