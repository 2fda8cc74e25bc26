"""Analytic FLOP counts (frozen copy of styl3r_tpu_torch/utils/flops.py,
the port's copy of styl3r_tpu/utils/flops.py), with the counts the
benchmark adds: the MASt3R teacher's forward, the student's stage-0
forward (the encoder to its point maps), and training steps.

Matmul/conv multiply-adds count as 2 FLOPs each; elementwise work, norms
and softmax are excluded, the bilinear resizes are counted as the two small
matmuls the JAX package runs them as. The rasterizer terms are estimates so
the total does not silently miss a stage (< 3% of it).

A training step counts each module's forward FLOPs, plus twice its forward
FLOPs for each module the backward passes through (the gradients of its
input and of its weights). A frozen module run without gradients (the
teacher) counts its forward alone.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM dense bf16 tensor-core peak (data sheet, 700 W).
H100_BF16_PEAK_TFLOPS = 989.0


def dense(n: int, d_in: int, d_out: int) -> int:
    return 2 * n * d_in * d_out


def conv2d(h: int, w: int, cin: int, cout: int, k: int, stride: int = 1) -> int:
    return 2 * (h // stride) * (w // stride) * cin * cout * k * k


def resize_ac(h_in: int, w_in: int, h_out: int, w_out: int, c: int) -> int:
    return 2 * h_out * h_in * w_in * c + 2 * w_out * w_in * h_out * c


def attention(nq: int, nk: int, d: int) -> int:
    """q@k^T + attn@v over all heads."""
    return 2 * nq * nk * d + 2 * nq * nk * d


def block(n: int, d: int, mlp_ratio: int = 4) -> int:
    """vit.Block: qkv + attention + proj + mlp."""
    return (
        dense(n, d, 3 * d)
        + attention(n, n, d)
        + dense(n, d, d)
        + dense(n, d, mlp_ratio * d)
        + dense(n, mlp_ratio * d, d)
    )


def decoder_block(nq: int, nk: int, d: int, mlp_ratio: int = 4) -> int:
    """vit.DecoderBlock: self-attn + cross-attn over memory nk + mlp."""
    self_attn = dense(nq, d, 3 * d) + attention(nq, nq, d) + dense(nq, d, d)
    cross = dense(nq, d, d) + 2 * dense(nk, d, d) + attention(nq, nk, d) + dense(nq, d, d)
    return self_attn + cross + dense(nq, d, mlp_ratio * d) + dense(nq, mlp_ratio * d, d)


def patch_embed(h: int, w: int, dim: int, patch: int = 16) -> int:
    return 2 * h * w * 3 * dim


def vit_encoder(h: int, w: int, dim: int, depth: int, patch: int = 16,
                extra_tokens: int = 0) -> int:
    """CrocoVitEncoder on one image (+ optional intrinsics token)."""
    n = (h // patch) * (w // patch) + extra_tokens
    return patch_embed(h, w, dim, patch) + depth * block(n, dim)


def dpt_trunk(h: int, w: int, hook_dims: Tuple[int, int, int, int] = (1024, 768, 768, 768),
              layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768),
              feature_dim: int = 256, patch: int = 16) -> int:
    """DPTTrunk on one image's token pyramid."""
    nh, nw = h // patch, w // patch
    a = nh * nw
    f = feature_dim
    ld = layer_dims
    total = 0
    total += dense(a, hook_dims[0], ld[0]) + dense(a, ld[0], ld[0] * 16)
    total += dense(a, hook_dims[1], ld[1]) + dense(a, ld[1], ld[1] * 4)
    total += dense(a, hook_dims[2], ld[2])
    total += dense(a, hook_dims[3], ld[3]) + conv2d(nh, nw, ld[3], ld[3], 3, stride=2)
    total += conv2d(4 * nh, 4 * nw, ld[0], f, 3)
    total += conv2d(2 * nh, 2 * nw, ld[1], f, 3)
    total += conv2d(nh, nw, ld[2], f, 3)
    total += conv2d(nh // 2, nw // 2, ld[3], f, 3)
    total += 2 * conv2d(nh // 2, nw // 2, f, f, 3)
    total += resize_ac(nh // 2, nw // 2, nh, nw, f) + conv2d(nh, nw, f, f, 1)
    for r_h, r_w in ((nh, nw), (2 * nh, 2 * nw), (4 * nh, 4 * nw)):
        total += 4 * conv2d(r_h, r_w, f, f, 3)
        total += resize_ac(r_h, r_w, 2 * r_h, 2 * r_w, f)
        total += conv2d(2 * r_h, 2 * r_w, f, f, 1)
    return total


def dpt_pts3d_head(h: int, w: int, hook_dims=(1024, 768, 768, 768),
                   feature_dim: int = 256, last_dim: int = 128,
                   with_conf: bool = False) -> int:
    f = feature_dim
    out_ch = 4 if with_conf else 3
    return (
        dpt_trunk(h, w, hook_dims, feature_dim=f)
        + conv2d(h // 2, w // 2, f, f // 2, 3)
        + resize_ac(h // 2, w // 2, h, w, f // 2)
        + conv2d(h, w, f // 2, last_dim, 3)
        + conv2d(h, w, last_dim, out_ch, 1)
    )


def _gs_tower(h: int, w: int, feature_dim: int, out_channels: int) -> int:
    return conv2d(h, w, feature_dim, feature_dim, 3) + conv2d(h, w, feature_dim, out_channels, 1)


def dpt_gs_head(h: int, w: int, out_channels: int, hook_dims=(1024, 768, 768, 768),
                feature_dim: int = 256) -> int:
    f = feature_dim
    return (
        dpt_trunk(h, w, hook_dims, feature_dim=f)
        + conv2d(h, w, 3, f, 7)
        + resize_ac(h // 2, w // 2, h, w, f)
        + _gs_tower(h, w, f, out_channels)
    )


def dpt_gs_sh_head(h: int, w: int, out_channels: int, hook_dims=(1024, 768, 768, 768),
                   feature_dim: int = 256) -> int:
    f = feature_dim
    return (
        dpt_trunk(h, w, hook_dims, feature_dim=f)
        + resize_ac(h // 2, w // 2, h, w, f)
        + _gs_tower(h, w, f, out_channels)
    )


PROJ_FLOPS_PER_GAUSSIAN = 300  # EWA projection + conic + culling math
COMPOSITE_FLOPS_PER_PAIR_PIXEL = 30  # power eval + alpha blend per pixel


def render_flops(n_views: int, g_per_view: int, pair_slots: int,
                 tile_pixels: int = 256) -> int:
    return (
        n_views * g_per_view * PROJ_FLOPS_PER_GAUSSIAN
        + pair_slots * tile_pixels * COMPOSITE_FLOPS_PER_PAIR_PIXEL
    )


def styl3r_forward_flops(
    b: int = 1,
    v: int = 2,
    h: int = 256,
    w: int = 256,
    style_hw: int = 256,
    n_targets: int = 1,
    *,
    enc_depth: int = 24,
    dec_depth: int = 12,
    enc_dim: int = 1024,
    dec_dim: int = 768,
    sh_degree: int = 0,
    pair_cap_per_gaussian: int = 4,
    patch: int = 16,
) -> Dict[str, float]:
    """FLOPs of Styl3rModel.forward (predict_gaussians + render) by stage."""
    a = (h // patch) * (w // patch)
    l = a + 1  # + intrinsics token
    d_sh_ = (sh_degree + 1) ** 2
    hook_dims = (enc_dim, dec_dim, dec_dim, dec_dim)

    content_enc = b * v * vit_encoder(h, w, enc_dim, enc_depth, patch, extra_tokens=1)
    backbone_dec = (
        dense(b * v * l, enc_dim, dec_dim)
        + dec_depth * b * v * decoder_block(l, (v - 1) * l, dec_dim)
    )
    ls = (style_hw // patch) ** 2
    stylizer = (
        b * vit_encoder(style_hw, style_hw, enc_dim, enc_depth, patch)
        + dense(b * (v * l + ls), enc_dim, dec_dim)
        + dec_depth * b * decoder_block(v * l, ls, dec_dim)
    )
    structure_channels = 1 + 7
    heads = b * v * (
        dpt_pts3d_head(h, w, hook_dims)
        + dpt_gs_head(h, w, structure_channels, hook_dims)
        + dpt_gs_sh_head(h, w, 3 * d_sh_, hook_dims)
    )
    g = v * h * w
    render = b * render_flops(n_targets, g, pair_cap_per_gaussian * n_targets * g)
    total = content_enc + backbone_dec + stylizer + heads + render
    return {
        "content_encoder": float(content_enc),
        "backbone_decoder": float(backbone_dec),
        "token_stylizer": float(stylizer),
        "dpt_heads": float(heads),
        "render_estimate": float(render),
        "total": float(total),
    }


def mfu(total_flops: float, seconds: float,
        peak_tflops: float = H100_BF16_PEAK_TFLOPS) -> Dict[str, float]:
    """Achieved TFLOP/s and fraction of `peak_tflops` for a measured time."""
    achieved = total_flops / max(seconds, 1e-12) / 1e12
    return {"tflops": achieved, "peak_tflops": peak_tflops, "mfu": achieved / peak_tflops}


WIDTH_KEYS = ("enc_depth", "dec_depth", "enc_dim", "dec_dim")


def dims(widths: Dict[str, object]) -> Dict[str, int]:
    """The widths the counts read, from a configuration's `widths`."""
    return {k: int(widths[k]) for k in WIDTH_KEYS if k in widths}


def teacher_forward_flops(b: int, h: int, w: int, *, enc_depth: int = 24, dec_depth: int = 12,
                          enc_dim: int = 1024, dec_dim: int = 768, patch: int = 16) -> float:
    """The two-view MASt3R/DUSt3R teacher: each view's encoder (no
    intrinsics token), both decoders over the other view's tokens, and a
    conf DPT pts3d head a view."""
    a = (h // patch) * (w // patch)
    hook_dims = (enc_dim, dec_dim, dec_dim, dec_dim)
    enc = 2 * b * vit_encoder(h, w, enc_dim, enc_depth, patch)
    dec = dense(2 * b * a, enc_dim, dec_dim) + dec_depth * 2 * b * decoder_block(a, a, dec_dim)
    heads = 2 * b * dpt_pts3d_head(h, w, hook_dims, with_conf=True)
    return float(enc + dec + heads)


def student_points_flops(b: int, v: int, h: int, w: int, *, enc_depth: int = 24, dec_depth: int = 12,
                         enc_dim: int = 1024, dec_dim: int = 768, patch: int = 16) -> float:
    """Styl3rModel.predict_gaussians with distill_only: the content
    encoder, the backbone's decoders and the pts3d heads; no stylizer, no
    Gaussian heads, no render."""
    a = (h // patch) * (w // patch)
    l = a + 1  # + intrinsics token
    hook_dims = (enc_dim, dec_dim, dec_dim, dec_dim)
    enc = b * v * vit_encoder(h, w, enc_dim, enc_depth, patch, extra_tokens=1)
    dec = dense(b * v * l, enc_dim, dec_dim) + dec_depth * b * v * decoder_block(l, (v - 1) * l, dec_dim)
    heads = b * v * dpt_pts3d_head(h, w, hook_dims)
    return float(enc + dec + heads)


def distill_step_flops(b: int, v: int, h: int, w: int, student: Dict[str, int], teacher: Dict[str, int]) -> float:
    """A stage-0 step: the student's point maps forward and backward (3x
    forward), the frozen teacher's forward on the first two views."""
    return 3.0 * student_points_flops(b, v, h, w, **student) + teacher_forward_flops(b, h, w, **teacher)


# VGG19 convs up to relu4_1 (losses/vgg.py): (downsampling, in, out) a conv.
VGG19_CONVS = ((1, 3, 64), (1, 64, 64), (2, 64, 128), (2, 128, 128), (4, 128, 256), (4, 256, 256),
               (4, 256, 256), (4, 256, 256), (8, 256, 512))


def vgg19_features_flops(n: int, h: int, w: int) -> float:
    """The style losses' VGG19 feature slices on n images of h x w."""
    return float(n * sum(conv2d(h // s, w // s, cin, cout, 3) for s, cin, cout in VGG19_CONVS))


def style_step_flops(b: int, v: int, h: int, w: int, n_targets: int, widths: Dict[str, int],
                     identity: bool = True, sh_degree: int = 0) -> float:
    """A stage-2 step (stylizer-only training): the forward (twice with the
    identity branch), the VGG19 passes of the style loss (renders, targets
    and the style image) and of the identity loss (renders, targets), and
    the backward through what it passes: the token stylizer and the
    appearance head of each forward, and the VGG19 passes of the renders.
    The frozen backbone and structure heads take no backward."""
    fwd = styl3r_forward_flops(b, v, h, w, style_hw=h, n_targets=n_targets, pair_cap_per_gaussian=0,
                               sh_degree=sh_degree, **widths)
    d_sh_ = (sh_degree + 1) ** 2
    dec_dim, enc_dim = widths.get("dec_dim", 768), widths.get("enc_dim", 1024)
    appearance = b * v * dpt_gs_sh_head(h, w, 3 * d_sh_, (enc_dim, dec_dim, dec_dim, dec_dim))
    forwards = 2 if identity else 1
    renders = b * n_targets
    vgg = vgg19_features_flops(3 * renders + (2 * renders if identity else 0), h, w)
    backward = forwards * 2 * (fwd["token_stylizer"] + appearance) + 2 * vgg19_features_flops(forwards * renders, h, w)
    return float(forwards * fwd["total"] + vgg + backward)
