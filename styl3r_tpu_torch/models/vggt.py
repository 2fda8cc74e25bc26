"""VGGT, the Visual Geometry Grounded Transformer (Wang et al., CVPR 2025,
arXiv:2503.11651; github.com/facebookresearch/vggt, VGGT-1B): from S unposed
views of a scene, one forward pass predicts every view's camera (a pose
encoding), its depth map with a confidence and its world-point map with a
confidence.

- Patch embedding: a DINOv2 ViT-L/14 with 4 register tokens (LayerScale,
  LayerNorm eps 1e-6, a learned 37x37 position embedding interpolated
  bicubic with antialias to the input's patch grid); its final norm's patch
  tokens feed the aggregator. Images are normalised by the ImageNet mean and
  std first.
- Aggregator: frame blocks alternating with global blocks, one of each a
  layer (VGGT's `aa_order` frame, global and `aa_block_size` 1). Each block
  has QK-norm (before RoPE), LayerScale and RoPE2D at frequency 100, with
  PyTorch's default LayerNorm eps. Every frame gets a camera token and 4
  register tokens before its patches: frame 0 takes the parameters at index
  0, the others those at index 1. Patches sit at (y + 1, x + 1), the special
  tokens at (0, 0). A frame block attends within one frame's tokens, a global
  block over all of the scene's. The heads read layer i as [frame_i,
  global_i], 2 * dim channels.
- Camera head: the last layer's camera tokens, a trunk of 4 blocks at 2 * dim
  refined 4 times through an adaLN modulation by the previous pose encoding
  (absT_quaR_FoV: translation 3, quaternion xyzw 4, field of view 2 through
  a ReLU).
- Depth and point heads: VGGT's DPT heads over layers (4, 11, 17, 23), with
  a UV sinusoidal embedding, frames in chunks of 8; depth `exp` and point
  `inv_log` activations, confidences `expp1`.

VGGT's tracking head is left out: its forward skips it unless query points
are given. Module and parameter names are VGGT's, so a released `model.pt`
loads by key name (its `track_head.` keys are ignored,
utils/checkpoint.py::load_checkpoint).

Precision, as VGGT's inference runs it: the aggregator under autocast in
`compute_dtype` (bf16 on the card) over float32 weights, so the residual
stream, the norms and QK-norm's outputs (which RoPE rotates) are float32
while the linears and SDPA take bf16; the heads with autocast off, in
float32. The aggregator's and the DINOv2 trunk's attentions take SDPA's
fused backends only (ops/attention.py), so a fallback raises instead of
allocating the scores.

Spans (utils/trace.py): `patch_embed`, `frame_blocks` and `global_blocks`
(one entry a block), `camera_head`, `heads` (depth and point heads), and
`rope` inside each of the 2 * depth RoPE attentions.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from ..utils import trace
from .dpt import FeatureFusionBlock
from .precision import compute_in
from .vit import Block, LayerScale, Mlp

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
POSE_DIM = 9  # absT_quaR_FoV

# VGGT-1B's published widths.
VGGT_1B = dict(
    img_size=518, patch_size=14, embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4.0, num_register_tokens=4,
    patch_embed_depth=24, camera_trunk_depth=4, camera_iterations=4, head_features=256,
    head_out_channels=(256, 512, 1024, 1024), head_layers=(4, 11, 17, 23), frames_chunk_size=8,
    rope_freq=100.0, init_values=0.01, patch_embed_init_values=1.0,
)


class PatchEmbed(nn.Module):
    """p x p conv patchifier over NCHW images -> (n, h/p * w/p, dim)."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: Tensor) -> Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class DinoVisionTransformer(nn.Module):
    """DINOv2 with register tokens, as VGGT builds it for its patch
    embedding; forward returns the final norm's patch tokens
    (`x_norm_patchtokens`)."""

    def __init__(self, img_size: int, patch_size: int, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float, num_register_tokens: int, init_values: float):
        super().__init__()
        self.patch_size = patch_size
        self.num_register_tokens = num_register_tokens
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, embed_dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))  # training only; kept for the keys
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, init_values=init_values, eps=1e-6)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def interpolate_pos_encoding(self, x: Tensor, h: int, w: int) -> Tensor:
        """The position embedding for an h x w image: the learned grid,
        bicubic with antialias (interpolate_offset 0) to h/p x w/p."""
        n_patches, n_grid = x.shape[1] - 1, self.pos_embed.shape[1] - 1
        if n_patches == n_grid and h == w:
            return self.pos_embed
        pos = self.pos_embed.float()
        dim = x.shape[-1]
        m = int(math.sqrt(n_grid))
        patch = F.interpolate(pos[:, 1:].reshape(1, m, m, dim).permute(0, 3, 1, 2),
                              size=(h // self.patch_size, w // self.patch_size), mode="bicubic", antialias=True)
        patch = patch.permute(0, 2, 3, 1).reshape(1, -1, dim)
        return torch.cat([pos[:, :1], patch], dim=1).to(x.dtype)

    def forward(self, images: Tensor) -> Tensor:
        n, _, h, w = images.shape
        x = self.patch_embed(images)
        x = torch.cat([self.cls_token.expand(n, -1, -1), x], dim=1)
        x = x + self.interpolate_pos_encoding(x, h, w)
        x = torch.cat([x[:, :1], self.register_tokens.expand(n, -1, -1), x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, self.num_register_tokens + 1:]


def slice_expand_and_flatten(tokens: Tensor, b: int, s: int) -> Tensor:
    """(1, 2, k, c) special tokens -> (b * s, k, c): frame 0 of each scene
    takes index 0, every other frame index 1."""
    first = tokens[:, :1].expand(b, 1, *tokens.shape[2:])
    others = tokens[:, 1:].expand(b, s - 1, *tokens.shape[2:])
    return torch.cat([first, others], dim=1).reshape(b * s, *tokens.shape[2:])


def token_positions(b: int, s: int, gh: int, gw: int, n_special: int, device) -> Tensor:
    """int32 (b * s, n_special + gh * gw, 2) (y, x) positions of a frame's
    tokens: the special tokens at (0, 0), patch (y, x) at (y + 1, x + 1)."""
    ys = torch.arange(1, gh + 1, dtype=torch.int32, device=device)
    xs = torch.arange(1, gw + 1, dtype=torch.int32, device=device)
    grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1).reshape(gh * gw, 2)
    pos = torch.cat([torch.zeros(n_special, 2, dtype=torch.int32, device=device), grid], dim=0)
    return pos[None].expand(b * s, -1, -1).contiguous()


class Aggregator(nn.Module):
    """The DINOv2 patch embedding, then frame and global blocks alternating."""

    def __init__(self, img_size: int, patch_size: int, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float, num_register_tokens: int, patch_embed_depth: int, rope_freq: float,
                 init_values: float, patch_embed_init_values: float):
        super().__init__()
        self.patch_size = patch_size
        self.patch_embed = DinoVisionTransformer(img_size, patch_size, embed_dim, patch_embed_depth, num_heads,
                                                 mlp_ratio, num_register_tokens, patch_embed_init_values)

        def blocks():
            return nn.ModuleList(
                Block(embed_dim, num_heads, mlp_ratio, rope_base=rope_freq, qk_norm=True, init_values=init_values,
                      eps=1e-5) for _ in range(depth))

        self.frame_blocks = blocks()
        self.global_blocks = blocks()
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, embed_dim))
        self.register_token = nn.Parameter(torch.zeros(1, 2, num_register_tokens, embed_dim))
        self.patch_start_idx = 1 + num_register_tokens
        self.register_buffer("_resnet_mean", torch.tensor(IMAGENET_MEAN).view(1, 1, 3, 1, 1), persistent=False)
        self.register_buffer("_resnet_std", torch.tensor(IMAGENET_STD).view(1, 1, 3, 1, 1), persistent=False)

    def forward(self, images: Tensor, keep: Sequence[int]) -> List[Optional[Tensor]]:
        """images (b, s, 3, h, w) in [0, 1] -> the layers' outputs (b, s, p,
        2 * dim), [frame_i, global_i]; only the layers in `keep` are
        returned, the others are None."""
        b, s, _, h, w = images.shape
        images = (images - self._resnet_mean) / self._resnet_std
        with trace.span("patch_embed"):
            patches = self.patch_embed(images.reshape(b * s, 3, h, w))
        tokens = torch.cat([slice_expand_and_flatten(self.camera_token, b, s),
                            slice_expand_and_flatten(self.register_token, b, s), patches], dim=1)
        p, c = tokens.shape[1:]
        pos = token_positions(b, s, h // self.patch_size, w // self.patch_size, self.patch_start_idx,
                              images.device)
        pos_global = pos.view(b, s * p, 2)
        keep = set(keep)
        out: List[Optional[Tensor]] = [None] * len(self.frame_blocks)
        for i, (frame, glob) in enumerate(zip(self.frame_blocks, self.global_blocks)):
            with trace.span("frame_blocks"):
                tokens = frame(tokens.view(b * s, p, c), pos)
            frame_out = tokens.view(b, s, p, c)
            with trace.span("global_blocks"):
                tokens = glob(tokens.view(b, s * p, c), pos_global)
            if i in keep:
                out[i] = torch.cat([frame_out, tokens.view(b, s, p, c)], dim=-1)
        return out


def activate_pose(enc: Tensor) -> Tensor:
    """absT_quaR_FoV: translation and quaternion linear, FoV through ReLU."""
    return torch.cat([enc[..., :7], F.relu(enc[..., 7:])], dim=-1)


class CameraHead(nn.Module):
    """VGGT's camera head: the camera tokens refined `iterations` times."""

    def __init__(self, dim_in: int, trunk_depth: int, num_heads: int, mlp_ratio: float, init_values: float,
                 iterations: int):
        super().__init__()
        self.iterations = iterations
        self.trunk = nn.Sequential(*[Block(dim_in, num_heads, mlp_ratio, init_values=init_values, eps=1e-5)
                                     for _ in range(trunk_depth)])
        self.token_norm = nn.LayerNorm(dim_in)
        self.trunk_norm = nn.LayerNorm(dim_in)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, POSE_DIM))
        self.embed_pose = nn.Linear(POSE_DIM, dim_in)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim_in, 3 * dim_in))
        self.adaln_norm = nn.LayerNorm(dim_in, elementwise_affine=False, eps=1e-6)
        self.pose_branch = Mlp(dim_in, dim_in // 2, POSE_DIM)

    def forward(self, last_layer: Tensor) -> List[Tensor]:
        """last_layer (b, s, p, dim_in) -> the activated pose encoding (b, s,
        9) of each refinement."""
        tokens = self.token_norm(last_layer[:, :, 0])
        b, s, _ = tokens.shape
        enc, out = None, []
        for _ in range(self.iterations):
            cond = self.embed_pose(self.empty_pose_tokens.expand(b, s, -1) if enc is None else enc.detach())
            shift, scale, gate = self.poseLN_modulation(cond).chunk(3, dim=-1)
            x = gate * (self.adaln_norm(tokens) * (1 + scale) + shift) + tokens
            delta = self.pose_branch(self.trunk_norm(self.trunk(x)))
            enc = delta if enc is None else enc + delta
            out.append(activate_pose(enc))
        return out


_UV_CACHE: Dict[tuple, Tensor] = {}


def uv_embedding(width: int, height: int, aspect_ratio: float, channels: int, dtype, device) -> Tensor:
    """VGGT's UV position embedding of a width x height grid, (channels,
    height, width): a centred UV grid spanning the image's diagonal, each
    coordinate's sin and cos at frequencies 1 / 100**(2f / (channels/2)),
    computed in float64 (as VGGT's einsum promotes it) and returned as
    float32 in `dtype`. Cached by its arguments."""
    key = (width, height, aspect_ratio, channels, dtype, device)
    emb = _UV_CACHE.get(key)
    if emb is not None:
        return emb
    diag = (aspect_ratio**2 + 1.0) ** 0.5
    span_x, span_y = aspect_ratio / diag, 1.0 / diag
    xs = torch.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, width, dtype=dtype,
                        device=device)
    ys = torch.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, height, dtype=dtype,
                        device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")  # (height, width)
    half = channels // 2
    omega = torch.arange(half // 2, dtype=torch.float64, device=device) / (half / 2.0)
    omega = 1.0 / 100.0**omega

    def sincos(coord):
        angles = coord.reshape(-1).double()[:, None] * omega
        return torch.cat([torch.sin(angles), torch.cos(angles)], dim=1).float()

    emb = torch.cat([sincos(uu), sincos(vv)], dim=-1).view(height, width, channels).permute(2, 0, 1).to(dtype)
    _UV_CACHE[key] = emb
    return emb


def activate_head(out: Tensor, activation: str) -> Tuple[Tensor, Tensor]:
    """(n, c, h, w) -> (values (n, h, w, c - 1), confidence (n, h, w)):
    `exp` or `inv_log` (sign(x) * (e^|x| - 1)) on the values, 1 + e^x on the
    confidence."""
    fmap = out.permute(0, 2, 3, 1)
    xyz, conf = fmap[..., :-1], fmap[..., -1]
    if activation == "exp":
        values = torch.exp(xyz)
    elif activation == "inv_log":
        values = torch.sign(xyz) * torch.expm1(torch.abs(xyz))
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return values, 1 + conf.exp()


class DPTHead(nn.Module):
    """VGGT's DPT head over the aggregator's layers `layers` (patch tokens
    only): token LayerNorm, 1x1 projections, the UV embedding, resizes (4x and
    2x transposed convs, identity, a 3x3 stride-2 conv), the DPT fusion
    blocks (models/dpt.py, with VGGT's rectified skips and sizes), output
    convs and the activation, frames `chunk` at a time."""

    def __init__(self, dim_in: int, patch_size: int, output_dim: int, activation: str, features: int,
                 out_channels: Sequence[int], layers: Sequence[int], chunk: int):
        super().__init__()
        self.patch_size, self.activation, self.layers, self.chunk = patch_size, activation, tuple(layers), chunk
        oc = out_channels
        self.norm = nn.LayerNorm(dim_in)
        self.projects = nn.ModuleList(nn.Conv2d(dim_in, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4), nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(), nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = nn.Module()
        for i, c in enumerate(oc):
            setattr(self.scratch, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}", FeatureFusionBlock(features, has_skip=i < 4, relu_skip=True))
        self.scratch.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.scratch.output_conv2 = nn.Sequential(nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
                                                  nn.Conv2d(32, output_dim, 1))

    def forward(self, layers: List[Optional[Tensor]], hw: Tuple[int, int], patch_start: int) -> Tuple[Tensor, Tensor]:
        s = next(x for x in layers if x is not None).shape[1]
        parts = [self._frames(layers, hw, patch_start, i, min(i + self.chunk, s)) for i in range(0, s, self.chunk)]
        return torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1)

    def _frames(self, layers, hw, patch_start: int, f0: int, f1: int) -> Tuple[Tensor, Tensor]:
        h, w = hw
        ph, pw = h // self.patch_size, w // self.patch_size
        feats = []
        for i, idx in enumerate(self.layers):
            x = layers[idx][:, f0:f1, patch_start:]
            b, s = x.shape[:2]
            x = self.norm(x.reshape(b * s, -1, x.shape[-1]))
            x = x.permute(0, 2, 1).reshape(b * s, -1, ph, pw)
            x = self.projects[i](x)
            x = x + 0.1 * uv_embedding(pw, ph, w / h, x.shape[1], x.dtype, x.device)
            feats.append(self.resize_layers[i](x))
        sc = self.scratch
        l1, l2, l3, l4 = sc.layer1_rn(feats[0]), sc.layer2_rn(feats[1]), sc.layer3_rn(feats[2]), sc.layer4_rn(feats[3])
        out = sc.refinenet4(l4, size=l3.shape[2:])
        out = sc.refinenet3(out, l3, size=l2.shape[2:])
        out = sc.refinenet2(out, l2, size=l1.shape[2:])
        out = sc.output_conv1(sc.refinenet1(out, l1))
        out = F.interpolate(out, size=(ph * self.patch_size, pw * self.patch_size), mode="bilinear",
                            align_corners=True)
        out = out + 0.1 * uv_embedding(out.shape[3], out.shape[2], w / h, out.shape[1], out.dtype, out.device)
        values, conf = activate_head(sc.output_conv2(out), self.activation)
        return values.view(b, s, *values.shape[1:]), conf.view(b, s, *conf.shape[1:])


class VGGT(nn.Module):
    """VGGT without its tracking head, at VGGT_1B's widths unless `widths`
    replace some of them. `compute_dtype` is the aggregator's autocast dtype
    (None: float32 throughout); the weights are float32, drawn from `seed`
    by `init_vggt_` unless `device` is "meta"."""

    # Keys of a released checkpoint that this model does not hold.
    IGNORED_KEY_PREFIXES = ("track_head.",)

    def __init__(self, compute_dtype: Optional[torch.dtype] = None, device=None, seed: int = 0, **widths):
        super().__init__()
        unknown = set(widths) - set(VGGT_1B)
        if unknown:
            raise TypeError(f"VGGT: unknown widths {sorted(unknown)}")
        w = dict(VGGT_1B, **widths)
        dim, heads, ratio, p = w["embed_dim"], w["num_heads"], w["mlp_ratio"], w["patch_size"]
        self.compute_dtype = compute_dtype
        with torch.device("meta"):
            self.aggregator = Aggregator(w["img_size"], p, dim, w["depth"], heads, ratio, w["num_register_tokens"],
                                         w["patch_embed_depth"], w["rope_freq"], w["init_values"],
                                         w["patch_embed_init_values"])
            self.camera_head = CameraHead(2 * dim, w["camera_trunk_depth"], heads, ratio, w["init_values"],
                                          w["camera_iterations"])
            head = dict(features=w["head_features"], out_channels=w["head_out_channels"], layers=w["head_layers"],
                        chunk=w["frames_chunk_size"])
            self.point_head = DPTHead(2 * dim, p, 4, "inv_log", **head)
            self.depth_head = DPTHead(2 * dim, p, 2, "exp", **head)
        self.keep = sorted(set(w["head_layers"]) | {w["depth"] - 1})
        device = torch.device("cpu" if device is None else device)
        if device.type != "meta":
            self.to_empty(device=device)
            self.aggregator._resnet_mean.copy_(torch.tensor(IMAGENET_MEAN).view(1, 1, 3, 1, 1))
            self.aggregator._resnet_std.copy_(torch.tensor(IMAGENET_STD).view(1, 1, 3, 1, 1))
            init_vggt_(self, torch.Generator(device).manual_seed(seed), w["init_values"], w["patch_embed_init_values"])

    def forward(self, images: Tensor) -> Dict[str, object]:
        """images (b, s, 3, h, w) in [0, 1], h and w multiples of the patch
        size -> pose_enc (b, s, 9) and pose_enc_list (each refinement's),
        depth (b, s, h, w, 1), depth_conf (b, s, h, w), world_points (b, s,
        h, w, 3), world_points_conf (b, s, h, w), all float32."""
        if images.dim() == 4:
            images = images[None]
        hw = tuple(images.shape[-2:])
        dev = images.device.type
        with compute_in(self.compute_dtype, torch.float32, dev):
            layers = self.aggregator(images, self.keep)
        start = self.aggregator.patch_start_idx
        with torch.autocast(dev, enabled=False):
            with trace.span("camera_head"):
                poses = self.camera_head(layers[-1])
            with trace.span("heads"):
                depth, depth_conf = self.depth_head(layers, hw, start)
                points, points_conf = self.point_head(layers, hw, start)
        return {"pose_enc": poses[-1], "pose_enc_list": poses, "depth": depth, "depth_conf": depth_conf,
                "world_points": points, "world_points_conf": points_conf}


@torch.no_grad()
def init_vggt_(model: nn.Module, generator: torch.Generator, init_values: float = 0.01,
               patch_embed_init_values: float = 1.0) -> nn.Module:
    """Random weights by flax's default rule (utils/convert.py::init_like_flax_:
    lecun-normal kernels, zero biases, LayerNorm ones and zeros), with VGGT's
    own init where the rule has none: LayerScale gammas at `init_values`
    (the DINOv2 trunk's at `patch_embed_init_values`), the camera and
    register tokens N(0, 1e-6), the DINOv2 position embedding N(0, 0.02),
    the class and register tokens N(0, 1e-6), the mask and empty pose tokens
    zero."""
    from ..utils.convert import init_like_flax_

    init_like_flax_(model, generator)
    for m in model.modules():
        if isinstance(m, LayerScale):
            m.gamma.fill_(init_values)
    agg = model.aggregator
    dino = agg.patch_embed
    for blk in dino.blocks:
        blk.ls1.gamma.fill_(patch_embed_init_values)
        blk.ls2.gamma.fill_(patch_embed_init_values)
    nn.init.trunc_normal_(dino.pos_embed, std=0.02, generator=generator)
    nn.init.normal_(dino.cls_token, std=1e-6, generator=generator)
    nn.init.normal_(dino.register_tokens, std=1e-6, generator=generator)
    dino.mask_token.zero_()
    nn.init.normal_(agg.camera_token, std=1e-6, generator=generator)
    nn.init.normal_(agg.register_token, std=1e-6, generator=generator)
    model.camera_head.empty_pose_tokens.zero_()
    return model


def quat_to_mat(quat: Tensor) -> Tensor:
    """xyzw quaternions (..., 4) -> rotation matrices (..., 3, 3)."""
    i, j, k, r = torch.unbind(quat, -1)
    two_s = 2.0 / (quat * quat).sum(-1)
    o = torch.stack((
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ), -1)
    return o.reshape(quat.shape[:-1] + (3, 3))


def pose_encoding_to_extri_intri(pose_enc: Tensor, image_hw: Tuple[int, int]) -> Tuple[Tensor, Tensor]:
    """VGGT's absT_quaR_FoV pose encoding (b, s, 9) -> OpenCV
    camera-from-world extrinsics (b, s, 3, 4) and pixel intrinsics (b, s, 3,
    3) of an image of `image_hw` (the principal point at its centre)."""
    h, w = image_hw
    rot = quat_to_mat(pose_enc[..., 3:7])
    extrinsics = torch.cat([rot, pose_enc[..., :3, None]], dim=-1)
    fy = (h / 2.0) / torch.tan(pose_enc[..., 7] / 2.0)
    fx = (w / 2.0) / torch.tan(pose_enc[..., 8] / 2.0)
    intrinsics = torch.zeros(pose_enc.shape[:-1] + (3, 3), dtype=pose_enc.dtype, device=pose_enc.device)
    intrinsics[..., 0, 0] = fx
    intrinsics[..., 1, 1] = fy
    intrinsics[..., 0, 2] = w / 2
    intrinsics[..., 1, 2] = h / 2
    intrinsics[..., 2, 2] = 1.0
    return extrinsics, intrinsics
