"""A plain PyTorch reference of VGGT (Wang et al., CVPR 2025,
arXiv:2503.11651; github.com/facebookresearch/vggt), written from its
equations in float32 with TF32 off for matmuls and cuDNN alike. It imports
nothing but torch: neither JAX nor the JAX package nor the port, and none of
the port's kernels. Its one departure from VGGT is the tracking head, left
out (VGGT's forward skips it unless query points are given).

Module and parameter names are VGGT's, so the same state dict loads here and
into the port by key name. Attention is softmax(q k^T / sqrt(d)) v written
out, in blocks of queries, so a scene of 32 frames at 518x392 (33,312
tokens) fits on one card; RoPE2D is VGGT's (cos/sin tables looked up by
position) after QK-norm, in float32.

`draw(seed, device, **widths)` builds the model with random weights: flax's
default rule (lecun-normal kernels drawn truncated at two standard
deviations, zero biases, LayerNorm ones and zeros) and VGGT's own init where
the rule has none (LayerScale gammas, special tokens, the DINOv2 position
embedding).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
Q_BLOCK = 2048  # queries an attention block takes at once


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """(b, h, n, d) -> (b, h, n, d), softmax(q k^T / sqrt(d)) v, computed a
    block of Q_BLOCK queries at a time."""
    scale = q.shape[-1] ** -0.5
    out = []
    for i in range(0, q.shape[2], Q_BLOCK):
        scores = torch.matmul(q[:, :, i:i + Q_BLOCK] * scale, k.transpose(-1, -2))
        out.append(torch.matmul(scores.softmax(dim=-1), v))
    return torch.cat(out, dim=2)


def rope2d(x: Tensor, pos: Tensor, freq: float) -> Tensor:
    """VGGT's RotaryPositionEmbedding2D: x (b, h, n, d) rotated by integer
    (y, x) positions pos (b, n, 2); the first half of d by y, the second by
    x, each as 1D RoPE with inv_freq 1 / freq**(2f / (d/2))."""
    half = x.shape[-1] // 2
    exponents = torch.arange(0, half, 2, device=x.device).float() / half
    inv_freq = 1.0 / (freq**exponents)
    positions = torch.arange(int(pos.max()) + 1, device=x.device, dtype=inv_freq.dtype)
    angles = torch.einsum("i,j->ij", positions, inv_freq)
    angles = torch.cat([angles, angles], dim=-1)
    cos, sin = angles.cos(), angles.sin()

    def rope1d(t, p):
        c = F.embedding(p, cos)[:, None]
        s = F.embedding(p, sin)[:, None]
        t1, t2 = t[..., : t.shape[-1] // 2], t[..., t.shape[-1] // 2:]
        return t * c + torch.cat([-t2, t1], dim=-1) * s

    y, xx = x.chunk(2, dim=-1)
    return torch.cat([rope1d(y, pos[..., 0].long()), rope1d(xx, pos[..., 1].long())], dim=-1)


class Attention(nn.Module):
    def __init__(self, dim, heads, qk_norm=False, rope_freq=None):
        super().__init__()
        self.heads, self.rope_freq = heads, rope_freq
        self.qkv = nn.Linear(dim, 3 * dim)
        if qk_norm:
            self.q_norm = nn.LayerNorm(dim // heads)
            self.k_norm = nn.LayerNorm(dim // heads)
        self.qk_norm = qk_norm
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, pos=None):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4).unbind(0)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if self.rope_freq is not None:
            q, k = rope2d(q, pos, self.rope_freq), rope2d(k, pos, self.rope_freq)
        return self.proj(attention(q, k, v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, out):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    """x + ls1(attn(norm1(x))), then x + ls2(mlp(norm2(x)))."""

    def __init__(self, dim, heads, mlp_ratio, eps, qk_norm=False, rope_freq=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, heads, qk_norm, rope_freq)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x, pos=None):
        x = x + self.ls1(self.attn(self.norm1(x), pos))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch, dim):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class Dino(nn.Module):
    def __init__(self, img_size, patch, dim, depth, heads, mlp_ratio, registers):
        super().__init__()
        self.patch, self.registers = patch, registers
        self.patch_embed = PatchEmbed(patch, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (img_size // patch) ** 2 + 1, dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, registers, dim))
        self.mask_token = nn.Parameter(torch.zeros(1, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, mlp_ratio, 1e-6) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, images):
        n, _, h, w = images.shape
        x = self.patch_embed.proj(images).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(n, -1, -1), x], dim=1)
        grid = self.pos_embed.shape[1] - 1
        if x.shape[1] - 1 == grid and h == w:
            pos = self.pos_embed
        else:
            m, dim = int(math.sqrt(grid)), x.shape[-1]
            patch = F.interpolate(self.pos_embed[:, 1:].reshape(1, m, m, dim).permute(0, 3, 1, 2),
                                  size=(h // self.patch, w // self.patch), mode="bicubic", antialias=True)
            pos = torch.cat([self.pos_embed[:, :1], patch.permute(0, 2, 3, 1).reshape(1, -1, dim)], dim=1)
        x = x + pos
        x = torch.cat([x[:, :1], self.register_tokens.expand(n, -1, -1), x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1 + self.registers:]


class Aggregator(nn.Module):
    def __init__(self, w):
        super().__init__()
        dim, heads = w["embed_dim"], w["num_heads"]
        self.patch = w["patch_size"]
        self.patch_embed = Dino(w["img_size"], w["patch_size"], dim, w["patch_embed_depth"], heads, w["mlp_ratio"],
                                w["num_register_tokens"])
        self.frame_blocks = nn.ModuleList(Block(dim, heads, w["mlp_ratio"], 1e-5, True, w["rope_freq"])
                                          for _ in range(w["depth"]))
        self.global_blocks = nn.ModuleList(Block(dim, heads, w["mlp_ratio"], 1e-5, True, w["rope_freq"])
                                           for _ in range(w["depth"]))
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, dim))
        self.register_token = nn.Parameter(torch.zeros(1, 2, w["num_register_tokens"], dim))
        self.start = 1 + w["num_register_tokens"]

    def forward(self, images) -> List[Tensor]:
        b, s, _, h, w = images.shape
        mean = torch.tensor(MEAN, device=images.device).view(1, 1, 3, 1, 1)
        std = torch.tensor(STD, device=images.device).view(1, 1, 3, 1, 1)
        x = self.patch_embed(((images - mean) / std).reshape(b * s, 3, h, w))

        def special(t):  # frame 0 takes index 0, the others index 1
            t = torch.cat([t[:, :1].expand(b, 1, -1, -1), t[:, 1:].expand(b, s - 1, -1, -1)], dim=1)
            return t.reshape(b * s, *t.shape[2:])

        x = torch.cat([special(self.camera_token), special(self.register_token), x], dim=1)
        p, c = x.shape[1:]
        gh, gw = h // self.patch, w // self.patch
        ys, xs = torch.meshgrid(torch.arange(gh, device=x.device), torch.arange(gw, device=x.device), indexing="ij")
        grid = torch.stack([ys, xs], dim=-1).reshape(-1, 2) + 1
        pos = torch.cat([torch.zeros(self.start, 2, dtype=grid.dtype, device=x.device), grid])
        pos = pos[None].expand(b * s, -1, -1)
        out = []
        for frame, glob in zip(self.frame_blocks, self.global_blocks):
            x = frame(x.reshape(b * s, p, c), pos)
            f = x.reshape(b, s, p, c)
            x = glob(x.reshape(b, s * p, c), pos.reshape(b, s * p, 2))
            out.append(torch.cat([f, x.reshape(b, s, p, c)], dim=-1))
        return out


class CameraHead(nn.Module):
    def __init__(self, w):
        super().__init__()
        dim = 2 * w["embed_dim"]
        self.iterations = w["camera_iterations"]
        self.trunk = nn.Sequential(*[Block(dim, w["num_heads"], w["mlp_ratio"], 1e-5)
                                     for _ in range(w["camera_trunk_depth"])])
        self.token_norm = nn.LayerNorm(dim)
        self.trunk_norm = nn.LayerNorm(dim)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, 9))
        self.embed_pose = nn.Linear(9, dim)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim, 3 * dim))
        self.adaln_norm = nn.LayerNorm(dim, elementwise_affine=False, eps=1e-6)
        self.pose_branch = Mlp(dim, dim // 2, 9)

    def forward(self, last):
        tokens = self.token_norm(last[:, :, 0])
        b, s, _ = tokens.shape
        enc, out = None, []
        for _ in range(self.iterations):
            cond = self.embed_pose(self.empty_pose_tokens.expand(b, s, -1) if enc is None else enc)
            shift, scale, gate = self.poseLN_modulation(cond).chunk(3, dim=-1)
            x = gate * (self.adaln_norm(tokens) * (1 + scale) + shift) + tokens
            delta = self.pose_branch(self.trunk_norm(self.trunk(x)))
            enc = delta if enc is None else enc + delta
            out.append(torch.cat([enc[..., :7], F.relu(enc[..., 7:])], dim=-1))
        return out


def uv_embed(width, height, aspect, channels, device):
    """(channels, height, width) float32: the UV grid's sin/cos embedding."""
    diag = (aspect**2 + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (width - 1) / width, sx * (width - 1) / width, width, device=device)
    ys = torch.linspace(-sy * (height - 1) / height, sy * (height - 1) / height, height, device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")
    d = channels // 2
    omega = 1.0 / 100.0 ** (torch.arange(d // 2, dtype=torch.float64, device=device) / (d / 2.0))

    def emb(t):
        a = t.reshape(-1).double()[:, None] * omega[None]
        return torch.cat([a.sin(), a.cos()], dim=1).float()

    return torch.cat([emb(uu), emb(vv)], dim=-1).view(height, width, channels).permute(2, 0, 1)


class Unit(nn.Module):
    """VGGT's ResidualConvUnit; its in-place ReLU rectifies the input that
    the skip adds back."""

    def __init__(self, f):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        x = F.relu(x)
        return self.conv2(F.relu(self.conv1(x))) + x


class Fusion(nn.Module):
    def __init__(self, f, skip):
        super().__init__()
        if skip:
            self.resConfUnit1 = Unit(f)
        self.resConfUnit2 = Unit(f)
        self.out_conv = nn.Conv2d(f, f, 1)

    def forward(self, x, res=None, size=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        size = size if size is not None else (2 * x.shape[2], 2 * x.shape[3])
        return self.out_conv(F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True))


class DPTHead(nn.Module):
    def __init__(self, w, out_dim, activation):
        super().__init__()
        dim, oc, f = 2 * w["embed_dim"], w["head_out_channels"], w["head_features"]
        self.patch, self.activation = w["patch_size"], activation
        self.layers, self.chunk = tuple(w["head_layers"]), w["frames_chunk_size"]
        self.norm = nn.LayerNorm(dim)
        self.projects = nn.ModuleList(nn.Conv2d(dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
                                            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2), nn.Identity(),
                                            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = nn.Module()
        for i, c in enumerate(oc):
            setattr(self.scratch, f"layer{i + 1}_rn", nn.Conv2d(c, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}", Fusion(f, i < 4))
        self.scratch.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.scratch.output_conv2 = nn.Sequential(nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
                                                  nn.Conv2d(32, out_dim, 1))

    def forward(self, layers, h, w, start):
        s = layers[0].shape[1]
        parts = [self.frames(layers, h, w, start, i, min(i + self.chunk, s)) for i in range(0, s, self.chunk)]
        return torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1)

    def frames(self, layers, h, w, start, f0, f1):
        ph, pw = h // self.patch, w // self.patch
        feats = []
        for i, idx in enumerate(self.layers):
            x = layers[idx][:, f0:f1, start:]
            b, s = x.shape[:2]
            x = self.norm(x.reshape(b * s, -1, x.shape[-1])).permute(0, 2, 1).reshape(b * s, -1, ph, pw)
            x = self.projects[i](x)
            x = x + 0.1 * uv_embed(pw, ph, w / h, x.shape[1], x.device).to(x)
            feats.append(self.resize_layers[i](x))
        sc = self.scratch
        l1, l2, l3, l4 = [getattr(sc, f"layer{i + 1}_rn")(t) for i, t in enumerate(feats)]
        out = sc.refinenet4(l4, size=l3.shape[2:])
        out = sc.refinenet3(out, l3, size=l2.shape[2:])
        out = sc.refinenet2(out, l2, size=l1.shape[2:])
        out = sc.output_conv1(sc.refinenet1(out, l1))
        out = F.interpolate(out, size=(ph * self.patch, pw * self.patch), mode="bilinear", align_corners=True)
        out = out + 0.1 * uv_embed(out.shape[3], out.shape[2], w / h, out.shape[1], out.device).to(out)
        fmap = sc.output_conv2(out).permute(0, 2, 3, 1)
        v, c = fmap[..., :-1], fmap[..., -1]
        v = torch.exp(v) if self.activation == "exp" else torch.sign(v) * torch.expm1(v.abs())
        c = 1 + c.exp()
        return v.reshape(b, s, *v.shape[1:]), c.reshape(b, s, *c.shape[1:])


class VGGTReference(nn.Module):
    def __init__(self, **w):
        super().__init__()
        self.widths = w
        self.aggregator = Aggregator(w)
        self.camera_head = CameraHead(w)
        self.point_head = DPTHead(w, 4, "inv_log")
        self.depth_head = DPTHead(w, 2, "exp")

    def forward(self, images: Tensor, heads_dtype: Optional[torch.dtype] = None):
        """images (b, s, 3, h, w) in [0, 1] -> VGGT's outputs, float32. With
        `heads_dtype` the heads run under autocast in it (the control)."""
        h, w = images.shape[-2:]
        with no_tf32():
            layers = self.aggregator(images)
            start = self.aggregator.start
            with torch.autocast(images.device.type, dtype=heads_dtype or torch.bfloat16,
                                enabled=heads_dtype is not None):
                poses = self.camera_head(layers[-1])
                depth, depth_conf = self.depth_head(layers, h, w, start)
                points, points_conf = self.point_head(layers, h, w, start)
        out = {"pose_enc": poses[-1], "pose_enc_list": poses, "depth": depth, "depth_conf": depth_conf,
               "world_points": points, "world_points_conf": points_conf}
        return {k: [t.float() for t in v] if isinstance(v, list) else v.float() for k, v in out.items()}


@torch.no_grad()
def init_(model: nn.Module, generator: torch.Generator, init_values: float, patch_embed_init_values: float):
    """flax's default rule where it applies, VGGT's init elsewhere."""
    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            if m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            wt = m.weight
            fan_in = wt.shape[0] if isinstance(m, nn.ConvTranspose2d) else wt.shape[1] * math.prod(wt.shape[2:])
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(wt, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerScale):
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


def draw(seed: int, device, **widths) -> VGGTReference:
    """The reference at `widths` with random weights drawn from `seed` by a
    generator on `device`."""
    with torch.device("meta"):
        model = VGGTReference(**widths)
    model = model.to_empty(device=device)
    return init_(model, torch.Generator(device).manual_seed(seed), widths["init_values"],
                 widths["patch_embed_init_values"]).eval()
