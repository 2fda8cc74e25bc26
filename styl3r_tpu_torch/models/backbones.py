"""NoPoSplat's legacy backbones: a ResNet feature pyramid and DINO ViT
(counterpart of styl3r_tpu/models/backbones.py; reference
`src/model/encoder/backbone/backbone_resnet.py`, `backbone_dino.py`). No
Styl3R release config uses them; the registry names them. NHWC at the
module boundary, NCHW inside.

Key names are the reference's, which the JAX package's converters read:
torchvision's under `model.` (`conv1`, `layerL.B.convK`, `layerL.B.bnK`,
`layerL.B.downsample.0/1`) with `projections.layer{i}` for the 1x1
projections (convert_backbone_resnet), and facebookresearch/dino's for the
ViT (convert_dino_vit).

  * The torchvision ResNets are built with a parameter-free
    InstanceNorm2d (backbone_resnet.py:36-45); `dino_resnet50` (torch hub)
    keeps BatchNorm, here frozen in eval mode (FrozenBatchNorm2d), so
    `_fold_bn` folds its buffers into the JAX FrozenNorm's scale and bias.
  * Only the layers the forward runs are built: layers 1 .. num_layers-1
    (the JAX trunk's loop).
  * A flax param takes its shape at the first call; a torch one at
    construction, so DinoViT and BackboneDino take the image size that
    sizes `pos_embed` (default Styl3R's 256^2 context views) and raise on
    another.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

RESNET_LAYERS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
    "dino_resnet50": ("bottleneck", (3, 4, 6, 3)),
}


def resize_bilinear_align_corners(x: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """Bilinear resize of NHWC features with align_corners=True."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalizes with its running statistics (the
    JAX FrozenNorm's folded scale and bias), in train mode too."""

    def forward(self, x: Tensor) -> Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class InstanceNorm(nn.Module):
    """torch InstanceNorm2d(affine=False, track_running_stats=False): per
    sample and channel over space, biased variance. No state."""

    def forward(self, x: Tensor) -> Tensor:
        return F.instance_norm(x, eps=1e-5)


def _norm(features: int, frozen_bn: bool) -> nn.Module:
    return FrozenBatchNorm2d(features) if frozen_bn else InstanceNorm()


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1, frozen_bn: bool = False, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride, 1, bias=False)
        self.bn1 = _norm(features, frozen_bn)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = _norm(features, frozen_bn)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, features, 1, stride, bias=False), _norm(features, frozen_bn))
                           if downsample else None)

    def forward(self, x: Tensor) -> Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + identity)


class Bottleneck(nn.Module):
    """torchvision's v1.5 bottleneck: the stride on the 3x3 conv; output
    4x the bottleneck width."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1, frozen_bn: bool = False, downsample: bool = False):
        super().__init__()
        out_ch = features * 4
        self.conv1 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = _norm(features, frozen_bn)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = _norm(features, frozen_bn)
        self.conv3 = nn.Conv2d(features, out_ch, 1, bias=False)
        self.bn3 = _norm(out_ch, frozen_bn)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride, bias=False), _norm(out_ch, frozen_bn))
                           if downsample else None)

    def forward(self, x: Tensor) -> Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + identity)


class ResNetTrunk(nn.Module):
    """torchvision-layout trunk: conv1/bn1/relu, then layer1 ..
    layer{num_layers-1}. forward returns [stem, layer1, ...]. The max pool
    sits before layer1 when `use_first_pool` (the JAX trunk's placement:
    the reference's in-loop `index == 0` pool condition never fires)."""

    def __init__(self, model: str = "resnet50", num_layers: int = 4):
        super().__init__()
        block_kind, depths = RESNET_LAYERS[model]
        block_cls = BasicBlock if block_kind == "basic" else Bottleneck
        frozen_bn = model == "dino_resnet50"
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _norm(64, frozen_bn)
        in_ch, width = 64, 64
        for li in range(1, num_layers):
            stride = 1 if li == 1 else 2
            blocks = []
            for bi in range(depths[li - 1]):
                needs_down = bi == 0 and (stride != 1 or in_ch != width * block_cls.expansion)
                blocks.append(block_cls(in_ch, width, stride if bi == 0 else 1, frozen_bn, needs_down))
                in_ch = width * block_cls.expansion
            self.add_module(f"layer{li}", nn.Sequential(*blocks))
            width *= 2
        self.num_layers = num_layers

    def forward(self, x: Tensor, use_first_pool: bool = True) -> List[Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        feats = [x]
        if use_first_pool:
            x = F.max_pool2d(x, 3, 2, 1)
        for li in range(1, self.num_layers):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        return feats


def trunk_channels(model: str, num_layers: int) -> List[int]:
    """Channels of each of ResNetTrunk's outputs."""
    expansion = 1 if RESNET_LAYERS[model][0] == "basic" else 4
    return [64] + [64 * 2 ** (li - 1) * expansion for li in range(1, num_layers)]


class BackboneResnet(nn.Module):
    """The ResNet feature pyramid (backbone_resnet.py:28-101): each output's
    1x1 projection to d_out, upsampled to the input size (bilinear,
    align_corners=True), summed. images (b, v, h, w, 3) -> (b, v, h, w,
    d_out)."""

    def __init__(self, model: str = "resnet50", num_layers: int = 4, use_first_pool: bool = True, d_out: int = 128):
        super().__init__()
        self.model = ResNetTrunk(model, num_layers)
        self.projections = nn.ModuleDict({
            f"layer{i}": nn.Conv2d(c, d_out, 1) for i, c in enumerate(trunk_channels(model, num_layers))
        })
        self.use_first_pool = use_first_pool
        self.d_out = d_out

    def forward(self, images: Tensor) -> Tensor:
        b, v, h, w, _ = images.shape
        x = images.reshape(b * v, h, w, 3).permute(0, 3, 1, 2)
        out = 0.0
        for i, f in enumerate(self.model(x, self.use_first_pool)):
            p = self.projections[f"layer{i}"](f)
            out = out + F.interpolate(p, size=(h, w), mode="bilinear", align_corners=True)
        return out.permute(0, 2, 3, 1).reshape(b, v, h, w, self.d_out)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, patch_size)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.num_heads = num_heads

    def forward(self, x: Tensor) -> Tensor:
        n, length, dim = x.shape
        q, k, v = self.qkv(x).reshape(n, length, 3, self.num_heads, dim // self.num_heads).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(n, length, dim))


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * 4)
        self.fc2 = nn.Linear(dim * 4, dim)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm block: qkv-bias attention and an exact-GELU MLP, LayerNorm
    eps 1e-6."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class DinoViT(nn.Module):
    """The DINO/timm ViT: cls token, learned position embedding, pre-norm
    blocks. (n, h, w, 3) at `image_size` -> the final-normed tokens (n, 1 +
    h w / patch^2, dim), cls first."""

    def __init__(self, patch_size: int = 8, dim: int = 768, depth: int = 12, num_heads: int = 12,
                 image_size: Tuple[int, int] = (256, 256)):
        super().__init__()
        self.patch_size = patch_size
        self.image_size = tuple(image_size)
        n_patches = (image_size[0] // patch_size) * (image_size[1] // patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + n_patches, dim))
        self.patch_embed = PatchEmbed(patch_size, dim)
        self.blocks = nn.ModuleList(Block(dim, num_heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, images: Tensor) -> Tensor:
        if tuple(images.shape[1:3]) != self.image_size:
            raise ValueError(f"DinoViT was built for {self.image_size} images, got {tuple(images.shape[1:3])}")
        x = self.patch_embed.proj(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


def _token_mlp(dim: int, d_out: int) -> nn.Sequential:
    # Linear(dim, 768) for ViT-S and ViT-B alike: flax's Dense(768) infers
    # its input width.
    return nn.Sequential(nn.Linear(dim, 768), nn.ReLU(), nn.Linear(768, d_out))


class BackboneDino(nn.Module):
    """The DINO backbone (backbone_dino.py:21-72): a dino_resnet50 pyramid
    plus the ViT's global (cls) and local (patch) tokens through their MLPs,
    the local map upsampled by repetition, summed at full resolution.
    images (b, v, h, w, 3) -> (b, v, h, w, d_out); h and w must be
    multiples of the patch size."""

    def __init__(self, model: str = "dino_vitb8", d_out: int = 128, image_size: Tuple[int, int] = (256, 256)):
        super().__init__()
        self.patch_size = int("".join(c for c in model if c.isdigit()))
        dim = 384 if "vits" in model else 768
        self.resnet_backbone = BackboneResnet("dino_resnet50", num_layers=4, use_first_pool=False, d_out=d_out)
        self.dino = DinoViT(self.patch_size, dim, depth=12, num_heads=6 if dim == 384 else 12, image_size=image_size)
        self.global_token_mlp = _token_mlp(dim, d_out)
        self.local_token_mlp = _token_mlp(dim, d_out)
        self.d_out = d_out

    def forward(self, images: Tensor) -> Tensor:
        b, v, h, w, _ = images.shape
        ps = self.patch_size
        if h % ps or w % ps:
            raise ValueError(f"image size must be divisible by patch size {ps}")
        resnet_features = self.resnet_backbone(images)
        tokens = self.dino(images.reshape(b * v, h, w, 3))
        global_token = self.global_token_mlp(tokens[:, 0])  # (bv, d_out)
        local_tokens = self.local_token_mlp(tokens[:, 1:])  # (bv, l, d_out)
        local_map = local_tokens.reshape(b * v, h // ps, w // ps, self.d_out)
        local_map = local_map.repeat_interleave(ps, dim=1).repeat_interleave(ps, dim=2)
        vit_maps = (local_map + global_token[:, None, None, :]).reshape(b, v, h, w, self.d_out)
        return resnet_features + vit_maps
