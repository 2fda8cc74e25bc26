"""DPT feature-pyramid heads for dense prediction from ViT tokens
(counterpart of styl3r_tpu/models/dpt.py; reference heads/dpt_block.py,
dpt_head.py, dpt_gs_head.py, dpt_gs_sh_head.py).

Convs run NCHW inside; the heads take (b, l, c) token lists and NHWC images
and return NHWC maps, as the JAX heads do. The 3x3 stride-1 convs go
through ops/conv.py::conv3x3, which takes csrc/conv3x3_f32.cu for float32
CUDA tensors with TF32 off (ReLUs that follow a conv fused into it) and the
module's own forward otherwise. The JAX package rewrites the
align-corners bilinear resize as two matmuls and the k=s transposed convs as
a linear + pixel shuffle for the TPU; here they are `F.interpolate` and
`nn.ConvTranspose2d`, as in the reference.

Precision: with a trunk dtype (bf16 on the card) the trunk, the first head
conv and the image merger compute in it; the final convs and expm1 run in
f32. The weights stay f32 and are cast at use (`trunk_dtype`, as flax's
`dtype=`), unless serving stores the trunk in its compute dtype with
`cast_trunk()`.

Training: the gs_params tower's dropout (rate 0.1, after the conv3x3's
ReLU) is live in training mode and draws its mask from the
torch.Generator the forward is given. In a data-parallel step
(`shard_dropout_`) each rank draws the mask of the global batch, as the JAX
step's replicated key does, and keeps its own rows, so W ranks drop what
one process drops on the whole batch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from ..ops.conv import conv3x3
from .precision import compute_in

GS_DROPOUT = 0.1  # gs_params tower dropout (reference dpt_block.py)


def dropout(
    x: Tensor, p: float, training: bool, generator: Optional[torch.Generator], shard: Tuple[int, int] = (0, 1)
) -> Tensor:
    """Inverted dropout with its mask drawn from `generator` (nn.Dropout
    takes none): zero with probability p, scale the rest by 1 / (1 - p).
    The identity outside training. With `shard` = (rank, W), x holds rank's
    rows of a global batch of W * len(x) rows, in rank order: the mask is
    drawn for all of them and rank's rows are kept."""
    if not training or p == 0.0:
        return x
    rank, world = shard
    n = x.shape[0]
    keep = torch.rand((world * n, *x.shape[1:]), generator=generator, device=x.device)[rank * n:(rank + 1) * n] >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def upsample2x(x: Tensor) -> Tensor:
    """NCHW align-corners bilinear 2x upsample."""
    return F.interpolate(
        x, size=(x.shape[2] * 2, x.shape[3] * 2), mode="bilinear", align_corners=True
    )


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv with skip (no BN). With `relu_skip` the skip is
    relu(x): VGGT's units apply an in-place ReLU to their input, so the
    input they add back has been rectified."""

    def __init__(self, features: int, relu_skip: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.relu_skip = relu_skip

    def forward(self, x: Tensor) -> Tensor:
        r = F.relu(x)
        return conv3x3(conv3x3(r, self.conv1, relu=True), self.conv2) + (r if self.relu_skip else x)


class FeatureFusionBlock(nn.Module):
    """Fuse a coarser path with a skip, upsample (2x, or to `size` where
    given; align-corners bilinear), project 1x1. The coarsest block has no
    skip and so no resConfUnit1."""

    def __init__(self, features: int, has_skip: bool = True, relu_skip: bool = False):
        super().__init__()
        if has_skip:
            self.resConfUnit1 = ResidualConvUnit(features, relu_skip)
        self.resConfUnit2 = ResidualConvUnit(features, relu_skip)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: Tensor, res: Optional[Tensor] = None, size: Optional[Tuple[int, int]] = None) -> Tensor:
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if size is None:
            return self.out_conv(upsample2x(x))
        return self.out_conv(F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True))


class DPTTrunk(nn.Module):
    """Hook + reassemble + fuse; returns the feature_dim path at stride 2
    (NCHW). The head classes attach `head` (and `input_merger`) to this
    module, because the reference nests them under `<head>.dpt`."""

    def __init__(
        self,
        hook_dims: Sequence[int],
        hooks: Sequence[int] = (0, 6, 9, 12),
        layer_dims: Sequence[int] = (96, 192, 384, 768),
        feature_dim: int = 256,
        patch_size: int = 16,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.hooks = tuple(hooks)
        self.patch_size = patch_size
        ld = layer_dims
        self.act_postprocess = nn.ModuleList(
            [
                nn.Sequential(
                    nn.Conv2d(hook_dims[0], ld[0], 1), nn.ConvTranspose2d(ld[0], ld[0], 4, stride=4)
                ),
                nn.Sequential(
                    nn.Conv2d(hook_dims[1], ld[1], 1), nn.ConvTranspose2d(ld[1], ld[1], 2, stride=2)
                ),
                nn.Sequential(nn.Conv2d(hook_dims[2], ld[2], 1)),
                nn.Sequential(
                    nn.Conv2d(hook_dims[3], ld[3], 1), nn.Conv2d(ld[3], ld[3], 3, stride=2, padding=1)
                ),
            ]
        )
        self.scratch = nn.Module()
        for i, d in enumerate(ld):
            setattr(self.scratch, f"layer{i + 1}_rn", nn.Conv2d(d, feature_dim, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}", FeatureFusionBlock(feature_dim, has_skip=i < 4))

    @property
    def weight_dtype(self) -> torch.dtype:
        return self.scratch.layer1_rn.weight.dtype

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the trunk computes in."""
        return self.compute_dtype or self.weight_dtype

    def precision(self, device_type: str):
        return compute_in(self.compute_dtype, self.weight_dtype, device_type)

    def forward(self, tokens: List[Tensor], image_size: Tuple[int, int]) -> Tensor:
        h, w = image_size
        nh, nw = h // self.patch_size, w // self.patch_size
        layers = []
        for i, hook in enumerate(self.hooks):
            t = tokens[hook].to(self.dtype)
            b, _, c = t.shape
            layers.append(self.act_postprocess[i](t.transpose(1, 2).reshape(b, c, nh, nw)))
        s = self.scratch
        rn = [conv3x3(l, getattr(s, f"layer{i + 1}_rn")) for i, l in enumerate(layers)]
        path4 = s.refinenet4(rn[3])[:, :, : rn[2].shape[2], : rn[2].shape[3]]
        path3 = s.refinenet3(path4, rn[2])
        path2 = s.refinenet2(path3, rn[1])
        return s.refinenet1(path2, rn[0])


def reg_dense_pts3d(raw: Tensor, bound: Optional[float] = None, d_min: float = 0.1) -> Tensor:
    """'exp' postprocess: direction * expm1(norm), with the optional smooth
    radial clamp to [d_min, bound] (None is the reference path)."""
    norm = torch.linalg.norm(raw, dim=-1, keepdim=True)
    direction = raw / torch.clamp(norm, min=1e-8)
    dist = torch.expm1(norm)
    if bound is not None:
        span = bound - d_min
        dist = d_min + span * torch.tanh(dist / span)
    return direction * dist


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


class DPTPts3dHead(nn.Module):
    """'dpt' head: regression tower -> (b, h, w, 3) pts3d via the exp
    postprocess. Reference head Sequential indices 0 (conv), 2 (conv),
    4 (1x1 conv). With `with_conf` (the DUSt3R teacher's heads) the 1x1 conv
    has a 4th channel, returned as a confidence map conf = 1 + exp(min(x,
    20)) beside the points."""

    def __init__(
        self,
        hook_dims: Sequence[int],
        feature_dim: int = 256,
        last_dim: int = 128,
        hooks: Sequence[int] = (0, 6, 9, 12),
        layer_dims: Sequence[int] = (96, 192, 384, 768),
        patch_size: int = 16,
        pts3d_bound: Optional[float] = None,
        trunk_dtype: Optional[torch.dtype] = None,
        with_conf: bool = False,
    ):
        super().__init__()
        self.pts3d_bound = pts3d_bound
        self.with_conf = with_conf
        self.dpt = DPTTrunk(hook_dims, hooks, layer_dims, feature_dim, patch_size, trunk_dtype)
        self.dpt.head = nn.ModuleDict(
            {
                "0": nn.Conv2d(feature_dim, feature_dim // 2, 3, padding=1),
                "2": nn.Conv2d(feature_dim // 2, last_dim, 3, padding=1),
                "4": nn.Conv2d(last_dim, 3 + int(with_conf), 1),
            }
        )

    def cast_trunk(self, dtype: torch.dtype) -> None:
        self.dpt.act_postprocess.to(dtype)
        self.dpt.scratch.to(dtype)
        self.dpt.head["0"].to(dtype)

    def forward(self, tokens: List[Tensor], image_size: Tuple[int, int]):
        head = self.dpt.head
        with self.dpt.precision(tokens[0].device.type):
            x = conv3x3(self.dpt(tokens, image_size), head["0"])
        x = upsample2x(x).to(head["2"].weight.dtype)
        x = _nhwc(head["4"](conv3x3(x, head["2"], relu=True)))
        pts = reg_dense_pts3d(x[..., :3], bound=self.pts3d_bound)
        if self.with_conf:
            return pts, conf_from_raw(x[..., 3])
        return pts


def conf_from_raw(x: Tensor) -> Tensor:
    """The 'exp' confidence postprocess with vmin 1: 1 + exp(min(x, 20))."""
    return 1.0 + torch.exp(torch.clamp(x, max=20.0))


def _pixel_shuffle_tokens(feat: Tensor, nh: int, nw: int, p: int) -> Tensor:
    """(b, nh*nw, c*p*p) token features -> (b, nh*p, nw*p, c) NHWC, in
    `view(b, c*p*p, nh, nw)` + `F.pixel_shuffle(p)`'s channel order (feature
    index c_out*p*p + dy*p + dx)."""
    b, _, f = feat.shape
    x = feat.transpose(1, 2).reshape(b, f, nh, nw)
    return _nhwc(F.pixel_shuffle(x, p))


class LinearPts3dHead(nn.Module):
    """'linear' pts3d head (reference heads/linear_head.py:12-40): one linear
    map from the last decoder level to p*p*(3 [+ conf]) values a token,
    pixel-shuffled to full resolution, exp postprocess. No release config
    uses it; it completes the head registry."""

    def __init__(self, dec_dim: int, patch_size: int = 16, with_conf: bool = False):
        super().__init__()
        self.patch_size = patch_size
        self.with_conf = with_conf
        self.proj = nn.Linear(dec_dim, (3 + int(with_conf)) * patch_size**2)

    def forward(self, tokens: List[Tensor], image_size: Tuple[int, int]):
        h, w = image_size
        p = self.patch_size
        img = _pixel_shuffle_tokens(self.proj(tokens[-1]), h // p, w // p, p)
        pts = reg_dense_pts3d(img[..., :3])
        if self.with_conf:
            return pts, conf_from_raw(img[..., 3])
        return pts


class LinearGSHead(nn.Module):
    """'linear' Gaussian-parameter head (reference heads/linear_head.py:43-76):
    one linear map to out_channels*p*p values a token (2 xy offsets + 1
    opacity + the raw Gaussian channels in the reference), pixel-shuffled;
    raw output, the adapter applies the activations."""

    def __init__(self, dec_dim: int, out_channels: int, patch_size: int = 16):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Linear(dec_dim, out_channels * patch_size**2)

    def forward(self, tokens: List[Tensor], image_size: Tuple[int, int]) -> Tensor:
        h, w = image_size
        p = self.patch_size
        return _pixel_shuffle_tokens(self.proj(tokens[-1]), h // p, w // p, p)


class GSParamsHead(nn.Module):
    """Shared body of the 'dpt_gs' and 'dpt_gs_sh' heads: trunk, 2x upsample,
    optional conv7x7 image merger, then the gs_params tower conv3x3 -> relu ->
    dropout -> conv1x1 (reference indices 0 and 4)."""

    def __init__(
        self,
        hook_dims: Sequence[int],
        out_channels: int,
        with_merger: bool,
        feature_dim: int = 256,
        hooks: Sequence[int] = (0, 6, 9, 12),
        layer_dims: Sequence[int] = (96, 192, 384, 768),
        patch_size: int = 16,
        trunk_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dpt = DPTTrunk(hook_dims, hooks, layer_dims, feature_dim, patch_size, trunk_dtype)
        self.dpt.head = nn.ModuleDict(
            {
                "0": nn.Conv2d(feature_dim, feature_dim, 3, padding=1, bias=False),
                "4": nn.Conv2d(feature_dim, out_channels, 1),
            }
        )
        if with_merger:
            self.dpt.input_merger = nn.Sequential(
                nn.Conv2d(3, feature_dim, 7, padding=3), nn.ReLU()
            )
        self.dropout_shard = (0, 1)  # (rank, W): see shard_dropout_

    def cast_trunk(self, dtype: torch.dtype) -> None:
        self.dpt.act_postprocess.to(dtype)
        self.dpt.scratch.to(dtype)
        self.dpt.head["0"].to(dtype)
        if hasattr(self.dpt, "input_merger"):
            self.dpt.input_merger.to(dtype)

    def _forward(
        self, tokens: List[Tensor], image_size: Tuple[int, int], images: Optional[Tensor],
        generator: Optional[torch.Generator],
    ) -> Tensor:
        dpt, head = self.dpt, self.dpt.head
        with dpt.precision(tokens[0].device.type):
            x = upsample2x(dpt(tokens, image_size))
            if images is not None:
                x = x + dpt.input_merger(images.permute(0, 3, 1, 2).to(dpt.dtype))
            x = conv3x3(x.to(dpt.dtype), head["0"], relu=True)
        x = dropout(x, GS_DROPOUT, self.training, generator, self.dropout_shard)
        return _nhwc(head["4"](x.to(head["4"].weight.dtype)))


def shard_dropout_(model: nn.Module, rank: int, world: int) -> None:
    """Make the gs towers' dropout in `model` draw the global batch's masks
    and keep rank's rows (dropout's `shard`): the model then sees rank
    `rank`'s 1/W of each global batch, as parallel/mesh.py::shard_batch cuts
    it (its rows of every (b, ...) and batch-major (b * v, ...) tensor)."""
    for m in model.modules():
        if isinstance(m, GSParamsHead):
            m.dropout_shard = (rank, world)


class DPTGSHead(GSParamsHead):
    """'dpt_gs' head: structure params with the direct image-feature merge."""

    def __init__(self, hook_dims: Sequence[int], out_channels: int, **kwargs):
        super().__init__(hook_dims, out_channels, with_merger=True, **kwargs)

    def forward(
        self, tokens: List[Tensor], images: Tensor, image_size: Tuple[int, int],
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        return self._forward(tokens, image_size, images, generator)


class DPTGSSHHead(GSParamsHead):
    """'dpt_gs_sh' head: SH appearance at full resolution."""

    def __init__(self, hook_dims: Sequence[int], out_channels: int, **kwargs):
        super().__init__(hook_dims, out_channels, with_merger=False, **kwargs)

    def forward(
        self, tokens: List[Tensor], image_size: Tuple[int, int],
        generator: Optional[torch.Generator] = None,
    ) -> Tensor:
        return self._forward(tokens, image_size, None, generator)
