"""Stylization baselines (counterpart of styl3r_tpu/models/stylizers.py).

The 2-D AdaIN baseline (reference `src/test/vgg_model.py`): VGG19 relu4_1
features of the content and the style, AdaIN, and a decoder back to an
image. Not on the production path: validation logs it beside the model's
renders when `train.adain_baseline_weights` is set
(model_wrapper_style.py:260-308). NHWC images, as the JAX package's. The
modules keep the reference's key names below `vgg_encoder` (the torchvision
VGG19 `features.N`, as losses/vgg.py) and `decoder` (`rcN.conv`), so
convert_adain2d_checkpoint only renumbers the encoder's slices.

The point-cloud stylizers of "3D photo stylization" (reference
`src/model/encoder/stylizer/{stylizer,vgg}.py`, research scratch there):
NormalizedVGG, the LST, and the Linear3D / AdaIN3D / AdaAttN3D stylizers,
in the reference's Conv1d layout that the JAX package's
convert_normalized_vgg, convert_lst and _convert_conv1d_chain read.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from ..losses.vgg import VGG19Features


def adain(content: Tensor, style: Tensor, eps: float = 1e-8) -> Tensor:
    """Adaptive instance normalization of NHWC features
    (vgg_model.py:28-56): the content's channel statistics replaced by the
    style's (population standard deviations)."""
    c_mean = content.mean(dim=(1, 2), keepdim=True)
    c_std = content.std(dim=(1, 2), keepdim=True, unbiased=False) + eps
    s_mean = style.mean(dim=(1, 2), keepdim=True)
    s_std = style.std(dim=(1, 2), keepdim=True, unbiased=False) + eps
    return s_std * (content - c_mean) / c_std + s_mean


class ReflectConv(nn.Module):
    """A reflection-padded 3x3 conv (vgg_model.py's RC)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


# (input, output) channels of rc1..rc9; a 2x nearest upsample follows rc1,
# rc5 and rc7.
DECODER_CONVS = [(512, 256), (256, 256), (256, 256), (256, 256), (256, 128), (128, 128), (128, 64), (64, 64), (64, 3)]
UPSAMPLE_AFTER = (1, 5, 7)


class AdaInDecoder(nn.Module):
    """VGG relu4_1 features -> an image (vgg_model.py Decoder): 9
    reflection-padded convs, ReLU after all but the last, 3 upsamples."""

    def __init__(self):
        super().__init__()
        for i, (c_in, c_out) in enumerate(DECODER_CONVS, start=1):
            self.add_module(f"rc{i}", ReflectConv(c_in, c_out))

    def forward(self, x: Tensor) -> Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(1, len(DECODER_CONVS) + 1):
            x = getattr(self, f"rc{i}")(x)
            if i < len(DECODER_CONVS):
                x = F.relu(x)
            if i in UPSAMPLE_AFTER:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
        return x.permute(0, 2, 3, 1)


class AdaIN2D(nn.Module):
    """The 2-D AdaIN baseline (vgg_model.py AdaIN2D): (n, h, w, 3) content
    and style images in [0, 1] -> (n, h, w, 3) stylized images."""

    def __init__(self):
        super().__init__()
        self.vgg_encoder = VGG19Features()
        self.decoder = AdaInDecoder()

    def forward(self, content: Tensor, style: Tensor, alpha: float = 1.0) -> Tensor:
        n = content.shape[0]
        feats = self.vgg_encoder(torch.cat([content, style]))[-1]  # relu4_1
        cf, sf = feats[:n], feats[n:]
        t = adain(cf, sf)
        return self.decoder(alpha * t + (1 - alpha) * cf)


# The reference encoder's slices (slice1 = features[:2], slice2 = [2:7],
# slice3 = [7:12], slice4 = [12:21]) start at these torchvision indices.
_SLICE_OFFSETS = {"slice1": 0, "slice2": 2, "slice3": 7, "slice4": 12}


def convert_adain2d_checkpoint(state_dict: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """The reference AdaIN2D weights (ckpts/model_state.pth:
    vgg_encoder.sliceK.I.* and decoder.rcN.conv.*) -> AdaIN2D's state dict."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("vgg_encoder."):
            _, slice_name, idx, param = key.split(".")
            out[f"vgg_encoder.features.{_SLICE_OFFSETS[slice_name] + int(idx)}.{param}"] = torch.as_tensor(value)
        elif key.startswith("decoder."):
            out[key] = torch.as_tensor(value)
    return out


def adain_pointcloud(content: Tensor, style: Tensor, eps: float = 1e-8) -> Tensor:
    """AdaIN over a whole point cloud's features (vgg_model.py:58-86):
    content (b, n, c) given the channel statistics of style (b, h, w, c)."""
    c_mean = content.mean(dim=1, keepdim=True)
    c_std = content.std(dim=1, keepdim=True, unbiased=False) + eps
    s_flat = style.reshape(style.shape[0], -1, style.shape[-1])
    s_mean = s_flat.mean(dim=1, keepdim=True)
    s_std = s_flat.std(dim=1, keepdim=True, unbiased=False) + eps
    return s_std * (content - c_mean) / c_std + s_mean


def linear_stylizer(content: Tensor, style: Tensor, eps: float = 1e-6) -> Tensor:
    """The WCT-style linear transform (the 'linear'/'lst' baseline): content
    (b, n, c) whitened and colored with the covariance of style (b, h, w,
    c). The whitening and coloring matrices V f(w) V^T do not depend on the
    eigenvectors' signs."""
    b, n, c = content.shape
    s_flat = style.reshape(b, -1, c)
    eye = eps * torch.eye(c, dtype=content.dtype, device=content.device)
    cm = content.mean(dim=1, keepdim=True)
    sm = s_flat.mean(dim=1, keepdim=True)
    cf, sf = content - cm, s_flat - sm
    cw, cv = torch.linalg.eigh(cf.transpose(1, 2) @ cf / n + eye)
    sw, sv = torch.linalg.eigh(sf.transpose(1, 2) @ sf / s_flat.shape[1] + eye)
    whiten = cv @ torch.diag_embed(cw.clamp(min=eps) ** -0.5) @ cv.transpose(1, 2)
    color = sv @ torch.diag_embed(sw.clamp(min=eps) ** 0.5) @ sv.transpose(1, 2)
    return cf @ whiten.transpose(1, 2) @ color.transpose(1, 2) + sm


# ---------------------------------------------------------------------------
# The "3D photo stylization" stylizers (reference stylizer/stylizer.py:11-357)
# and their normalized VGG (stylizer/vgg.py:5-94). Style images are (b, h,
# w, 3) in [0, 1], point features (b, n, c).
# ---------------------------------------------------------------------------

# make_vgg's conv indices and output channels; a 2x2 pool precedes 9, 16, 29
# and 42, and the slices end (after the ReLU) at relu1_1 .. relu5_1.
NORMALIZED_VGG_CONVS = (
    (0, 3), (2, 64), (5, 64),
    (9, 128), (12, 128),
    (16, 256), (19, 256), (22, 256), (25, 256),
    (29, 512), (32, 512), (35, 512), (38, 512),
    (42, 512), (45, 512), (48, 512), (51, 512),
)
NORMALIZED_VGG_SLICE_END = (2, 9, 16, 29, 42)
NORMALIZED_VGG_POOL_BEFORE = (9, 16, 29, 42)
VGG_DIMS = (64, 128, 256, 512, 512)


class NormalizedVGG(nn.Module):
    """The 'vgg_normalised' feature net: a 1x1 input remap, then
    reflection-padded 3x3 convs with ReLU. `layer` 1..5 returns that slice's
    output (NHWC), None all five. Its convs are make_vgg's, keyed `<index>`
    as ckpts/vgg_normalised.pth (convert_normalized_vgg reads them); those
    after relu5_1 (45, 48, 51), and those after `layer`'s slice, are held
    but never run, as in the reference."""

    def __init__(self, layer=None, pool: str = "max"):
        super().__init__()
        c_in = 3
        for idx, c_out in NORMALIZED_VGG_CONVS:
            self.add_module(str(idx), nn.Conv2d(c_in, c_out, 1 if idx == 0 else 3))
            c_in = c_out
        self.layer = layer
        self.pool = F.max_pool2d if pool == "max" else F.avg_pool2d

    def forward(self, x: Tensor):
        x = x.permute(0, 3, 1, 2)
        outs = []
        for idx, _ in NORMALIZED_VGG_CONVS:
            if idx in NORMALIZED_VGG_POOL_BEFORE:
                x = self.pool(x, 2, 2)
            conv = getattr(self, str(idx))
            x = conv(x) if idx == 0 else F.relu(conv(F.pad(x, (1, 1, 1, 1), mode="reflect")))
            if idx in NORMALIZED_VGG_SLICE_END:
                outs.append(x.permute(0, 2, 3, 1))
                if self.layer == len(outs):
                    return outs[-1]
                if len(outs) == 5:
                    return outs


def _instance_norm(x: Tensor, dim: int, eps: float = 1e-5) -> Tensor:
    """F.instance_norm's statistics (biased variance) over `dim`."""
    mean = x.mean(dim=dim, keepdim=True)
    var = x.var(dim=dim, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


def adain_cs(content: Tensor, style_map: Tensor) -> Tensor:
    """The reference AdaIN module (stylizer.py:11-21): content (b, n, c)
    instance-normalized, then given the spatial mean and unbiased standard
    deviation of style_map (b, h, w, c)."""
    s_flat = style_map.reshape(style_map.shape[0], -1, style_map.shape[-1])
    n = s_flat.shape[1]
    s_mean = s_flat.mean(dim=1, keepdim=True)
    s_var = s_flat.var(dim=1, keepdim=True, unbiased=False) * (n / max(n - 1, 1))
    return _instance_norm(content, dim=1) * torch.sqrt(s_var) + s_mean


def _pointwise(conv: nn.Conv1d, x: Tensor) -> Tensor:
    """A kernel-1 Conv1d applied to (b, n, c) features."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


class MLP1d(nn.Sequential):
    """A chain of kernel-1 Conv1d's over (b, n, c) features with an
    activation between them (ReLU, or LeakyReLU(0.2) for `act="leaky"`): the
    reference's nn.Sequential layout, convs at even indices, which
    _convert_conv1d_chain reads."""

    def __init__(self, in_dim: int, dims, act: str = "relu"):
        layers = []
        for i, d in enumerate(dims):
            if i > 0:
                layers.append(nn.LeakyReLU(0.2) if act == "leaky" else nn.ReLU())
            layers.append(nn.Conv1d(in_dim, d, 1))
            in_dim = d
        super().__init__(*layers)

    def forward(self, x: Tensor) -> Tensor:
        for layer in self:
            x = _pointwise(layer, x) if isinstance(layer, nn.Conv1d) else layer(x)
        return x


class _EmbedNet(nn.Sequential):
    """The LST's embedding net, in the reference's layout (convert_lst):
    (Conv1d, ReLU) pairs, then a last Conv1d."""

    def __init__(self, dims, in_dim: int):
        layers = []
        for d in dims[:-1]:
            layers.append(nn.Sequential(nn.Conv1d(in_dim, d, 1), nn.ReLU()))
            in_dim = d
        layers.append(nn.Conv1d(in_dim, dims[-1], 1))
        super().__init__(*layers)

    def forward(self, x: Tensor) -> Tensor:
        for i in range(len(self) - 1):
            x = F.relu(_pointwise(self[i][0], x))
        return _pointwise(self[-1], x)


class LST(nn.Module):
    """Learned linear style transfer (stylizer.py:136-202): content and
    style embedded to `embed_dim`, a transform predicted from their
    covariances and applied to the zipped content. content (b, n, in_dim),
    style_map (b, h, w, in_dim) -> (b, n, in_dim)."""

    def __init__(self, in_dim: int, embed_dim: int = 32, n_layers: int = 3):
        super().__init__()
        dims, d = [], in_dim
        for _ in range(n_layers - 1):
            d = max(embed_dim, d // 2)
            dims.append(d)
        dims.append(embed_dim)
        self.c_net = _EmbedNet(dims, in_dim)
        self.s_net = _EmbedNet(dims, in_dim)
        self.c_fc = nn.Linear(embed_dim * embed_dim, embed_dim * embed_dim)
        self.s_fc = nn.Linear(embed_dim * embed_dim, embed_dim * embed_dim)
        self.c_zipper = nn.Conv1d(in_dim, embed_dim, 1)
        self.c_unzipper = nn.Conv1d(embed_dim, in_dim, 1)
        self.embed_dim = embed_dim

    def forward(self, content: Tensor, style_map: Tensor) -> Tensor:
        b, n, c = content.shape
        s = style_map.reshape(b, -1, c)
        s_mean = s.mean(dim=1, keepdim=True)
        cc = content - content.mean(dim=1, keepdim=True)
        sc = s - s_mean

        def cov_vec(x):  # (b, m, e) -> (b, e * e)
            return (x.transpose(1, 2) @ x / x.shape[1]).reshape(b, -1)

        e = self.embed_dim
        c_mat = self.c_fc(cov_vec(self.c_net(cc))).reshape(b, e, e)
        s_mat = self.s_fc(cov_vec(self.s_net(sc))).reshape(b, e, e)
        # The reference's bmm(mat, c) on (b, e, n): rows transform channels.
        z = _pointwise(self.c_zipper, cc) @ (s_mat @ c_mat).transpose(1, 2)
        return _pointwise(self.c_unzipper, z) + s_mean


class Linear3DStylizer(nn.Module):
    """LST on a VGG layer's style features (stylizer.py:203-233):
    style_image (b, h, w, 3), feats_in (b, n, VGG_DIMS[vgg_layer - 1])."""

    def __init__(self, vgg_layer: int = 3):
        super().__init__()
        self.vgg = NormalizedVGG(layer=vgg_layer)
        self.lst = LST(in_dim=VGG_DIMS[vgg_layer - 1])

    def forward(self, style_image: Tensor, feats_in: Tensor) -> Tensor:
        return self.lst(feats_in, self.vgg(style_image))


class AdaIN3DStylizer(nn.Module):
    """Learned AdaIN on point features (stylizer.py:235-284): zip, AdaIN to
    the VGG layer's style statistics, unzip. feats_in (b, n, feats_in_dim),
    by default the VGG layer's width (flax infers it)."""

    def __init__(self, vgg_layer: int = 3, n_zip_layers: int = 2, feats_in_dim=None):
        super().__init__()
        d = VGG_DIMS[vgg_layer - 1]
        self.vgg = NormalizedVGG(layer=vgg_layer)
        self.zipper = MLP1d(feats_in_dim or d, (d,) * n_zip_layers, act="leaky")
        self.unzipper = MLP1d(d, (d,) * n_zip_layers, act="leaky")

    def forward(self, style_image: Tensor, feats_in: Tensor) -> Tensor:
        return self.unzipper(adain_cs(self.zipper(feats_in), self.vgg(style_image)))


def attention_moments(qe: Tensor, ke: Tensor, se: Tensor) -> Tuple[Tensor, Tensor]:
    """The mean and second moment of the values se (b, m, v) under
    softmax(qe ke^T) with no 1/sqrt(d) scale, qe (b, n, d), ke (b, m, d):
    one scaled_dot_product_attention over the values [se, se^2], which never
    holds the (n, m) weights where a fused backend takes it."""
    out = F.scaled_dot_product_attention(qe[:, None], ke[:, None], torch.cat([se, se * se], dim=-1)[:, None],
                                         scale=1.0)[:, 0]
    return out[..., : se.shape[-1]], out[..., se.shape[-1]:]


class AdaAttN3DStylizer(nn.Module):
    """The attention-weighted AdaIN stylizer (stylizer.py:75-134 + AdaAttN
    :23-73): each point attends over the style positions, and its content
    features take the attention-weighted style mean and standard deviation.
    feats_in (b, n, feats_in_dim)."""

    def __init__(self, feats_in_dim: int, vgg_layer: int = 3, n_zip_layers: int = 2):
        super().__init__()
        v_dim = qk_dim = VGG_DIMS[vgg_layer - 1]
        self.vgg = NormalizedVGG(layer=vgg_layer)
        self.q_zipper = MLP1d(feats_in_dim, (qk_dim,) * n_zip_layers, act="leaky")
        self.v_zipper = MLP1d(feats_in_dim, (v_dim,) * n_zip_layers, act="leaky")
        self.v_unzipper = MLP1d(v_dim, (v_dim,) * n_zip_layers, act="leaky")
        # AdaAttN(project=True): 1x1 embeddings of the instance-normalized
        # query and key and of the raw style.
        self.q_embed = nn.Conv1d(qk_dim, qk_dim, 1)
        self.k_embed = nn.Conv1d(v_dim, qk_dim, 1)
        self.s_embed = nn.Conv1d(v_dim, v_dim, 1)

    def forward(self, style_image: Tensor, feats_in: Tensor) -> Tensor:
        style = self.vgg(style_image)
        s = style.reshape(style.shape[0], -1, style.shape[-1])  # (b, m, v)
        q = self.q_zipper(feats_in)
        c = self.v_zipper(feats_in)
        qe = _pointwise(self.q_embed, _instance_norm(q, dim=1))
        ke = _pointwise(self.k_embed, _instance_norm(s, dim=1))
        mean, sq_mean = attention_moments(qe, ke, _pointwise(self.s_embed, s))
        std = torch.sqrt(torch.clamp(sq_mean - mean * mean, min=0.0))
        return self.v_unzipper(_instance_norm(c, dim=1) * std + mean)
