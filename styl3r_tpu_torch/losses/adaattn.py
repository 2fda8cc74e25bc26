"""The AdaAttN-style alternative stylization loss (counterpart of
styl3r_tpu/losses/adaattn.py; reference `src/loss/loss_adaattn.py`, unused
by the release configs): a VGG content loss against target features
normalized toward the style by AdaIN or AdaAttN, plus a style loss over
channel mean / std / Gram statistics.

AdaAttN (Liu et al., ICCV 2021) gives each content position the
attention-weighted mean and standard deviation of the style features.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
from torch import Tensor

from ..models.stylizers import adain
from .vgg import imagenet_normalize


def adaattn_transform(q: Tensor, k: Tensor, content: Tensor, style: Tensor, eps: float = 1e-8) -> Tensor:
    """Attention-weighted AdaIN of NHWC features: q and k are the query and
    key stacks (instance-normalized here), content and style the values.
    The softmax has a 1/sqrt(d) scale and `eps` in its denominator."""
    b, hc, wc, c = content.shape
    hs, ws = style.shape[1:3]

    def inorm(x):
        mean = x.mean(dim=(1, 2), keepdim=True)
        std = x.std(dim=(1, 2), keepdim=True, unbiased=False) + eps
        return (x - mean) / std

    qf = inorm(q).reshape(b, hc * wc, -1)
    kf = inorm(k).reshape(b, hs * ws, -1)
    attn = qf @ kf.transpose(1, 2) / qf.shape[-1] ** 0.5
    attn = torch.exp(attn - attn.amax(dim=-1, keepdim=True))
    attn = attn / (attn.sum(dim=-1, keepdim=True) + eps)

    sv = style.reshape(b, hs * ws, c)
    mean = attn @ sv
    second = attn @ (sv * sv)
    std = torch.sqrt(torch.clamp(second - mean * mean, min=0.0)) + eps

    cf = content.reshape(b, hc * wc, c)
    c_mean = cf.mean(dim=1, keepdim=True)
    c_std = cf.std(dim=1, keepdim=True, unbiased=False) + eps
    return (std * (cf - c_mean) / c_std + mean).reshape(b, hc, wc, c)


def gram_matrix(feat: Tensor) -> Tensor:
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    return flat.transpose(1, 2) @ flat / (c * h * w)


def adaattn_loss(
    vgg_apply: Callable[[Tensor], List[Tensor]],
    pred: Tensor,  # (b, v, h, w, 3) in [0, 1]
    target: Tensor,
    style: Tensor,  # (b, hs, ws, 3)
    content_layers: Sequence[int] = (3, 4),
    style_layers: Sequence[int] = (1, 2, 3),
    style_stats: Sequence[str] = ("mean", "gram"),
    lam: float = 1.0,
    norm: str = "adain",
) -> Tuple[Tensor, dict]:
    """Content: L1 between the prediction's features and the target's
    style-normalized ones; style: MSE of the requested statistics. Layers
    are 1-based VGG19Features slices (relu1_1 .. relu4_1)."""
    b, v = pred.shape[:2]

    def flat(x):
        return x.reshape(b * v, *x.shape[2:])

    pred_f = vgg_apply(imagenet_normalize(flat(pred)))
    tgt_f = vgg_apply(imagenet_normalize(flat(target)))
    sty_f = vgg_apply(imagenet_normalize(flat(style[:, None].expand(b, v, *style.shape[1:]))))

    content = 0.0
    for layer in content_layers:
        if layer - 1 >= len(pred_f):
            continue
        p, c, s = pred_f[layer - 1], tgt_f[layer - 1], sty_f[layer - 1]
        if norm == "adain":
            c = adain(c, s)
        elif norm == "adaattn":
            c = adaattn_transform(c, s, c, s)
        content = content + (p - c).abs().mean()

    style_total = 0.0
    for layer in style_layers:
        p, s = pred_f[layer - 1], sty_f[layer - 1]
        if "mean" in style_stats:
            style_total = style_total + ((p.mean(dim=(1, 2)) - s.mean(dim=(1, 2))) ** 2).mean()
        if "std" in style_stats:
            p_std = p.std(dim=(1, 2), unbiased=False)
            style_total = style_total + ((p_std - s.std(dim=(1, 2), unbiased=False)) ** 2).mean()
        if "gram" in style_stats:
            style_total = style_total + ((gram_matrix(p) - gram_matrix(s)) ** 2).mean()

    loss = content + lam * style_total
    return loss, {"adaattn_content": content, "adaattn_style": style_total}
