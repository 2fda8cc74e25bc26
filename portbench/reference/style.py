"""[Frozen copy of styl3r_tpu_torch/losses/style.py, the benchmark's reference: it
imports nothing of the program.]

Style and identity losses over VGG19 features (counterpart of
styl3r_tpu/losses/style.py; reference `src/loss/loss_style.py:35-80` and
`src/loss/loss_identity.py`).

  * style: content = MSE on relu3_1 + relu4_1 (pred vs GT target views);
    style = MSE of the channel-wise mean and std of every slice (pred vs
    style image); total = content + style_weight * style.
  * identity (style := context view 0): 70 * pixel MSE + 1 * the sum of the
    feature MSEs over all four slices.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from torch import Tensor

from .vgg import imagenet_normalize


def calc_mean_std(feat: Tensor, eps: float = 1e-8) -> Tuple[Tensor, Tensor]:
    """Channel-wise spatial mean and std of NHWC features; the std is
    unbiased (ddof 1, as torch.std), plus eps."""
    n, h, w, c = feat.shape
    flat = feat.reshape(n, h * w, c)
    return flat.mean(dim=1), flat.std(dim=1, correction=1) + eps


def style_loss(
    vgg: Callable[[Tensor], List[Tensor]],
    pred: Tensor,
    target: Tensor,
    style: Tensor,
    style_weight: float = 10.0,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """vgg: NHWC (ImageNet-normalized) -> 4 features. pred/target:
    (b, v, h, w, 3) renders and GT in [0, 1]; style: (b, hs, ws, 3)."""
    b, v = pred.shape[:2]
    pred_f = vgg(imagenet_normalize(pred.reshape(b * v, *pred.shape[2:])))
    target_f = vgg(imagenet_normalize(target.reshape(b * v, *target.shape[2:])))
    style_rep = style[:, None].expand(b, v, *style.shape[1:]).reshape(b * v, *style.shape[1:])
    style_f = vgg(imagenet_normalize(style_rep))

    content = ((pred_f[-2] - target_f[-2]) ** 2).mean() + ((pred_f[-1] - target_f[-1]) ** 2).mean()
    style_total = 0.0
    for pf, sf in zip(pred_f, style_f):
        pm, ps = calc_mean_std(pf)
        sm, ss = calc_mean_std(sf)
        style_total = style_total + ((pm - sm) ** 2).mean() + ((ps - ss) ** 2).mean()
    loss = content + style_weight * style_total
    return loss, {"style_content": content, "style_stats": style_total}


def identity_loss(
    vgg: Callable[[Tensor], List[Tensor]],
    pred: Tensor,
    target: Tensor,
    weight_1: float = 70.0,
    weight_2: float = 1.0,
) -> Tensor:
    """Renders with style := context view 0 must reconstruct the GT target
    views."""
    b, v = pred.shape[:2]
    pred_flat = pred.reshape(b * v, *pred.shape[2:])
    target_flat = target.reshape(b * v, *target.shape[2:])
    pixel = ((pred_flat - target_flat) ** 2).mean()
    pred_f = vgg(imagenet_normalize(pred_flat))
    target_f = vgg(imagenet_normalize(target_flat))
    feat = 0.0
    for pf, tf in zip(pred_f, target_f):
        feat = feat + ((pf - tf) ** 2).mean()
    return weight_1 * pixel + weight_2 * feat
