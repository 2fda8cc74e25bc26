"""[Frozen copy of styl3r_tpu_torch/losses/regr3d.py, the benchmark's reference: it
imports nothing of the program.]

Regr3D distillation loss (counterpart of styl3r_tpu/losses/regr3d.py;
reference `src/loss/loss_point.py:188-255`).

L2 between predicted and teacher point maps over the valid points: a point
is valid when its teacher distance lies within the per-batch quantiles
[0.002, 0.998] of its view and the teacher's confidence is >= 3. With
`normalize`, both sides are scaled by their average distance over the valid
points (normalize_pointcloud's 'avg_dis' mode).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor


def normalize_pointcloud_avg_dis(
    pts1: Tensor, pts2: Tensor, valid1: Tensor, valid2: Tensor, eps: float = 1e-8
) -> Tuple[Tensor, Tensor]:
    """Scale both views' points by the mean distance to the origin over the
    valid points, per batch element."""
    d1 = torch.linalg.norm(pts1, dim=-1)
    d2 = torch.linalg.norm(pts2, dim=-1)
    total = (d1 * valid1).sum(dim=(1, 2)) + (d2 * valid2).sum(dim=(1, 2))
    count = valid1.sum(dim=(1, 2)) + valid2.sum(dim=(1, 2))
    norm = total / torch.clamp(count, min=1.0)
    norm = torch.clamp(norm, min=eps)[:, None, None, None]
    return pts1 / norm, pts2 / norm


def quantile(flat: Tensor, q: float) -> Tensor:
    """Row-wise linear-interpolation quantile of a (b, n) f32 tensor, rounded
    as XLA rounds jnp.quantile on the CPU: position q * (n - 1) in f32, then
    low * (1 - frac) fused (one rounding) with the rounded high * frac. Where
    low and high tie, a plain f32 interpolation can land an ulp off the tied
    value and so flip the tied points across the `>=` / `<=` of the mask. A
    row with a NaN gives NaN. (torch.quantile rounds otherwise and refuses
    inputs of more than 2^24 elements.)"""
    n = flat.shape[1]
    s = torch.sort(flat, dim=1).values
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_weight = float(pos - low)
    low_weight = float(torch.tensor(1.0) - (pos - low))
    lo, hi = int(torch.clamp(low, 0, n - 1)), int(torch.clamp(high, 0, n - 1))
    # The f32 product low * low_weight is exact in f64: an FMA's one rounding.
    out = (s[:, lo].double() * low_weight + (s[:, hi] * high_weight).double()).float()
    return torch.where(torch.isnan(flat).any(dim=1), torch.full_like(out, float("nan")), out)


def _quantile_mask(pts: Tensor, lo: float = 0.002, hi: float = 0.998) -> Tensor:
    dis = torch.linalg.norm(pts, dim=-1)  # (b, h, w)
    flat = dis.reshape(dis.shape[0], -1)
    qlo = quantile(flat, lo)[:, None, None]
    qhi = quantile(flat, hi)[:, None, None]
    return (dis >= qlo) & (dis <= qhi)


def regr3d_loss(
    gt_pts1: Tensor,  # (b, h, w, 3) teacher view-1 points
    gt_pts2: Tensor,
    pr_pts1: Tensor,
    pr_pts2: Tensor,
    conf1: Optional[Tensor] = None,  # (b, h, w) teacher confidences
    conf2: Optional[Tensor] = None,
    conf_threshold: float = 3.0,
    normalize: bool = True,
    disable_view1: bool = False,
    data=None,
) -> Tensor:
    """With `data` (a parallel/mesh.py DataGroup), the points are this rank's
    rows of a global batch split over data.world ranks: each view's mean is
    over the global batch's valid points, as in one process. Each rank
    divides its sum by the global count (the counts come from the teacher's
    masks and carry no gradient) and scales by W, so that the ranks' mean
    loss and averaged gradient are the global batch's; a per-rank ratio
    averaged over the ranks would be another loss."""
    valid1 = _quantile_mask(gt_pts1)
    valid2 = _quantile_mask(gt_pts2)
    if conf1 is not None:
        valid1 = valid1 & (conf1 >= conf_threshold)
    if conf2 is not None:
        valid2 = valid2 & (conf2 >= conf_threshold)
    v1, v2 = valid1.float(), valid2.float()

    if normalize:
        pr_pts1, pr_pts2 = normalize_pointcloud_avg_dis(pr_pts1, pr_pts2, v1, v2)
        gt_pts1, gt_pts2 = normalize_pointcloud_avg_dis(gt_pts1, gt_pts2, v1, v2)

    loss1 = torch.linalg.norm(pr_pts1 - gt_pts1, dim=-1)
    loss2 = torch.linalg.norm(pr_pts2 - gt_pts2, dim=-1)
    counts, scale = torch.stack([v1.sum(), v2.sum()]), 1.0
    if data is not None:
        counts, scale = data.all_reduce_(counts), float(data.world)
    counts = torch.clamp(counts, min=1.0)
    mean1 = scale * (loss1 * v1).sum() / counts[0]
    mean2 = scale * (loss2 * v2).sum() / counts[1]
    if disable_view1:
        return mean2
    return mean1 + mean2
