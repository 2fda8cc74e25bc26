"""Point-cloud geometry (counterpart of styl3r_tpu/geometry/ptc_geometry.py;
reference src/geometry/ptc_geometry.py).

The DUSt3R point-map helpers: geometric transforms (geotrf), depth-map
unprojection, joint point-cloud normalization in the reference's norm modes,
and the COLMAP/OpenCV intrinsics shims. Masked means and quantiles stand in
for the reference's NaN-based reductions, as in the JAX module: invalid
entries get weight 0, which gives the same result on the valid set.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor


def geotrf(trf: Tensor, pts: Tensor, ncol: Optional[int] = None, norm: float = 0.0) -> Tensor:
    """Apply a (batched) transform trf (..., d, d) or (..., d+1, d+1) to
    points (..., d); `norm` != 0 projects onto the z=norm plane."""
    d = pts.shape[-1]
    if trf.shape[-1] == d:
        out = torch.einsum("...ij,...j->...i", trf, pts)
    elif trf.shape[-1] == d + 1:
        out = torch.einsum("...ij,...j->...i", trf[..., :d, :d], pts) + trf[..., :d, d]
    else:
        raise ValueError(f"transform {tuple(trf.shape)} incompatible with points {tuple(pts.shape)}")
    if norm:
        out = out / out[..., -1:]
        if norm != 1:
            out = out * norm
    if ncol is not None:
        out = out[..., :ncol]
    return out


def depthmap_to_camera_coordinates(depthmap: Tensor, intrinsics: Tensor) -> Tuple[Tensor, Tensor]:
    """(h, w) depth + pixel-unit (3, 3) K -> camera-frame (h, w, 3) points and
    the validity mask z > 0 (pinhole, no distortion)."""
    h, w = depthmap.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    v, u = torch.meshgrid(
        torch.arange(h, device=depthmap.device), torch.arange(w, device=depthmap.device), indexing="ij"
    )
    z = depthmap
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    return torch.stack([x, y, z], dim=-1), z > 0.0


def depthmap_to_absolute_camera_coordinates(
    depthmap: Tensor, intrinsics: Tensor, camera_pose: Tensor
) -> Tuple[Tensor, Tensor]:
    """The same, then into world coordinates with the (4, 4) c2w pose."""
    pts_cam, valid = depthmap_to_camera_coordinates(depthmap, intrinsics)
    return geotrf(camera_pose, pts_cam), valid


def colmap_to_opencv_intrinsics(k: Tensor) -> Tensor:
    """COLMAP's integer-corner origin -> OpenCV's pixel-center origin."""
    out = k.clone()
    out[..., :2, 2] -= 0.5
    return out


def opencv_to_colmap_intrinsics(k: Tensor) -> Tensor:
    out = k.clone()
    out[..., :2, 2] += 0.5
    return out


def _masked(pts: Tensor, valid: Optional[Tensor]) -> Tensor:
    if valid is None:
        return torch.ones(pts.shape[:-1], dtype=torch.float32, device=pts.device)
    return valid.float()


def _masked_quantile(values: Tensor, weights: Tensor, q: float) -> Tensor:
    """Per-batch weighted quantile over the flattened values (invalid entries
    weigh 0): the first sorted value whose cumulative weight reaches
    q * total, as nanquantile's lower value on the valid subset."""
    b = values.shape[0]
    v = values.reshape(b, -1)
    w = weights.reshape(b, -1)
    v_sorted, order = torch.sort(v, dim=1, stable=True)
    cum = torch.cumsum(torch.gather(w, 1, order), dim=1)
    target = q * cum[:, -1:]
    idx = torch.clamp((cum < target).sum(dim=1), 0, v.shape[1] - 1)
    return torch.gather(v_sorted, 1, idx[:, None])[:, 0]


def normalize_pointcloud(
    pts1: Tensor,
    pts2: Optional[Tensor] = None,
    norm_mode: str = "avg_dis",
    valid1: Optional[Tensor] = None,
    valid2: Optional[Tensor] = None,
):
    """Joint point-map normalization. Modes: avg_dis (Regr3D's), avg_log1p,
    median_dis (its scale detached, as the reference's nanmedian), sqrt_dis."""
    mode, dis_mode = norm_mode.split("_")
    b = pts1.shape[0]
    d1 = torch.linalg.norm(pts1, dim=-1)
    w1 = _masked(pts1, valid1)
    if pts2 is not None:
        d2 = torch.linalg.norm(pts2, dim=-1)
        w2 = _masked(pts2, valid2)
        dis = torch.cat([d1.reshape(b, -1), d2.reshape(b, -1)], dim=1)
        wts = torch.cat([w1.reshape(b, -1), w2.reshape(b, -1)], dim=1)
    else:
        dis, wts = d1.reshape(b, -1), w1.reshape(b, -1)

    if mode == "avg":
        if dis_mode == "log1p":
            dis = torch.log1p(dis)
        elif dis_mode != "dis":
            raise ValueError(f"unsupported dis mode: {dis_mode}")
        norm_factor = (dis * wts).sum(dim=1) / (wts.sum(dim=1) + 1e-8)
    elif mode == "median":
        norm_factor = _masked_quantile(dis, wts, 0.5).detach()
    elif mode == "sqrt":
        norm_factor = ((torch.sqrt(dis) * wts).sum(dim=1) / (wts.sum(dim=1) + 1e-8)) ** 2
    else:
        raise ValueError(f"unsupported norm mode: {mode}")

    norm_factor = torch.clamp(norm_factor, min=1e-8).reshape((b,) + (1,) * (pts1.ndim - 1))
    if pts2 is not None:
        return pts1 / norm_factor, pts2 / norm_factor
    return pts1 / norm_factor


def get_joint_pointcloud_depth(
    z1: Tensor,
    z2: Optional[Tensor] = None,
    valid_mask1: Optional[Tensor] = None,
    valid_mask2: Optional[Tensor] = None,
    quantile: float = 0.5,
) -> Tensor:
    """Per-batch joint depth quantile over the valid pixels."""
    b = z1.shape[0]
    w1 = valid_mask1.float() if valid_mask1 is not None else torch.ones_like(z1)
    z, w = z1.reshape(b, -1), w1.reshape(b, -1)
    if z2 is not None:
        w2 = valid_mask2.float() if valid_mask2 is not None else torch.ones_like(z2)
        z = torch.cat([z, z2.reshape(b, -1)], dim=1)
        w = torch.cat([w, w2.reshape(b, -1)], dim=1)
    return _masked_quantile(z, w, quantile)


def get_joint_pointcloud_center_scale(
    pts1: Tensor,
    pts2: Optional[Tensor] = None,
    valid_mask1: Optional[Tensor] = None,
    valid_mask2: Optional[Tensor] = None,
    z_only: bool = False,
    center: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Median center and median distance scale of the joint cloud. Returns
    (center (b, 1, 1, 3), scale (b, 1, 1, 1))."""
    b = pts1.shape[0]
    p = pts1.reshape(b, -1, 3)
    w = _masked(pts1, valid_mask1).reshape(b, -1)
    if pts2 is not None:
        p = torch.cat([p, pts2.reshape(b, -1, 3)], dim=1)
        w = torch.cat([w, _masked(pts2, valid_mask2).reshape(b, -1)], dim=1)
    c = torch.stack([_masked_quantile(p[..., i], w, 0.5) for i in range(3)], dim=-1)
    if z_only:
        c = torch.cat([torch.zeros_like(c[..., :2]), c[..., 2:]], dim=-1)
    ref = p - c[:, None, :] if center else p
    scale = _masked_quantile(torch.linalg.norm(ref, dim=-1), w, 0.5)
    return c[:, None, None, :], scale[:, None, None, None]
