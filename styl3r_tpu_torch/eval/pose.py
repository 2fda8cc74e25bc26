"""Two-view pose evaluation (counterpart of styl3r_tpu/eval/pose.py;
reference `src/evaluation/pose_evaluator.py`, `src/misc/cam_utils.py:152-189`,
`src/evaluation/metrics.py:56-104`): estimate the second context camera's
pose from its predicted per-pixel 3-D means by PnP inside RANSAC, refine it
photometrically through the differentiable renderer, and score rotation and
translation angle errors with AUC@{5,10,20}.

The PnP is a DLT with an SO(3) projection and a Gauss-Newton polish inside
RANSAC, in numpy (cv2 is not a dependency), drawing from
np.random.default_rng(seed) in the JAX package's order, so both packages
give the same pose from the same points. The refinement renders through
both compositor kernels on CUDA tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ..geometry.gaussians import Gaussians
from ..infer.pipeline import align_target_poses
from ..losses.ssim import ssim


# --------------------------------------------------------------------------
# PnP (DLT + Procrustes) with RANSAC
# --------------------------------------------------------------------------


def _pnp_dlt(points3d: np.ndarray, points2d_norm: np.ndarray) -> Optional[np.ndarray]:
    """Solve w2c [R|t] from >= 6 correspondences; points2d_norm are
    K^-1-normalized image coords (x, y)."""
    n = len(points3d)
    if n < 6:
        return None
    a = np.zeros((2 * n, 12))
    x, y = points2d_norm[:, 0], points2d_norm[:, 1]
    xh = np.concatenate([points3d, np.ones((n, 1))], axis=1)  # (n, 4)
    a[0::2, 0:4] = xh
    a[0::2, 8:12] = -x[:, None] * xh
    a[1::2, 4:8] = xh
    a[1::2, 8:12] = -y[:, None] * xh
    _, _, vt = np.linalg.svd(a, full_matrices=False)
    m = vt[-1].reshape(3, 4)
    # Fix sign so points are in front of the camera.
    depths = (m[2, :3] @ points3d.T) + m[2, 3]
    if np.median(depths) < 0:
        m = -m
    # Project the rotation part onto SO(3), rescale translation accordingly.
    u, s, vt2 = np.linalg.svd(m[:, :3])
    r = u @ vt2
    if np.linalg.det(r) < 0:
        u[:, -1] *= -1
        r = u @ vt2
    scale = s.mean()
    t = m[:, 3] / max(scale, 1e-12)
    w2c = np.eye(4)
    w2c[:3, :3] = r
    w2c[:3, 3] = t
    return w2c


def _refine_gauss_newton(
    w2c: np.ndarray, points3d: np.ndarray, points2d_norm: np.ndarray, iters: int = 10
) -> np.ndarray:
    """Levenberg-damped Gauss-Newton on the reprojection residual in
    normalized coords (what cv2.solvePnPRansac's final ITERATIVE refinement
    does on the inlier set) — cuts the raw DLT's noise degradation by ~10x."""
    r = w2c[:3, :3].copy()
    t = w2c[:3, 3].copy()
    lam = 1e-6
    for _ in range(iters):
        cam = points3d @ r.T + t  # (n, 3)
        z = np.clip(cam[:, 2], 1e-8, None)
        u = cam[:, :2] / z[:, None]
        res = (u - points2d_norm).reshape(-1)  # (2n,)
        n = len(points3d)
        # d u / d cam
        j_u = np.zeros((n, 2, 3))
        inv_z = 1.0 / z
        j_u[:, 0, 0] = inv_z
        j_u[:, 0, 2] = -cam[:, 0] * inv_z**2
        j_u[:, 1, 1] = inv_z
        j_u[:, 1, 2] = -cam[:, 1] * inv_z**2
        # d cam / d (omega, dt): left perturbation cam' = exp(w) cam + dt.
        j_cam = np.zeros((n, 3, 6))
        px, py, pz = cam[:, 0], cam[:, 1], cam[:, 2]
        # -[p]x
        j_cam[:, 0, 1] = pz
        j_cam[:, 0, 2] = -py
        j_cam[:, 1, 0] = -pz
        j_cam[:, 1, 2] = px
        j_cam[:, 2, 0] = py
        j_cam[:, 2, 1] = -px
        j_cam[:, :, 3:] = np.eye(3)
        jac = np.einsum("nij,njk->nik", j_u, j_cam).reshape(-1, 6)  # (2n, 6)
        h = jac.T @ jac + lam * np.eye(6)
        g = jac.T @ res
        try:
            delta = -np.linalg.solve(h, g)
        except np.linalg.LinAlgError:
            break
        omega, dt = delta[:3], delta[3:]
        angle = np.linalg.norm(omega)
        if angle < 1e-12:
            rot = np.eye(3)
        else:
            axis = omega / angle
            kx = np.asarray(
                [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
            )
            rot = np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx
        r = rot @ r
        t = rot @ t + dt
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = t
    return out


def pnp_ransac(
    points3d: np.ndarray,
    pixels: np.ndarray,
    k_pixels: np.ndarray,
    iterations: int = 100,
    reprojection_error: float = 5.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """PnP with RANSAC. pixels in pixel units; k_pixels is the pixel-unit K.
    Returns (c2w pose, inlier mask)."""
    rng = np.random.default_rng(seed)
    k_inv = np.linalg.inv(k_pixels)
    pts_h = np.concatenate([pixels, np.ones((len(pixels), 1))], axis=1)
    norm2d = (k_inv @ pts_h.T).T[:, :2]

    def reproject_errors(w2c):
        cam = (w2c[:3, :3] @ points3d.T).T + w2c[:3, 3]
        z = np.clip(cam[:, 2], 1e-8, None)
        proj = (k_pixels @ (cam / z[:, None]).T).T[:, :2]
        return np.linalg.norm(proj - pixels, axis=1)

    best_inliers = None
    best_count = -1
    n = len(points3d)
    for _ in range(iterations):
        sample = rng.choice(n, size=min(6, n), replace=False)
        w2c = _pnp_dlt(points3d[sample], norm2d[sample])
        if w2c is None:
            continue
        errors = reproject_errors(w2c)
        inliers = errors < reprojection_error
        count = int(inliers.sum())
        if count > best_count:
            best_count = count
            best_inliers = inliers
    if best_inliers is None or best_count < 6:
        best_inliers = np.ones(n, bool)
    # Final fit on all inliers + Gauss-Newton polish (re-gating inliers once,
    # as cv2's ITERATIVE refinement effectively does).
    w2c = _pnp_dlt(points3d[best_inliers], norm2d[best_inliers])
    if w2c is None:
        w2c = np.eye(4)
    for _ in range(2):
        w2c = _refine_gauss_newton(
            w2c, points3d[best_inliers], norm2d[best_inliers]
        )
        refreshed = reproject_errors(w2c) < reprojection_error
        if refreshed.sum() >= 6:
            best_inliers = refreshed
    return np.linalg.inv(w2c).astype(np.float32), best_inliers


def pnp_pose_from_gaussians(
    pts3d: np.ndarray,  # (h, w, 3) predicted means of the second view
    opacity: np.ndarray,  # (h, w)
    intrinsics_norm: np.ndarray,  # (3, 3) normalized
    opacity_threshold: float = 0.3,
    max_points: int = 4096,
    seed: int = 0,
) -> np.ndarray:
    """The reference's get_pnp_pose (cam_utils.py:152-174): solve the camera
    of view 2 from its per-pixel predicted 3D means."""
    h, w = opacity.shape
    k = intrinsics_norm.copy()
    k[0] *= w
    k[1] *= h
    ys, xs = np.mgrid[0:h, 0:w]
    pixels = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float64)
    pts = pts3d.reshape(-1, 3).astype(np.float64)
    mask = opacity.reshape(-1) > opacity_threshold
    if mask.sum() < 6:
        mask = np.ones(len(pts), bool)
    idx = np.nonzero(mask)[0]
    if len(idx) > max_points:
        idx = np.random.default_rng(seed).choice(idx, max_points, replace=False)
    pose, _ = pnp_ransac(pts[idx], pixels[idx], k, seed=seed)
    return pose


# --------------------------------------------------------------------------
# Pose error metrics + AUC
# --------------------------------------------------------------------------


def rotation_angle_deg(r1: np.ndarray, r2: np.ndarray) -> float:
    cos = (np.trace(r1.T @ r2) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def translation_angle_deg(t1: np.ndarray, t2: np.ndarray) -> float:
    n1, n2 = np.linalg.norm(t1), np.linalg.norm(t2)
    if n1 < 1e-9 or n2 < 1e-9:
        return 0.0
    cos = np.dot(t1, t2) / (n1 * n2)
    return float(np.degrees(np.arccos(np.clip(abs(cos), -1.0, 1.0))))


def pose_error_deg(pred_c2w: np.ndarray, gt_c2w: np.ndarray) -> Tuple[float, float]:
    r_err = rotation_angle_deg(pred_c2w[:3, :3], gt_c2w[:3, :3])
    t_err = translation_angle_deg(pred_c2w[:3, 3], gt_c2w[:3, 3])
    return r_err, t_err


def pose_auc(errors, thresholds=(5, 10, 20)) -> Dict[int, float]:
    """AUC of the recall curve at error thresholds (cam_utils.py:177-189)."""
    errors = np.sort(np.asarray(errors, np.float64))
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.concatenate([[0.0], errors])
    recall = np.concatenate([[0.0], recall])
    aucs = {}
    for t in thresholds:
        last = np.searchsorted(errors, t)
        r = np.concatenate([recall[:last], [recall[last - 1]]])
        e = np.concatenate([errors[:last], [t]])
        aucs[t] = float(np.trapezoid(r, x=e) / t)
    return aucs


# --------------------------------------------------------------------------
# Photometric refinement
# --------------------------------------------------------------------------


def photometric_loss(pred: Tensor, target: Tensor) -> Tensor:
    """The refinement's loss of one (h, w, 3) render against its target:
    mean squared error + 0.2 * (1 - SSIM) (pose_evaluator.py:84-147)."""
    return ((pred - target) ** 2).mean() + 0.2 * (1.0 - ssim(pred, target))


def refine_pose_photometric(
    gaussians: Gaussians,
    init_c2w: Tensor,  # (4, 4)
    intrinsics: Tensor,  # (3, 3) normalized
    target_image: Tensor,  # (h, w, 3)
    near: float,
    far: float,
    steps: int = 200,
    rot_lr: float = 3e-3,
    trans_lr: float = 1e-3,
    **render_kwargs,
) -> Tensor:
    """`steps` Adam steps on one camera's SE3 deltas through the renderer,
    each baked into the pose (infer/pipeline.py::align_target_poses, with
    photometric_loss on the render); returns the refined (4, 4) c2w. Each
    step launches each compositor kernel once on CUDA tensors."""
    dev, dtype = init_c2w.device, init_c2w.dtype
    ext = align_target_poses(
        gaussians, init_c2w[None, None], intrinsics[None, None],
        torch.full((1, 1), near, dtype=dtype, device=dev), torch.full((1, 1), far, dtype=dtype, device=dev),
        target_image, tuple(target_image.shape[:2]), steps=steps, rot_lr=rot_lr, trans_lr=trans_lr,
        loss_fn=lambda out, target: photometric_loss(out.color[0, 0], target), **render_kwargs,
    )
    return ext[0, 0]
