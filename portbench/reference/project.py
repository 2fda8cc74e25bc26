"""[Frozen copy of styl3r_tpu_torch/ops/rasterizer/project.py, the benchmark's reference: it
imports nothing of the program.]

EWA projection of 3D Gaussians to screen space, and SH colors
(counterpart of styl3r_tpu/ops/rasterizer/project.py).

Convention: pixel (i, j) has center (x=j, y=i), so
mean2d_x = fx_px * tx/tz + cx_px - 0.5. Every function takes leading batch
dims: a camera with fields (n, ...) projects means (n, g, 3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from .gaussians import covariance_components
from .camera import RasterCamera


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussians as (..., g)-shaped component tensors."""

    mean_x: Tensor  # pixel x
    mean_y: Tensor  # pixel y
    depths: Tensor  # camera-space z
    con_a: Tensor  # inverse 2D covariance (a, b, c) of a x^2 + 2 b x y + c y^2
    con_b: Tensor
    con_c: Tensor
    radii: Tensor  # 3-sigma screen radius in pixels (0 = culled)
    mask: Tensor  # bool: survives the near-plane / degenerate cull


NEAR_CULL = 0.2  # the CUDA rasterizer's hardcoded near threshold
COV_BLUR = 0.3  # low-pass floor added to the 2D covariance diagonal


def project_gaussians(
    camera: RasterCamera,
    means: Tensor,
    covariances: Optional[Tensor] = None,
    scales: Optional[Tensor] = None,
    rotations: Optional[Tensor] = None,
) -> ProjectedGaussians:
    """Project world-space Gaussians (..., g, 3) through cameras with
    matching leading dims; the covariance comes from `covariances`
    (..., g, 3, 3) or from the factors `scales` (..., g, 3) and xyzw
    `rotations` (..., g, 4)."""

    def cam(x: Tensor) -> Tensor:  # camera scalar -> broadcast over g
        return x[..., None]

    rot = camera.w2c[..., :3, :3]
    trans = camera.w2c[..., :3, 3]
    r = [[cam(rot[..., i, j]) for j in range(3)] for i in range(3)]
    wx, wy, wz = means[..., 0], means[..., 1], means[..., 2]
    tx = r[0][0] * wx + r[0][1] * wy + r[0][2] * wz + cam(trans[..., 0])
    ty = r[1][0] * wx + r[1][1] * wy + r[1][2] * wz + cam(trans[..., 1])
    tz = r[2][0] * wx + r[2][1] * wy + r[2][2] * wz + cam(trans[..., 2])

    fx, fy = cam(camera.focal[..., 0]), cam(camera.focal[..., 1])
    tan_x, tan_y = cam(camera.tan_fov[..., 0]), cam(camera.tan_fov[..., 1])

    # Clamp the camera-space x/y used for the Jacobian to 1.3x the frustum.
    safe_z = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    lim_x, lim_y = 1.3 * tan_x, 1.3 * tan_y
    txz = torch.clamp(tx / safe_z, -lim_x, lim_x) * safe_z
    tyz = torch.clamp(ty / safe_z, -lim_y, lim_y) * safe_z

    inv_z = 1.0 / safe_z
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z2

    m00 = j00 * r[0][0] + j02 * r[2][0]
    m01 = j00 * r[0][1] + j02 * r[2][1]
    m02 = j00 * r[0][2] + j02 * r[2][2]
    m10 = j11 * r[1][0] + j12 * r[2][0]
    m11 = j11 * r[1][1] + j12 * r[2][1]
    m12 = j11 * r[1][2] + j12 * r[2][2]

    if covariances is not None:
        s00 = covariances[..., 0, 0]
        s01 = covariances[..., 0, 1]
        s02 = covariances[..., 0, 2]
        s11 = covariances[..., 1, 1]
        s12 = covariances[..., 1, 2]
        s22 = covariances[..., 2, 2]
    else:
        s00, s01, s02, s11, s12, s22 = covariance_components(scales, rotations)
    u0x = s00 * m00 + s01 * m01 + s02 * m02
    u0y = s01 * m00 + s11 * m01 + s12 * m02
    u0z = s02 * m00 + s12 * m01 + s22 * m02
    a = m00 * u0x + m01 * u0y + m02 * u0z + COV_BLUR
    b = m10 * u0x + m11 * u0y + m12 * u0z
    u1x = s00 * m10 + s01 * m11 + s02 * m12
    u1y = s01 * m10 + s11 * m11 + s12 * m12
    u1z = s02 * m10 + s12 * m11 + s22 * m12
    c = m10 * u1x + m11 * u1y + m12 * u1z + COV_BLUR

    det = a * c - b * b
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))

    mean_x = fx * tx * inv_z + cam(camera.principal[..., 0]) - 0.5
    mean_y = fy * ty * inv_z + cam(camera.principal[..., 1]) - 0.5

    valid = (tz > NEAR_CULL) & (det > 0)
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return ProjectedGaussians(
        mean_x=mean_x,
        mean_y=mean_y,
        depths=tz,
        con_a=c / det_safe,
        con_b=-b / det_safe,
        con_c=a / det_safe,
        radii=radius,
        mask=valid,
    )


SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def eval_sh(harmonics: Tensor, directions: Tensor) -> Tensor:
    """SH color per Gaussian: (..., 3, d_sh), (..., 3) -> (..., 3) RGB,
    + 0.5 and clamped at 0 (the CUDA computeColorFromSH), degrees 0-3."""
    d_sh = harmonics.shape[-1]
    result = SH_C0 * harmonics[..., 0]
    if d_sh > 1:
        x = directions[..., 0:1]
        y = directions[..., 1:2]
        z = directions[..., 2:3]
        result = (
            result
            - SH_C1 * y * harmonics[..., 1]
            + SH_C1 * z * harmonics[..., 2]
            - SH_C1 * x * harmonics[..., 3]
        )
        if d_sh > 4:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * harmonics[..., 4]
                + SH_C2[1] * yz * harmonics[..., 5]
                + SH_C2[2] * (2.0 * zz - xx - yy) * harmonics[..., 6]
                + SH_C2[3] * xz * harmonics[..., 7]
                + SH_C2[4] * (xx - yy) * harmonics[..., 8]
            )
            if d_sh > 9:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * harmonics[..., 9]
                    + SH_C3[1] * xy * z * harmonics[..., 10]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * harmonics[..., 11]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * harmonics[..., 12]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * harmonics[..., 13]
                    + SH_C3[5] * z * (xx - yy) * harmonics[..., 14]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * harmonics[..., 15]
                )
    return torch.clamp(result + 0.5, min=0.0)
