"""3D Gaussian primitives (counterpart of styl3r_tpu/geometry/gaussians.py).

Quaternions are xyzw, as in the JAX package and the reference
(`src/model/encoder/common/gaussians.py:8-45`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor


class Gaussians(NamedTuple):
    """A batch of 3D Gaussians.

    Shapes (leading batch dims are free):
      means:       [..., g, 3]
      covariances: [..., g, 3, 3]
      harmonics:   [..., g, 3, d_sh]
      opacities:   [..., g]
      scales:      [..., g, 3]   (optional)
      rotations:   [..., g, 4]   (optional; xyzw quaternions)
    """

    means: Tensor
    covariances: Tensor
    harmonics: Tensor
    opacities: Tensor
    scales: Optional[Tensor] = None
    rotations: Optional[Tensor] = None


def _rotation_entries(q: Tensor, eps: float = 1e-8):
    """The 9 entries of R(q) for unnormalized xyzw quaternions (2/|q|^2)."""
    i, j, k, r = q.unbind(-1)
    two_s = 2.0 / ((q * q).sum(-1) + eps)
    return (
        1 - two_s * (j * j + k * k),
        two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r),
        1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r),
        two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    )


def quat_to_rotmat(quat_xyzw: Tensor, eps: float = 1e-8) -> Tensor:
    """xyzw quaternions -> (..., 3, 3) rotation matrices."""
    rot = torch.stack(_rotation_entries(quat_xyzw, eps), dim=-1)
    return rot.reshape(*rot.shape[:-1], 3, 3)


def covariance_components(scales: Tensor, rotations_xyzw: Tensor):
    """The 6 unique components (c00, c01, c02, c11, c12, c22) of
    Σ = R S Sᵀ Rᵀ as (...)-shaped tensors."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _rotation_entries(rotations_xyzw)
    s0 = scales[..., 0] ** 2
    s1 = scales[..., 1] ** 2
    s2 = scales[..., 2] ** 2
    c00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    c01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    c02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    c11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    c12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    c22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return c00, c01, c02, c11, c12, c22


def build_covariance(scales: Tensor, rotations_xyzw: Tensor) -> Tensor:
    """World-space covariance Σ = R S Sᵀ Rᵀ, (..., 3, 3)."""
    c00, c01, c02, c11, c12, c22 = covariance_components(scales, rotations_xyzw)
    cov = torch.stack([c00, c01, c02, c01, c11, c12, c02, c12, c22], dim=-1)
    return cov.reshape(*cov.shape[:-1], 3, 3)


def quat_mul_xyzw(q1: Tensor, q2: Tensor) -> Tensor:
    """Hamilton product q1 ⊗ q2 of xyzw quaternions: the rotation by q2,
    then by q1."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def rotmat_to_quat_xyzw(rot: Tensor) -> Tensor:
    """(..., 3, 3) rotation matrices -> unit xyzw quaternions (branchless
    Shepperd): all four candidates are computed, and each element takes the
    one whose seed (1 ± the diagonal entries) is largest. A tie (a 90°
    rotation about an axis: tx == tw) goes to the first seed, as jnp.argmax
    breaks it, and the seeds are summed in the JAX package's order, so both
    pick the same candidate and sign."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    sw, sx, sy, sz = (torch.sqrt(torch.clamp(t, min=1e-12)) for t in (tw, tx, ty, tz))
    qx = torch.stack([sx / 2, (m01 + m10) / (2 * sx), (m02 + m20) / (2 * sx), (m21 - m12) / (2 * sx)], -1)
    qy = torch.stack([(m01 + m10) / (2 * sy), sy / 2, (m12 + m21) / (2 * sy), (m02 - m20) / (2 * sy)], -1)
    qz = torch.stack([(m02 + m20) / (2 * sz), (m12 + m21) / (2 * sz), sz / 2, (m10 - m01) / (2 * sz)], -1)
    qw = torch.stack([(m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw), (m10 - m01) / (2 * sw), sw / 2], -1)
    best = torch.stack([tx, ty, tz, tw], -1).argmax(-1)
    cands = torch.stack([qx, qy, qz, qw], -2)  # (..., 4 candidates, xyzw)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def covariance_to_upper_triangle(cov: Tensor) -> Tensor:
    """A symmetric (..., 3, 3) covariance as its (..., 6) upper triangle
    (xx, xy, xz, yy, yz, zz), the 3DGS rasterizers' layout."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1
    )


def upper_triangle_to_covariance(tri: Tensor) -> Tensor:
    """Inverse of covariance_to_upper_triangle."""
    xx, xy, xz, yy, yz, zz = tri.unbind(-1)
    return torch.stack(
        [torch.stack(row, dim=-1) for row in ((xx, xy, xz), (xy, yy, yz), (xz, yz, zz))], dim=-2
    )
