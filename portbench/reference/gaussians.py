"""[Frozen copy of styl3r_tpu_torch/geometry/gaussians.py, the benchmark's reference: it
imports nothing of the program.]

3D Gaussian primitives (counterpart of styl3r_tpu/geometry/gaussians.py).

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
