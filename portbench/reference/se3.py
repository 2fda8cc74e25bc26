"""[Frozen copy of styl3r_tpu_torch/geometry/se3.py, the benchmark's reference: it
imports nothing of the program.]

SO(3)/SE(3) exponential maps and pose updates, batched (counterpart of
styl3r_tpu/geometry/se3.py; reference `src/misc/cam_utils.py:27-43,69-140`)."""

from __future__ import annotations

import torch
from torch import Tensor

from .projection import invert_se3


def skew(v: Tensor) -> Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _safe_angle(theta: Tensor, eps: float) -> tuple[Tensor, Tensor]:
    """(angle, small-mask); sqrt is only taken of values bounded away from 0."""
    sq = (theta * theta).sum(-1)
    small = sq < eps * eps
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    return angle, small


def so3_exp(theta: Tensor, eps: float = 1e-5) -> Tensor:
    """Rodrigues' formula with the Taylor coefficients below eps: at
    theta = 0 exactly this returns the identity."""
    w = skew(theta)
    w2 = w @ w
    angle, small = _safe_angle(theta, eps)
    a = torch.where(small, torch.ones_like(angle), torch.sin(angle) / angle)
    b = torch.where(
        small, torch.full_like(angle, 0.5), (1.0 - torch.cos(angle)) / angle**2
    )
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return eye + a[..., None, None] * w + b[..., None, None] * w2


def _left_jacobian(theta: Tensor, eps: float = 1e-5) -> Tensor:
    w = skew(theta)
    w2 = w @ w
    angle, small = _safe_angle(theta, eps)
    b = torch.where(
        small, torch.full_like(angle, 0.5), (1.0 - torch.cos(angle)) / angle**2
    )
    c = torch.where(
        small, torch.full_like(angle, 1.0 / 6.0), (angle - torch.sin(angle)) / angle**3
    )
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    return eye + b[..., None, None] * w + c[..., None, None] * w2


def se3_exp(tau: Tensor) -> Tensor:
    """(..., 6) twist [rho, theta] -> (..., 4, 4) transform."""
    rho, theta = tau[..., :3], tau[..., 3:]
    rot = so3_exp(theta)
    t = torch.einsum("...ij,...j->...i", _left_jacobian(theta), rho)
    top = torch.cat([rot, t[..., None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=tau.dtype, device=tau.device
    ).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)
