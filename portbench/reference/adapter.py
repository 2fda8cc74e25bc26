"""[Frozen copy of styl3r_tpu_torch/models/adapter.py, the benchmark's reference: it
imports nothing of the program.]

Raw head channels -> 3D Gaussians (counterpart of
styl3r_tpu/models/adapter.py): the pose-free adapter (reference
UnifiedGaussianAdapter, `src/model/encoder/common/gaussian_adapter.py:122-153`)
and the posed one (GaussianAdapter, `:50-111`)."""

from __future__ import annotations

import torch
from torch import Tensor

from .gaussians import Gaussians, build_covariance


def safe_normalize(x: Tensor, eps: float = 1e-8) -> Tensor:
    """Unit-normalize along the last axis. eps^2 sits inside the rsqrt, so
    an exactly-zero row maps to zero with a finite gradient."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps * eps)


def sh_degree_mask(sh_degree: int, dtype=torch.float32, device=None) -> Tensor:
    """1 for the DC coefficient, 0.1 * 0.25**degree for degree >= 1."""
    mask = torch.ones(d_sh(sh_degree), dtype=dtype, device=device)
    for degree in range(1, sh_degree + 1):
        mask[degree**2 : (degree + 1) ** 2] = 0.1 * 0.25**degree
    return mask


def d_sh(sh_degree: int) -> int:
    return (sh_degree + 1) ** 2


def raw_gaussian_channels(sh_degree: int) -> int:
    """7 (scale + quat) + 3*d_sh, excluding the leading opacity channel."""
    return 7 + 3 * d_sh(sh_degree)


def map_pdf_to_opacity(
    pdf: Tensor, global_step: int, initial: float = 0.0, final: float = 0.0,
    warm_up: int = 1,
) -> Tensor:
    """Opacity warm-up schedule; the identity at the release config
    (initial = final = 0)."""
    x = initial + min(float(global_step) / warm_up, 1.0) * (final - initial)
    exponent = 2.0**x
    return 0.5 * (1.0 - (1.0 - pdf) ** exponent + pdf ** (1.0 / exponent))


def unified_gaussian_adapter(
    means: Tensor,
    opacities: Tensor,
    raw: Tensor,
    sh_degree: int,
    eps: float = 1e-8,
) -> Gaussians:
    """Pose-free adapter: means come straight from the pts3d head.

    means: (..., 3); opacities: (...); raw: (..., 7 + 3*d_sh)."""
    n_sh = d_sh(sh_degree)
    scales = raw[..., 0:3]
    rotations = raw[..., 3:7]
    sh = raw[..., 7 : 7 + 3 * n_sh]

    # Softplus as logaddexp(x, 0): F.softplus switches to the identity above
    # its threshold of 20, which changes the value.
    scales = 0.001 * torch.logaddexp(scales, torch.zeros_like(scales))
    scales = torch.clamp(scales, max=0.3)

    rotations = safe_normalize(rotations, eps)
    sh = sh.reshape(*sh.shape[:-1], 3, n_sh) * sh_degree_mask(
        sh_degree, raw.dtype, raw.device
    )
    return Gaussians(
        means=means,
        covariances=build_covariance(scales, rotations),
        harmonics=sh,
        opacities=opacities,
        scales=scales,
        rotations=rotations,
    )
