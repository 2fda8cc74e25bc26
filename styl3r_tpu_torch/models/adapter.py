"""Raw head channels -> 3D Gaussians (counterpart of
styl3r_tpu/models/adapter.py): the pose-free adapter (reference
UnifiedGaussianAdapter, `src/model/encoder/common/gaussian_adapter.py:122-153`)
and the posed one (GaussianAdapter, `:50-111`)."""

from __future__ import annotations

import torch
from torch import Tensor

from ..geometry.gaussians import Gaussians, build_covariance, quat_mul_xyzw, rotmat_to_quat_xyzw
from ..geometry.projection import get_world_rays


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


def opacity_exponent(global_step: int, initial: float = 0.0, final: float = 0.0, warm_up: int = 1) -> float:
    """The opacity warm-up's exponent at `global_step`: 1 at every step of
    the release config (initial = final = 0)."""
    x = initial + min(float(global_step) / warm_up, 1.0) * (final - initial)
    return 2.0**x


def map_pdf_to_opacity(
    pdf: Tensor, global_step: int, initial: float = 0.0, final: float = 0.0,
    warm_up: int = 1,
) -> Tensor:
    """Opacity warm-up schedule; the identity at the release config
    (initial = final = 0)."""
    exponent = opacity_exponent(global_step, initial, final, warm_up)
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


def get_scale_multiplier(intrinsics: Tensor, pixel_size: Tensor, multiplier: float = 0.1) -> Tensor:
    """The pixel-size multiplier of the posed adapter's scales:
    multiplier * K[:2, :2]^-1 (1/w, 1/h), summed over its two entries."""
    inv = torch.linalg.inv(intrinsics[..., :2, :2])
    xy = multiplier * torch.einsum("...ij,...j->...i", inv, pixel_size)
    return xy.sum(-1)


def posed_gaussian_adapter(
    extrinsics: Tensor,
    intrinsics: Tensor,
    coordinates: Tensor,
    depths: Tensor,
    opacities: Tensor,
    raw: Tensor,
    image_shape,
    sh_degree: int,
    gaussian_scale_min: float = 0.5,
    gaussian_scale_max: float = 15.0,
    eps: float = 1e-8,
) -> Gaussians:
    """The posed adapter: means lie along the camera rays at the predicted
    depth; scales are sigmoid-bounded in [min, max], then multiplied by the
    depth and the pixel-size multiplier; the camera rotation is composed
    into the stored quaternion, so rotations and covariances are both in
    the world frame. SH are left unrotated, as in the reference.

    extrinsics: (..., 4, 4) c2w; intrinsics: (..., 3, 3) normalized;
    coordinates: (..., 2) normalized pixel coordinates; depths and
    opacities: (...); raw: (..., 7 + 3*d_sh). The cameras broadcast against
    the Gaussians (one camera for all, or one a Gaussian)."""
    h, w = image_shape
    n_sh = d_sh(sh_degree)
    scales = raw[..., 0:3]
    rotations = raw[..., 3:7]
    sh = raw[..., 7 : 7 + 3 * n_sh]

    scales = gaussian_scale_min + (gaussian_scale_max - gaussian_scale_min) * (1.0 / (1.0 + torch.exp(-scales)))
    pixel_size = torch.tensor([1.0 / w, 1.0 / h], dtype=raw.dtype, device=raw.device)
    multiplier = get_scale_multiplier(intrinsics, pixel_size)
    scales = scales * depths[..., None] * multiplier[..., None]

    rotations = safe_normalize(rotations, eps)
    sh = sh.reshape(*sh.shape[:-1], 3, n_sh) * sh_degree_mask(sh_degree, raw.dtype, raw.device)

    # Rc (R S² Rᵀ) Rcᵀ = (Rc R) S² (Rc R)ᵀ: the camera rotation goes into the
    # quaternion, which keeps scales, rotations and covariances consistent.
    q_cam = rotmat_to_quat_xyzw(extrinsics[..., :3, :3])
    rotations = quat_mul_xyzw(q_cam, rotations.expand(*scales.shape[:-1], 4))
    covariances = build_covariance(scales, rotations)

    origins, directions = get_world_rays(coordinates, extrinsics, intrinsics)
    means = origins + directions * depths[..., None]
    return Gaussians(
        means=means,
        covariances=covariances,
        harmonics=sh,
        opacities=opacities,
        scales=scales,
        rotations=rotations,
    )
