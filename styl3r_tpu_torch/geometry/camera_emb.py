"""Pixelwise camera-intrinsics embedding (counterpart of
styl3r_tpu/geometry/camera_emb.py; reference `src/geometry/camera_emb.py` +
`src/misc/sht.py` rsh_cart_*): per-pixel local ray directions expanded in a
real spherical-harmonics basis, the backbone's 'pixelwise' intrinsics mode
(the release configs use the 'token' mode)."""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import Tensor

from .projection import get_local_rays_basis, sample_image_grid

# Real SH constants (graphics convention, as ops/rasterizer/project.py's).
C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154, -0.4570457994644658,
      1.445305721320277, -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601, -0.6690465435572892, 0.10578554691520431,
      -0.6690465435572892, 0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def rsh_cart(dirs: Tensor, degree: int) -> Tensor:
    """Real SH basis of unit directions (..., 3) up to `degree` (0..8, as
    the reference's rsh_cart_* family) -> (..., (degree + 1)^2)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, C0)]
    if degree >= 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy), C2[3] * xz, C2[4] * (xx - yy)]
    if degree >= 3:
        out += [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        out += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3.0 * xx - yy),
            C4[2] * xy * (7.0 * zz - 1.0),
            C4[3] * yz * (7.0 * zz - 3.0),
            C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            C4[5] * xz * (7.0 * zz - 3.0),
            C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            C4[7] * xz * (xx - 3.0 * yy),
            C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    if degree > 4:
        out += _rsh_cart_high(x, y, z, degree)
    return torch.stack(out, dim=-1)


def _rsh_cart_high(x: Tensor, y: Tensor, z: Tensor, degree: int) -> List[Tensor]:
    """Real SH bands 5..degree of unit directions, in the reference's
    rsh_cart_8 order (index n(n+1)+m, the Condon-Shortley phase folded into
    the sectoral terms): the fully normalized associated-Legendre recurrence
    in z, times A_m = r^m cos(m phi) and B_m = r^m sin(m phi) built from x
    and y without divisions (valid on the unit sphere)."""
    a_m, b_m = [torch.ones_like(x), x], [torch.zeros_like(x), y]
    for _ in range(2, degree + 1):
        a_next = x * a_m[-1] - y * b_m[-1]
        b_m.append(x * b_m[-1] + y * a_m[-1])
        a_m.append(a_next)

    # sect[m]: the z-independent p̂_{m,m} = P̄_{m,m} / sin^m(theta).
    sect = [math.sqrt(1.0 / (4.0 * math.pi))]
    for m in range(1, degree + 1):
        sect.append(-math.sqrt((2 * m + 1) / (2.0 * m)) * sect[-1])

    out: List[Tensor] = []
    pm2: List[Tensor] = []
    pm1: List[Tensor] = []
    ones = torch.ones_like(z)
    for ell in range(degree + 1):
        cur = []
        for m in range(ell + 1):
            if m == ell:
                cur.append(sect[m] * ones)
            elif m == ell - 1:
                cur.append(math.sqrt(2 * m + 3) * z * pm1[m])
            else:
                a = math.sqrt((4.0 * ell * ell - 1.0) / (ell * ell - m * m))
                b = math.sqrt(((ell - 1.0) ** 2 - m * m) / (4.0 * (ell - 1.0) ** 2 - 1.0))
                cur.append(a * (z * pm1[m] - b * pm2[m]))
        if ell >= 5:
            out += [math.sqrt(2.0) * cur[m] * b_m[m] for m in range(ell, 0, -1)]
            out.append(cur[0])
            out += [math.sqrt(2.0) * cur[m] * a_m[m] for m in range(1, ell + 1)]
        pm2, pm1 = pm1, cur
    return out


def get_intrinsic_embedding(intrinsics: Tensor, image_shape: Tuple[int, int], degree: int = 4) -> Tensor:
    """Per-pixel intrinsics conditioning (camera_emb.py:7-29): unit local ray
    directions expanded in the SH basis (degree 0: the raw directions).

    intrinsics (..., 3, 3) normalized -> (..., h, w, c), c = 3 at degree 0
    and (degree + 1)^2 above."""
    coords, _ = sample_image_grid(image_shape)
    coords = coords.to(intrinsics.device, intrinsics.dtype)
    dirs = get_local_rays_basis(coords, intrinsics[..., None, None, :, :])
    if degree <= 0:
        return dirs
    return rsh_cart(dirs, degree)
