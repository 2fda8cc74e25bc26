"""[Frozen copy of styl3r_tpu_torch/ops/rasterizer/camera.py, the benchmark's reference: it
imports nothing of the program.]

Camera setup for the Gaussian splatting rasterizer (counterpart of
styl3r_tpu/ops/rasterizer/camera.py)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from .projection import get_fov, invert_se3
from .se3 import se3_exp


class RasterCamera(NamedTuple):
    """Camera bundle for one render (leading batch dims free)."""

    w2c: Tensor  # (..., 4, 4) world-to-camera
    cam_pos: Tensor  # (..., 3) camera center in world space
    tan_fov: Tensor  # (..., 2) tan(fov_x/2), tan(fov_y/2)
    focal: Tensor  # (..., 2) focal lengths in pixels
    principal: Tensor  # (..., 2) principal point in pixels
    near: Tensor  # (...)
    far: Tensor  # (...)


def make_raster_camera(
    extrinsics: Tensor,
    intrinsics: Tensor,
    near: Tensor,
    far: Tensor,
    image_shape: tuple[int, int],
    cam_rot_delta: Optional[Tensor] = None,
    cam_trans_delta: Optional[Tensor] = None,
) -> RasterCamera:
    """RasterCamera from c2w extrinsics + normalized intrinsics. With pose
    deltas, w2c' = exp([rho, theta]) @ w2c."""
    h, w = image_shape
    w2c = invert_se3(extrinsics)
    if cam_rot_delta is not None or cam_trans_delta is not None:
        zeros = torch.zeros(
            extrinsics.shape[:-2] + (3,), dtype=extrinsics.dtype, device=extrinsics.device
        )
        rot = cam_rot_delta if cam_rot_delta is not None else zeros
        trans = cam_trans_delta if cam_trans_delta is not None else zeros
        w2c = se3_exp(torch.cat([trans, rot], dim=-1)) @ w2c
    c2w = invert_se3(w2c)
    fov = get_fov(intrinsics)
    focal = torch.stack([intrinsics[..., 0, 0] * w, intrinsics[..., 1, 1] * h], dim=-1)
    principal = torch.stack([intrinsics[..., 0, 2] * w, intrinsics[..., 1, 2] * h], dim=-1)
    return RasterCamera(
        w2c=w2c,
        cam_pos=c2w[..., :3, 3],
        tan_fov=torch.tan(0.5 * fov),
        focal=focal,
        principal=principal,
        near=torch.as_tensor(near),
        far=torch.as_tensor(far),
    )
