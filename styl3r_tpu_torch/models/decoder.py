"""Splatting decoder: Gaussians + target cameras -> rendered images
(counterpart of styl3r_tpu/models/decoder.py::render_gaussians)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..geometry.gaussians import Gaussians
from ..ops.rasterizer.camera import make_raster_camera
from ..ops.rasterizer.render import render_many
from ..utils import trace


class DecoderOutput(NamedTuple):
    color: Tensor  # (b, v, h, w, 3)
    depth: Tensor  # (b, v, h, w)
    alpha: Tensor  # (b, v, h, w)
    # pair_cap telemetry, broadcast per view; the truncation was lossless
    # iff (live_pairs <= pair_slots).all().
    live_pairs: Optional[Tensor] = None  # (b, v) i32
    pair_slots: Optional[Tensor] = None  # (b, v) i32


def render_gaussians(
    gaussians: Gaussians,
    extrinsics: Tensor,
    intrinsics: Tensor,
    near: Tensor,
    far: Tensor,
    image_shape: Tuple[int, int],
    background_color: Optional[Tensor] = None,
    scale_invariant: bool = False,
    cam_rot_delta: Optional[Tensor] = None,
    cam_trans_delta: Optional[Tensor] = None,
    *,
    max_tiles_per_gaussian: int = 32,
    max_per_tile: int = 4096,
    pair_cap_per_gaussian: int = 0,
) -> DecoderOutput:
    """Render each scene's Gaussians into its (b, v) target cameras with one
    render_many call over all b*v views.

    extrinsics: (b, v, 4, 4) c2w; intrinsics: (b, v, 3, 3) normalized;
    near/far: (b, v). scale_invariant rescales each view's scene by 1/near.
    pair_cap_per_gaussian > 0 caps the kept pair slots at that many per
    (view, gaussian); 0 keeps every slot."""
    with trace.span("render"):
        b, v = extrinsics.shape[:2]
        n = b * v
        h, w = image_shape
        dev = extrinsics.device
        if background_color is None:
            background_color = torch.zeros(3, dtype=torch.float32, device=dev)
        backgrounds = torch.as_tensor(background_color, device=dev).expand(b, v, 3).reshape(n, 3)
        if cam_rot_delta is None:
            cam_rot_delta = torch.zeros(b, v, 3, dtype=extrinsics.dtype, device=dev)
        if cam_trans_delta is None:
            cam_trans_delta = torch.zeros(b, v, 3, dtype=extrinsics.dtype, device=dev)

        def per_view(x: Tensor) -> Tensor:  # (b, g, ...) -> (n, g, ...) view
            return x[:, None].expand(b, v, *x.shape[1:]).reshape(n, *x.shape[1:])

        ext = extrinsics.reshape(n, 4, 4)
        intr = intrinsics.reshape(n, 3, 3)
        nr = near.reshape(n).float()
        fr = far.reshape(n).float()
        mns = per_view(gaussians.means)
        shs = per_view(gaussians.harmonics)
        opas = per_view(gaussians.opacities)
        use_factors = gaussians.scales is not None and gaussians.rotations is not None
        if use_factors:
            scl, rot, cvs = per_view(gaussians.scales), per_view(gaussians.rotations), None
        else:
            scl, rot, cvs = None, None, per_view(gaussians.covariances)

        if scale_invariant:
            scale = (1.0 / nr)[:, None]
            ext = ext.clone()
            ext[:, :3, 3] = ext[:, :3, 3] * scale
            mns = mns * scale[..., None]
            if use_factors:
                scl = scl * scale[..., None]
            else:
                cvs = cvs * (scale**2)[..., None, None]
            nr = nr * scale[:, 0]
            fr = fr * scale[:, 0]

        cams = make_raster_camera(
            ext, intr, nr, fr, image_shape,
            cam_rot_delta=cam_rot_delta.reshape(n, 3),
            cam_trans_delta=cam_trans_delta.reshape(n, 3),
        )
        g = mns.shape[1]
        out = render_many(
            cams, mns, cvs, shs, opas, image_shape, backgrounds,
            scales=scl, rotations=rot,
            max_tiles_per_gaussian=max_tiles_per_gaussian,
            max_per_tile=max_per_tile,
            pair_cap=pair_cap_per_gaussian * n * g if pair_cap_per_gaussian else None,
        )
        return DecoderOutput(
            color=out.color.reshape(b, v, h, w, 3),
            depth=out.depth.reshape(b, v, h, w),
            alpha=out.alpha.reshape(b, v, h, w),
            live_pairs=out.live_pairs.expand(n).reshape(b, v),
            pair_slots=out.pair_slots.expand(n).reshape(b, v),
        )


def orthographic_cameras(
    extrinsics: Tensor,
    width: Tensor,
    height: Tensor,
    near: Tensor,
    far: Tensor,
    fov_degrees: float = 0.1,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fake-orthographic cameras (reference render_cuda_orthographic,
    cuda_splatting.py:136-227, up to the rasterizer call): each camera is
    pulled back along its own -z by distance = (width/2) / tan(fov_x/2) for
    a tiny fov_x, tan(fov_y/2) follows from the view's height, and near/far
    move back by the same distance. extrinsics (b, v, 4, 4) c2w; width,
    height, near, far (b, v) in world units. Returns (c2w, normalized K,
    near, far) for render_gaussians."""
    tan_fov_x = torch.tan(0.5 * torch.deg2rad(torch.tensor(fov_degrees, dtype=torch.float32)))
    tan_fov_x = tan_fov_x.to(extrinsics.device)
    distance = (0.5 * width) / tan_fov_x
    tan_fov_y = 0.5 * height / distance

    back = torch.eye(4, dtype=extrinsics.dtype, device=extrinsics.device).expand(*distance.shape, 4, 4).clone()
    back[..., 2, 3] = -distance
    new_ext = extrinsics @ back

    k = torch.zeros(*distance.shape, 3, 3, dtype=torch.float32, device=extrinsics.device)
    k[..., 0, 0] = 1.0 / (2.0 * tan_fov_x)
    k[..., 1, 1] = 1.0 / (2.0 * tan_fov_y)
    k[..., 0, 2] = 0.5
    k[..., 1, 2] = 0.5
    k[..., 2, 2] = 1.0
    return new_ext, k, near + distance, far + distance


def render_orthographic(
    gaussians: Gaussians,
    extrinsics: Tensor,
    width: Tensor,
    height: Tensor,
    near: Tensor,
    far: Tensor,
    image_shape: Tuple[int, int],
    fov_degrees: float = 0.1,
    **render_kwargs,
) -> DecoderOutput:
    """Orthographic-looking projections for validation's top-down views of
    the Gaussians (reference render_cuda_orthographic): the camera pulled
    far back with a tiny field of view."""
    new_ext, k, near2, far2 = orthographic_cameras(extrinsics, width, height, near, far, fov_degrees)
    return render_gaussians(gaussians, new_ext, k, near2, far2, image_shape, **render_kwargs)
