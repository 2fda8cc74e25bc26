"""[Frozen copy of styl3r_tpu_torch/models/decoder.py, the benchmark's reference: it
imports nothing of the program.]

Splatting decoder: Gaussians + target cameras -> rendered images
(counterpart of styl3r_tpu/models/decoder.py::render_gaussians)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from .gaussians import Gaussians
from .camera import make_raster_camera
from .render import render_many


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
