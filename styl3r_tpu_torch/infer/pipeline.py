"""High-level inference: model -> Gaussians -> aligned renders -> outputs
(counterpart of styl3r_tpu/infer/pipeline.py; reference
`infer_model_re10k.py:262-560`, `model_wrapper_style.test_step_align`
:391-461).

Predict normal and stylized Gaussians in feed-forward passes, optionally
align the target cameras by optimizing SE3 deltas through the differentiable
renderer (both compositor kernels on CUDA), render views and trajectory
videos, export .ply.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ..device import DeviceLike
from ..geometry.gaussians import Gaussians
from ..geometry.se3 import update_pose
from ..models.decoder import DecoderOutput, render_gaussians
from ..models.styl3r import Styl3rModel, normalize_images
from ..utils.checkpoint import load_checkpoint
from ..utils.ply_export import export_ply
from .trajectory import interpolate_extrinsics


def default_render_kwargs(render_kwargs: dict) -> dict:
    """The bounded caps every pose-alignment loop and target render shares."""
    out = dict(render_kwargs)
    out.setdefault("max_per_tile", 2048)
    out.setdefault("max_tiles_per_gaussian", 8)
    return out


class Adam:
    """optax.adam's update rule (bias-corrected moments): `update(grad)`
    returns the signed increment -lr * m_hat / (sqrt(v_hat) + eps) and keeps
    the moments for the next call."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.m: Optional[Tensor] = None
        self.v: Optional[Tensor] = None

    def update(self, grad: Tensor) -> Tensor:
        if self.m is None:
            self.m, self.v = torch.zeros_like(grad), torch.zeros_like(grad)
        self.count += 1
        self.m = (1 - self.b1) * grad + self.b1 * self.m
        self.v = (1 - self.b2) * grad * grad + self.b2 * self.v

        def bias_correction(decay):  # in the moments' dtype, as optax takes it
            return 1 - torch.tensor(decay, dtype=grad.dtype, device=grad.device) ** self.count

        m_hat = self.m / bias_correction(self.b1)
        v_hat = self.v / bias_correction(self.b2)
        return -self.lr * (m_hat / (torch.sqrt(v_hat) + self.eps))


def align_target_poses(
    gaussians: Gaussians,
    target_extrinsics: Tensor,
    target_intrinsics: Tensor,
    target_near: Tensor,
    target_far: Tensor,
    target_images: Tensor,
    image_shape: Tuple[int, int],
    steps: int = 100,
    rot_lr: float = 3e-3,
    trans_lr: float = 1e-3,
    loss_fn: Optional[Callable] = None,
    **render_kwargs,
) -> Tensor:
    """Optimize per-view SE3 deltas through the renderer and bake them into
    the (b, v, 4, 4) c2w extrinsics each step (reference test_step_align):
    the deltas restart at zero every step while Adam's moments persist, so
    the step's Adam increment is the delta baked in.

    The Gaussians are constants here: they are detached, so only the deltas
    get a gradient. Tensors made under torch.inference_mode cannot enter
    the graph; predict under torch.no_grad (InferencePipeline does)."""
    b, v = target_extrinsics.shape[:2]
    render_kwargs = default_render_kwargs(render_kwargs)
    if loss_fn is None:
        def loss_fn(out, images):
            return ((out.color - images) ** 2).mean()

    gaussians = Gaussians(*(None if x is None else x.detach() for x in gaussians))
    rot_adam, trans_adam = Adam(rot_lr), Adam(trans_lr)
    extrinsics = target_extrinsics.detach()
    for _ in range(steps):
        rot = torch.zeros(b, v, 3, dtype=extrinsics.dtype, device=extrinsics.device, requires_grad=True)
        trans = torch.zeros(b, v, 3, dtype=extrinsics.dtype, device=extrinsics.device, requires_grad=True)
        with torch.enable_grad():
            out = render_gaussians(
                gaussians, extrinsics, target_intrinsics, target_near, target_far, image_shape,
                cam_rot_delta=rot, cam_trans_delta=trans, **render_kwargs,
            )
            grad_rot, grad_trans = torch.autograd.grad(loss_fn(out, target_images), (rot, trans))
        extrinsics = update_pose(
            trans_adam.update(grad_trans).reshape(b * v, 3),
            rot_adam.update(grad_rot).reshape(b * v, 3),
            extrinsics.reshape(b * v, 4, 4),
        ).reshape(b, v, 4, 4)
    return extrinsics


class InferencePipeline:
    """A Styl3rModel with the predict and render entry points of inference,
    each run under torch.no_grad on the model's device. Images and the style
    image are NHWC in [0, 1]."""

    def __init__(self, model: Styl3rModel, image_shape: Tuple[int, int] = (256, 256)):
        self.model = model
        self.image_shape = tuple(image_shape)
        self.device = model.device

    @classmethod
    def from_torch_checkpoint(
        cls,
        path: str,
        device: DeviceLike = None,
        sh_degree: int = 0,
        backbone_dtype: torch.dtype = torch.bfloat16,
        image_shape: Tuple[int, int] = (256, 256),
        **model_kwargs,
    ) -> "InferencePipeline":
        """A model built with `model_kwargs` and loaded from a torch
        .ckpt/.pth (utils/checkpoint.py::load_checkpoint)."""
        model = Styl3rModel(sh_degree=sh_degree, backbone_dtype=backbone_dtype, device=device, **model_kwargs)
        load_checkpoint(model, path)
        return cls(model, image_shape)

    @torch.no_grad()
    def predict_gaussians(
        self, context_images: Tensor, context_intrinsics: Tensor, style_image: Optional[Tensor] = None
    ) -> Gaussians:
        """(b, v, h, w, 3) context + (b, v, 3, 3) normalized K + (b, hs, ws,
        3) style. style_image=None takes context view 0 as the style (the
        identity protocol), which gives the un-stylized Gaussians."""
        if style_image is None:
            style_image = context_images[:, 0]
        return self.model.encoder(
            normalize_images(context_images), context_intrinsics, normalize_images(style_image)
        )

    @torch.no_grad()
    def render(self, gaussians: Gaussians, extrinsics, intrinsics, near, far, **kwargs) -> DecoderOutput:
        return render_gaussians(gaussians, extrinsics, intrinsics, near, far, self.image_shape, **kwargs)

    def render_trajectory_video(
        self,
        gaussians: Gaussians,
        ext0: np.ndarray,
        ext1: np.ndarray,
        intrinsics: np.ndarray,
        near: float,
        far: float,
        num_frames: int = 60,
        batch_frames: int = 10,
    ) -> np.ndarray:
        """Frames (num_frames, h, w, 3) of a smooth in-and-out sweep from one
        c2w camera to the other, rendered `batch_frames` views a call
        (reference render_video_interpolation, infer_model_re10k.py:179-233)."""
        t = 1.0 - (np.cos(np.linspace(0, 2 * np.pi, num_frames)) + 1) / 2
        exts = torch.from_numpy(interpolate_extrinsics(ext0, ext1, t)).to(self.device)
        k = torch.as_tensor(np.asarray(intrinsics, np.float32), device=self.device)
        frames = []
        for i in range(0, num_frames, batch_frames):
            chunk = exts[i : i + batch_frames]
            n = len(chunk)
            out = self.render(
                gaussians, chunk[None], k.expand(1, n, 3, 3),
                torch.full((1, n), near, device=self.device), torch.full((1, n), far, device=self.device),
            )
            frames.append(out.color[0].float().cpu().numpy())
        return np.concatenate(frames, axis=0)

    def export_ply(self, gaussians: Gaussians, path: Path, batch_index: int = 0) -> None:
        export_ply(
            *(x[batch_index].float().cpu().numpy() for x in (
                gaussians.means, gaussians.scales, gaussians.rotations, gaussians.harmonics, gaussians.opacities,
            )),
            path,
        )
