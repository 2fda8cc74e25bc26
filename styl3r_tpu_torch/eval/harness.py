"""Evaluation harness, reference mode=test (counterpart of
styl3r_tpu/eval/harness.py; reference `ModelWrapperStyle.test_step` +
`on_test_end`, `model_wrapper_style.py:317-469`): predict Gaussians with
style := context view 0 (the identity protocol), optionally pose-align the
target cameras, render, score PSNR/SSIM (and LPIPS when given) with running
means per overlap bucket, save images and videos, and dump scores.json,
benchmark.json and peak_memory.json.

Eager PyTorch compiles nothing per shape, so unlike the JAX harness this one
renders each scene's t targets as they are, with no padding to a bucket of
target counts: "decoder" and "decoder_unpadded" are both the render block
divided by t.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..infer.cli import save_image, save_video
from ..infer.pipeline import InferencePipeline, align_target_poses
from ..infer.trajectory import interpolate_extrinsics, interpolate_intrinsics
from ..models.styl3r import Batch, Styl3rModel
from .benchmarker import Benchmarker
from .metrics import MetricTracker, compute_psnr, compute_ssim


class EvalHarness:
    def __init__(
        self,
        model: Styl3rModel,
        image_shape=(256, 256),
        align_pose: bool = False,
        pose_align_steps: int = 100,
        rot_opt_lr: float = 3e-3,
        trans_opt_lr: float = 1e-3,
        lpips_apply: Optional[Callable] = None,
        output_path: Optional[Path] = None,
        save_images: bool = False,
        save_videos: bool = False,
        video_frames: int = 30,
        render_kwargs: Optional[Dict] = None,
    ):
        self.pipeline = InferencePipeline(model, image_shape)
        self.image_shape = tuple(image_shape)
        self.align_pose = align_pose
        self.pose_align_steps = pose_align_steps
        self.rot_opt_lr = rot_opt_lr
        self.trans_opt_lr = trans_opt_lr
        self.lpips_apply = lpips_apply
        self.output_path = Path(output_path) if output_path else None
        self.save_images = save_images
        self.save_videos = save_videos
        self.video_frames = video_frames
        self.render_kwargs = dict(render_kwargs or {})
        self.tracker = MetricTracker()
        self.benchmarker = Benchmarker(model.device)

    def test_step(self, batch: Batch, scene: str = "", overlap: Optional[float] = None):
        """One scene (a Batch of tensors on the model's device); returns
        (metrics dict, DecoderOutput)."""
        b, t = batch.target_extrinsics.shape[:2]
        # Identity style protocol (model_wrapper_style.py:325).
        style = batch.style_image
        if style is None or style.shape[1:3] != batch.context_images.shape[2:4]:
            style = batch.context_images[:, 0]

        with self.benchmarker.time("encoder"):
            gaussians = self.pipeline.predict_gaussians(batch.context_images, batch.context_intrinsics, style)

        extrinsics = batch.target_extrinsics
        if self.align_pose:
            with self.benchmarker.time("optimize"):
                extrinsics = align_target_poses(
                    gaussians, extrinsics, batch.target_intrinsics, batch.target_near, batch.target_far,
                    batch.target_images, self.image_shape, steps=self.pose_align_steps,
                    rot_lr=self.rot_opt_lr, trans_lr=self.trans_opt_lr, **self.render_kwargs,
                )

        with self.benchmarker.time("decoder", num_calls=t):
            output = self.pipeline.render(
                gaussians, extrinsics, batch.target_intrinsics, batch.target_near, batch.target_far,
                **self.render_kwargs,
            )
        self.benchmarker.record("decoder_unpadded", self.benchmarker.last_elapsed, num_calls=t)

        h, w = self.image_shape
        pred = output.color.reshape(b * t, h, w, 3).float()
        gt = batch.target_images.reshape(b * t, h, w, 3).float()
        metrics = {
            "psnr": float(compute_psnr(gt, pred).mean()),
            "ssim": float(compute_ssim(gt, pred).mean()),
        }
        if self.lpips_apply is not None:
            metrics["lpips"] = float(self.lpips_apply(pred, gt).mean())
        self.tracker.update(metrics, overlap)

        if self.save_images and self.output_path is not None:
            out_dir = self.output_path / "images" / scene
            for i, image in enumerate(pred.cpu().numpy()):
                save_image(out_dir / f"{i:04d}.png", image)

        # An interpolation video between the first and last target cameras
        # (the reference test_step's render_video_interpolation).
        if self.save_videos and self.output_path is not None and t >= 2:
            s = np.linspace(0.0, 1.0, self.video_frames)
            dev = extrinsics.device
            ext = interpolate_extrinsics(extrinsics[0, 0].cpu().numpy(), extrinsics[0, -1].cpu().numpy(), s)
            intr = interpolate_intrinsics(
                batch.target_intrinsics[0, 0].cpu().numpy(), batch.target_intrinsics[0, -1].cpu().numpy(), s
            )
            traj = self.pipeline.render(
                type(gaussians)(*(None if x is None else x[:1] for x in gaussians)),
                torch.from_numpy(ext)[None].to(dev), torch.from_numpy(intr)[None].to(dev),
                batch.target_near[:1, :1].expand(1, len(s)), batch.target_far[:1, :1].expand(1, len(s)),
                **self.render_kwargs,
            )
            save_video(self.output_path / "videos" / f"{scene or 'scene'}", traj.color[0].float().cpu().numpy())
        return metrics, output

    def finish(self) -> Dict[str, float]:
        """Print the score table, dump the artifacts; returns the means."""
        print(self.tracker.table(), flush=True)
        if self.output_path is not None:
            self.output_path.mkdir(parents=True, exist_ok=True)
            with (self.output_path / "scores.json").open("w") as f:
                json.dump(self.tracker.means(), f, indent=2)
            self.benchmarker.dump(self.output_path / "benchmark.json")
            self.benchmarker.dump_memory(self.output_path / "peak_memory.json")
        return self.tracker.means()
