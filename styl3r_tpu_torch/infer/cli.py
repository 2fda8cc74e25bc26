"""Shared machinery of the inference entry points (infer/re10k.py,
infer/colmap.py, infer/tnt_batch.py; counterpart of
styl3r_tpu/infer/cli.py): build or load the model, assemble an unposed
context batch from raw frames, predict normal and stylized Gaussians,
optionally pose-align the target cameras, render views and an interpolation
video, export PLYs.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.shims import prepare_style_image, rescale_and_crop
from ..device import DeviceLike
from ..eval.benchmarker import Benchmarker
from ..eval.metrics import compute_psnr
from ..geometry.se3 import camera_normalization
from ..models.styl3r import Styl3rModel
from ..utils.checkpoint import load_checkpoint
from .pipeline import InferencePipeline, default_render_kwargs, align_target_poses

# The model the entry points' --tiny flag builds (the JAX entry points' own).
TINY = dict(enc_depth=2, dec_depth=4, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2)
# --tiny renders with these caps.
TINY_RENDER = dict(max_per_tile=512, max_tiles_per_gaussian=8)


def load_image(path: Path) -> np.ndarray:
    """An image file -> (h, w, 3) float32 RGB in [0, 1]."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def save_image(path: Path, image: np.ndarray) -> None:
    """(h, w, 3) in [0, 1] -> an 8-bit RGB image file (format by suffix)."""
    from PIL import Image

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((np.clip(image, 0, 1) * 255).astype(np.uint8)).save(path)


def save_video(path: Path, frames: np.ndarray, fps: int = 30) -> None:
    """A PNG frame sequence in the directory `path` without its suffix, and
    an .mp4 beside it when ffmpeg is on PATH."""
    import shutil
    import subprocess

    path = Path(path)
    frames_dir = path.with_suffix("")
    frames_dir.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(frames):
        save_image(frames_dir / f"{i:04d}.png", frame)
    if shutil.which("ffmpeg"):
        subprocess.run(
            [
                "ffmpeg", "-y", "-loglevel", "error", "-framerate", str(fps),
                "-i", str(frames_dir / "%04d.png"), "-pix_fmt", "yuv420p",
                str(path.with_suffix(".mp4")),
            ],
            check=False,
        )


def make_baseline_one(
    extrinsics: np.ndarray, context_indices: Sequence[int], near: float = 0.1, far: float = 100.0
) -> Tuple[np.ndarray, float, float, float]:
    """Rescale the world so the first-to-last context baseline is 1
    (infer_model_re10k.py:402-412); returns (extrinsics, scale, near, far)."""
    a = extrinsics[context_indices[0], :3, 3]
    b = extrinsics[context_indices[-1], :3, 3]
    scale = float(np.linalg.norm(a - b))
    if scale < 1e-8:
        scale = 1.0
    out = extrinsics.copy()
    out[:, :3, 3] /= scale
    return out, scale, near / scale, far / scale


def normalize_to_first_context(extrinsics: np.ndarray, context_indices: Sequence[int]) -> np.ndarray:
    """c2w poses relative to the first context camera."""
    ext = torch.from_numpy(np.asarray(extrinsics, np.float32))
    return camera_normalization(ext[context_indices[0]], ext).numpy()


def load_model(
    checkpoint: Optional[str],
    device: DeviceLike,
    sh_degree: int = 0,
    backbone_dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    **model_kwargs,
) -> Styl3rModel:
    """A Styl3rModel on `device`, loaded from a torch .ckpt/.pth, or with
    random weights from `seed` when checkpoint is None. The backbone and
    stylizer compute in `backbone_dtype`, as the JAX pipeline's do."""
    model = Styl3rModel(sh_degree=sh_degree, backbone_dtype=backbone_dtype, device=device, seed=seed, **model_kwargs)
    if checkpoint is None:
        print("WARNING: no checkpoint given; using random init")
        return model
    return load_checkpoint(model, checkpoint)


def run_scene_inference(
    model: Styl3rModel,
    images: np.ndarray,  # (n, h, w, 3) full scene frames in [0, 1]
    intrinsics: np.ndarray,  # (n, 3, 3) normalized
    extrinsics: np.ndarray,  # (n, 4, 4) c2w
    context_indices: Sequence[int],
    target_indices: Sequence[int],
    style_image: np.ndarray,  # (hs, ws, 3) in [0, 1]
    output_dir: Path,
    image_shape: Tuple[int, int] = (256, 256),
    align_pose_steps: int = 0,
    video_frames: int = 60,
    render_kwargs: Optional[dict] = None,
    benchmarker: Optional[Benchmarker] = None,
) -> dict:
    """The single-scene flow (infer_model_re10k.py:262-560) on the model's
    device. Writes style.png, context_*.png, target_gt_*.png, color_*.png,
    stylized_color_*.png, interpolation/ (with video_frames > 0),
    gaussians.ply, gaussians_stylized.ply and info.json into output_dir.
    Each phase is timed into `benchmarker` ("encoder" a predict, "optimize"
    a step, "decoder" and "video" a frame)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    render_kwargs = default_render_kwargs(render_kwargs or {})
    dev = model.device
    bench = benchmarker if benchmarker is not None else Benchmarker(dev)

    # Condition the cameras: baseline 1, relative to context camera 0.
    extrinsics, scale, near, far = make_baseline_one(extrinsics, context_indices)
    extrinsics = normalize_to_first_context(extrinsics, context_indices)

    ctx_imgs, ctx_k = rescale_and_crop(images[list(context_indices)], intrinsics[list(context_indices)], image_shape)
    tgt_imgs, tgt_k = rescale_and_crop(images[list(target_indices)], intrinsics[list(target_indices)], image_shape)
    style = prepare_style_image(style_image, 256)

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    pipeline = InferencePipeline(model, image_shape)
    ctx, ctx_k_t = tensor(ctx_imgs)[None], tensor(ctx_k)[None]
    # Normal (un-stylized) and stylized Gaussians in two forward passes.
    with bench.time("encoder"):
        gaussians = pipeline.predict_gaussians(ctx, ctx_k_t, None)
    with bench.time("encoder"):
        stylized = pipeline.predict_gaussians(ctx, ctx_k_t, tensor(style)[None])

    t = len(target_indices)
    tgt_ext = tensor(extrinsics[list(target_indices)])[None]
    tgt_k_t = tensor(tgt_k)[None]
    near_t = torch.full((1, t), near, device=dev)
    far_t = torch.full((1, t), far, device=dev)
    tgt_imgs_t = tensor(tgt_imgs)[None]

    if align_pose_steps > 0:
        with bench.time("optimize", num_calls=align_pose_steps):
            tgt_ext = align_target_poses(
                gaussians, tgt_ext, tgt_k_t, near_t, far_t, tgt_imgs_t, image_shape,
                steps=align_pose_steps, **render_kwargs,
            )

    with bench.time("decoder", num_calls=t):
        out = pipeline.render(gaussians, tgt_ext, tgt_k_t, near_t, far_t, **render_kwargs)
    with bench.time("decoder", num_calls=t):
        out_sty = pipeline.render(stylized, tgt_ext, tgt_k_t, near_t, far_t, **render_kwargs)
    color = out.color[0].float().cpu().numpy()
    color_sty = out_sty.color[0].float().cpu().numpy()

    save_image(output_dir / "style.png", style)
    for i, idx in enumerate(context_indices):
        save_image(output_dir / f"context_{idx:04d}.png", ctx_imgs[i])
    for i, idx in enumerate(target_indices):
        save_image(output_dir / f"target_gt_{idx:04d}.png", tgt_imgs[i])
        save_image(output_dir / f"color_{idx:04d}.png", color[i])
        save_image(output_dir / f"stylized_color_{idx:04d}.png", color_sty[i])

    if video_frames > 0:
        ctx_ext = extrinsics[list(context_indices)]
        with bench.time("video", num_calls=video_frames):
            video = pipeline.render_trajectory_video(
                stylized, ctx_ext[0], ctx_ext[-1], tgt_k[0], near, far, video_frames
            )
        save_video(output_dir / "interpolation", video)

    pipeline.export_ply(gaussians, output_dir / "gaussians.ply")
    pipeline.export_ply(stylized, output_dir / "gaussians_stylized.ply")

    psnr = float(compute_psnr(tgt_imgs_t[0], out.color[0].float()).mean())
    metrics = {"psnr_unstylized": psnr, "scale": scale}
    with (output_dir / "info.json").open("w") as f:
        json.dump(metrics, f, indent=2)
    return metrics
