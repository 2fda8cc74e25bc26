"""In-the-wild inference on a COLMAP- or LLFF-posed scene (counterpart of
infer_colmap.py; reference infer_model_colmap.py).

    python -m styl3r_tpu_torch.infer.colmap --scene-dir /path/to/scene \
        [--checkpoint re10k_2v.ckpt] [--style path.jpg] [--frames 0 13] \
        [--num-context 2] [--output outputs/colmap] [--cpu]

The scene directory holds images/ (numbered frames) and sparse/0/ with
cameras and images (.bin or .txt), or poses_bounds.npy. Without --style the
first frame is the style. Runs on CUDA unless --cpu is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Tuple

import numpy as np


def scene_photos_and_poses(scene_dir: Path) -> Tuple[List[Path], np.ndarray, np.ndarray]:
    """The scene's numbered frames (style images mixed into images/ are not
    numbered) with their c2w poses, oriented and centered, and normalized
    intrinsics, from sparse/0 or poses_bounds.npy."""
    from ..data.colmap import (
        auto_orient_and_center_poses,
        camera_intrinsics_normalized,
        colmap_poses_c2w,
        llff_intrinsics_normalized,
        load_colmap_model,
        read_llff_poses,
    )

    sparse = scene_dir / "sparse" / "0"
    photo_paths = sorted(
        p for p in (scene_dir / "images").iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg") and p.stem.isdigit()
    )
    if (sparse / "images.bin").exists() or (sparse / "images.txt").exists():
        cameras, col_images = load_colmap_model(sparse)
        poses, names = colmap_poses_c2w(col_images)
        name_to_pose = {n: i for i, n in enumerate(names)}
        photo_paths = [p for p in photo_paths if p.name in name_to_pose]
        poses = poses[[name_to_pose[p.name] for p in photo_paths]]
        cam = cameras[next(iter(cameras))]
        intrinsics = np.tile(camera_intrinsics_normalized(cam), (len(photo_paths), 1, 1))
    elif (scene_dir / "poses_bounds.npy").exists():
        poses_all, hwf, _ = read_llff_poses(scene_dir / "poses_bounds.npy")
        poses = poses_all[: len(photo_paths)]
        intrinsics = llff_intrinsics_normalized(hwf[: len(photo_paths)])
    else:
        raise FileNotFoundError(f"no COLMAP model or poses_bounds.npy in {scene_dir}")
    poses, _ = auto_orient_and_center_poses(poses)
    return photo_paths, poses, intrinsics


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene-dir", required=True, help="COLMAP scene directory (images/ + sparse/0)")
    parser.add_argument("--checkpoint", default=None, help="torch .ckpt/.pth (default: random weights)")
    parser.add_argument("--style", default=None, help="style image path (default: the first frame)")
    parser.add_argument("--frames", type=int, nargs="*", default=None,
                        help="context frame indices (default: spread num-context)")
    parser.add_argument("--num-context", type=int, default=2)
    parser.add_argument("--output", default="outputs/infer_colmap")
    parser.add_argument("--align-pose-steps", type=int, default=0)
    parser.add_argument("--video-frames", type=int, default=0)
    parser.add_argument("--tiny", action="store_true", help="tiny trunk (smoke test)")
    parser.add_argument("--max-targets", type=int, default=None)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--scale-invariant", action="store_true",
                        help="per-view 1/near rescale before rendering (reference decoder.make_scale_invariant)")
    args = parser.parse_args(argv)

    from ..device import resolve_device
    from .cli import TINY, TINY_RENDER, load_image, load_model, run_scene_inference

    device = resolve_device("cpu" if args.cpu else None)
    photo_paths, poses, intrinsics = scene_photos_and_poses(Path(args.scene_dir))
    images = np.stack([load_image(p) for p in photo_paths])

    n = len(images)
    if args.frames:
        context = list(args.frames)
    else:
        context = np.linspace(0, n - 1, args.num_context).round().astype(int).tolist()
    target = [i for i in range(n) if i not in context] or context
    if args.max_targets:
        target = target[: args.max_targets]
    style = load_image(Path(args.style)) if args.style else images[0]

    model = load_model(args.checkpoint, device, **(TINY if args.tiny else {}))
    render_kwargs = {"scale_invariant": args.scale_invariant}
    if args.tiny:
        render_kwargs.update(TINY_RENDER)
    metrics = run_scene_inference(
        model, images, intrinsics, poses, context, target, style, Path(args.output),
        image_shape=(256, 256), align_pose_steps=args.align_pose_steps,
        video_frames=args.video_frames, render_kwargs=render_kwargs,
    )
    print(f"wrote {args.output}: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
