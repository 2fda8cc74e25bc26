"""Batch Tanks&Temples stylization (counterpart of infer_tnt_batch.py;
reference infer_model_tnt_batch.py + script/batch_inference.sh): one
COLMAP/LLFF scene, a frame group as context, a sweep over style images,
with the model built once.

    python -m styl3r_tpu_torch.infer.tnt_batch --scene-dir <scene> --style-dir <styles> \
        [--frame-ids 0 100 200 300] [--style-ids 0 1 2] [--checkpoint ckpt] [--cpu]

Runs on CUDA unless --cpu is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene-dir", required=True, help="COLMAP scene directory (images/ + sparse/0)")
    parser.add_argument("--style-dir", required=True, help="directory of style images")
    parser.add_argument("--checkpoint", default=None, help="torch .ckpt/.pth (default: random weights)")
    parser.add_argument("--frame-ids", type=int, nargs="*", default=None,
                        help="context frame indices (default: 4 spread)")
    parser.add_argument("--style-ids", type=int, nargs="*", default=[0])
    parser.add_argument("--output", default="outputs/infer_tnt")
    parser.add_argument("--max-targets", type=int, default=4)
    parser.add_argument("--video-frames", type=int, default=0)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--scale-invariant", action="store_true",
                        help="per-view 1/near rescale before rendering (reference decoder.make_scale_invariant)")
    args = parser.parse_args(argv)

    from ..device import resolve_device
    from .cli import TINY, TINY_RENDER, load_image, load_model, run_scene_inference
    from .colmap import scene_photos_and_poses

    device = resolve_device("cpu" if args.cpu else None)
    photo_paths, poses, intrinsics = scene_photos_and_poses(Path(args.scene_dir))
    images = np.stack([load_image(p) for p in photo_paths])

    n = len(images)
    context = args.frame_ids or np.linspace(0, n - 1, 4).round().astype(int).tolist()
    target = [i for i in range(n) if i not in context][: args.max_targets] or context
    styles = sorted(
        p for p in Path(args.style_dir).iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    )

    model = load_model(args.checkpoint, device, **(TINY if args.tiny else {}))
    render_kwargs = dict(TINY_RENDER) if args.tiny else {}
    render_kwargs["scale_invariant"] = args.scale_invariant
    results = {}
    for sid in args.style_ids:
        style_path = styles[sid % len(styles)]
        out_dir = Path(args.output) / f"frames_{'_'.join(map(str, context))}" / f"style_{sid}"
        results[sid] = run_scene_inference(
            model, images, intrinsics, poses, context, target, load_image(style_path), out_dir,
            video_frames=args.video_frames, render_kwargs=render_kwargs,
        )
        print(f"style {sid} ({style_path.name}): {results[sid]}")
    return results


if __name__ == "__main__":
    main()
