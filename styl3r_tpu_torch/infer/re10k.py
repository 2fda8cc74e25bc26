"""Single-scene RE10K inference (counterpart of infer_re10k.py; reference
infer_model_re10k.py).

    python -m styl3r_tpu_torch.infer.re10k --data-root datasets/re10k --scene <key> \
        [--checkpoint re10k_2v.ckpt] [--style path.jpg] [--num-context 2] \
        [--eval-index assets/evaluation_index_re10k.json] [--output outputs/re10k] [--cpu]

Runs on CUDA unless --cpu is given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-root", required=True, help="chunked RE10K root")
    parser.add_argument("--stage", default="test")
    parser.add_argument("--scene", required=True)
    parser.add_argument("--checkpoint", default=None, help="torch .ckpt/.pth (default: random weights)")
    parser.add_argument("--style", default=None)
    parser.add_argument("--num-context", type=int, default=2)
    parser.add_argument("--eval-index", default=None, help="evaluation index json for deterministic views")
    parser.add_argument("--output", default="outputs/infer_re10k")
    parser.add_argument("--align-pose-steps", type=int, default=0)
    parser.add_argument("--video-frames", type=int, default=60)
    parser.add_argument("--max-targets", type=int, default=None)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--scale-invariant", action="store_true",
                        help="per-view 1/near rescale before rendering (reference decoder.make_scale_invariant)")
    args = parser.parse_args(argv)

    from ..data.chunks import convert_poses_re10k, decode_jpeg, load_chunk, load_index
    from ..device import resolve_device
    from .cli import TINY, TINY_RENDER, load_image, load_model, run_scene_inference

    device = resolve_device("cpu" if args.cpu else None)

    # Locate and load the scene from its chunk (infer_model_re10k.py:336-365).
    index = load_index(Path(args.data_root), args.stage)
    if args.scene not in index:
        raise SystemExit(f"scene {args.scene} not in index ({len(index)} scenes)")
    example = next(ex for ex in load_chunk(index[args.scene]) if ex["key"] == args.scene)
    extrinsics, intrinsics = convert_poses_re10k(example["cameras"])
    n = len(extrinsics)

    if args.eval_index:
        with open(args.eval_index) as f:
            entry = json.load(f).get(args.scene)
        if entry is None:
            raise SystemExit(f"scene {args.scene} has no eval-index entry")
        context, target = list(entry["context"]), list(entry["target"])
    else:
        context = np.linspace(0, n - 1, args.num_context).round().astype(int).tolist()
        target = [i for i in range(n) if i not in context]
    if args.max_targets:
        target = target[: args.max_targets]

    images = np.stack([decode_jpeg(b) for b in example["images"]])
    style = load_image(Path(args.style)) if args.style else images[context[0]]

    model = load_model(args.checkpoint, device, **(TINY if args.tiny else {}))
    render_kwargs = dict(TINY_RENDER) if args.tiny else {}
    render_kwargs["scale_invariant"] = args.scale_invariant
    metrics = run_scene_inference(
        model, images, intrinsics, extrinsics, context, target, style,
        Path(args.output) / args.scene, image_shape=(args.size, args.size),
        align_pose_steps=args.align_pose_steps, video_frames=args.video_frames,
        render_kwargs=render_kwargs,
    )
    print(f"wrote {args.output}/{args.scene}: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
