"""Reconstruct a scene with VGGT (models/vggt.py) from a directory of
unposed photos: every view's camera, depth map and a confidence-filtered
point cloud.

    python -m styl3r_tpu_torch.infer.vggt --images DIR --out DIR [--checkpoint PATH] [--tiny] [--cpu]

The images (sorted by name) are preprocessed as VGGT's "crop" mode does:
resized bicubic to width 518 with the height keeping the aspect ratio,
rounded to a multiple of 14, and centre-cropped to 518 where taller; views
of different sizes are padded with white to the largest. Writes
`cameras.json` (each view's camera-from-world extrinsics, 3x4, and pixel
intrinsics, 3x3, of the preprocessed image, and the raw pose encoding),
`depth.npy` and `depth_conf.npy` (s, h, w), and `points.ply` (the world
points whose confidence is at or above its median, as VGGT's demo keeps
them, coloured by their pixels, as 3DGS rows through utils/ply_export.py).

Without --checkpoint the weights are random, drawn from seed 0 (VGGT's
released `model.pt` loads by key name). --tiny builds a small model for a
quick run on the CPU. Runs on CUDA (the aggregator in bf16 autocast, the
heads in float32, as VGGT's inference does), or on the CPU with --cpu;
without CUDA and without --cpu it stops with an error.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.registry import get_model
from ..models.vggt import VGGT_1B, pose_encoding_to_extri_intri
from ..utils.checkpoint import load_checkpoint
from ..utils.ply_export import export_ply
from .cli import load_image

TARGET = 518
IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
# The model --tiny builds (patch 14, two frame and two global blocks).
TINY = dict(VGGT_1B, embed_dim=32, depth=2, num_heads=2, patch_embed_depth=2, camera_trunk_depth=1,
            head_features=16, head_out_channels=(8, 8, 16, 16), head_layers=(0, 1, 1, 1))
SH_C0 = 0.28209479177387814
CONF_PERCENTILE = 50.0


def crop_preprocess(image: np.ndarray, target: int = TARGET, patch: int = 14) -> np.ndarray:
    """(h, w, 3) float32 in [0, 1] -> (3, h', w') as VGGT's "crop" mode:
    width `target`, height round(h * target / w / patch) * patch by PIL's
    bicubic resize, centre-cropped to `target` where taller."""
    from PIL import Image

    h, w = image.shape[:2]
    new_h = round(h * (target / w) / patch) * patch
    img = Image.fromarray(np.round(image * 255.0).astype(np.uint8)).resize((target, new_h), Image.Resampling.BICUBIC)
    out = np.asarray(img, dtype=np.float32).transpose(2, 0, 1) / 255.0
    if new_h > target:
        top = (new_h - target) // 2
        out = out[:, top:top + target]
    return out


def load_views(paths: Sequence[Path]) -> np.ndarray:
    """The views of `paths`, preprocessed, as (s, 3, h, w) float32; views
    of different sizes are padded with 1.0 (white) to the largest, centred."""
    views = [crop_preprocess(load_image(p)) for p in paths]
    hh, ww = max(v.shape[1] for v in views), max(v.shape[2] for v in views)
    out = np.ones((len(views), 3, hh, ww), np.float32)
    for i, v in enumerate(views):
        top, left = (hh - v.shape[1]) // 2, (ww - v.shape[2]) // 2
        out[i, :, top:top + v.shape[1], left:left + v.shape[2]] = v
    return out


def image_paths(directory: Path) -> List[Path]:
    paths = sorted(p for p in Path(directory).iterdir() if p.suffix.lower() in IMAGE_SUFFIXES)
    if not paths:
        raise ValueError(f"{directory}: no images ({', '.join(IMAGE_SUFFIXES)})")
    return paths


def write_outputs(out_dir: Path, names: Sequence[str], views: np.ndarray, pred: dict) -> dict:
    """cameras.json, depth.npy, depth_conf.npy and points.ply of one scene
    (batch 1); returns a summary."""
    out_dir.mkdir(parents=True, exist_ok=True)
    h, w = views.shape[2:]
    pose = pred["pose_enc"].float()
    extrinsics, intrinsics = pose_encoding_to_extri_intri(pose, (h, w))
    cameras = [{"image": name, "extrinsics": e.tolist(), "intrinsics": k.tolist(), "pose_enc": p.tolist()}
               for name, e, k, p in zip(names, extrinsics[0].cpu(), intrinsics[0].cpu(), pose[0].cpu())]
    (out_dir / "cameras.json").write_text(json.dumps({"image_hw": [h, w], "cameras": cameras}, indent=1))
    np.save(out_dir / "depth.npy", pred["depth"][0, ..., 0].cpu().numpy())
    np.save(out_dir / "depth_conf.npy", pred["depth_conf"][0].cpu().numpy())
    points = pred["world_points"][0].reshape(-1, 3).cpu().numpy()
    conf = pred["world_points_conf"][0].reshape(-1).cpu().numpy()
    colors = views.transpose(0, 2, 3, 1).reshape(-1, 3)
    keep = (conf >= np.percentile(conf, CONF_PERCENTILE)) & np.isfinite(points).all(axis=1)
    n = int(keep.sum())
    export_ply(points[keep], np.full((n, 3), 1e-3, np.float32), np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)),
               ((colors[keep] - 0.5) / SH_C0)[:, :, None], np.full((n,), 10.0, np.float32),
               out_dir / "points.ply")
    return {"views": len(names), "image_hw": [h, w], "points": n}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--images", required=True, help="directory of the scene's photos")
    parser.add_argument("--out", required=True, help="output directory")
    parser.add_argument("--checkpoint", default=None, help="VGGT's model.pt (default: random weights)")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    paths = image_paths(Path(args.images))
    views = load_views(paths)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else None
    model = get_model("vggt", **(TINY if args.tiny else {}), compute_dtype=compute_dtype, device=device)
    if args.checkpoint is not None:
        load_checkpoint(model, args.checkpoint)
    else:
        print("WARNING: no checkpoint given; using random init")
    with torch.inference_mode():
        pred = model.eval()(torch.from_numpy(views).to(device)[None])
    summary = write_outputs(Path(args.out), [p.name for p in paths], views, pred)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
