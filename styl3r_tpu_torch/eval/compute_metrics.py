"""Metrics over saved render directories (counterpart of compute_metrics.py;
the reference's src/scripts/compute_metrics.py + MetricComputer).

    python -m styl3r_tpu_torch.eval.compute_metrics --gt-dir <gt_images> \
        --pred-dir <method1> [--pred-dir <method2> ...] [--cpu]

Each method's images are matched to the ground truth by relative path (any
nesting), resized to the ground truth's size with PIL's LANCZOS where they
differ, and scored with PSNR and SSIM (eval/metrics.py); prints and returns
each method's running means. Runs on CUDA, or raises without it, unless
--cpu is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

IMAGE_SUFFIXES = {".png", ".jpg", ".jpeg"}


def collect_images(root: Path) -> Dict[str, Path]:
    """{path relative to root: path} of every image under root."""
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.suffix.lower() in IMAGE_SUFFIXES}


def load_rgb(path: Path, size=None):
    """An image as (h, w, 3) float32 in [0, 1], LANCZOS-resized to `size`
    (w, h) when given and different."""
    import numpy as np
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        if size is not None and img.size != size:
            img = img.resize(size, Image.LANCZOS)
        return np.asarray(img, np.float32) / 255.0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gt-dir", required=True)
    parser.add_argument("--pred-dir", action="append", required=True)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    args = parser.parse_args(argv)

    import torch

    from ..device import resolve_device
    from .metrics import MetricTracker, compute_psnr, compute_ssim

    device = resolve_device("cpu" if args.cpu else None)
    gt = collect_images(Path(args.gt_dir))
    if not gt:
        raise SystemExit(f"no images under {args.gt_dir}")

    results = {}
    for pred_dir in args.pred_dir:
        preds = collect_images(Path(pred_dir))
        common = sorted(set(gt) & set(preds))
        if not common:
            print(f"{pred_dir}: no matching files")
            continue
        tracker = MetricTracker()
        for rel in common:
            g = torch.from_numpy(load_rgb(gt[rel])).to(device)
            p = torch.from_numpy(load_rgb(preds[rel], size=(g.shape[1], g.shape[0]))).to(device)
            tracker.update({
                "psnr": float(compute_psnr(g, p)),
                "ssim": float(compute_ssim(g[None], p[None])[0]),
            })
        means = tracker.means()
        results[pred_dir] = means
        print(f"{pred_dir} ({len(common)} images): "
              + " ".join(f"{k.split('/')[0]}={v:.4f}" for k, v in means.items() if k.endswith("/all")))
    return results


if __name__ == "__main__":
    main()
