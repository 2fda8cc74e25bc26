"""Two-view pose accuracy over a dataset (counterpart of eval_pose.py; the
reference's src/eval_pose.py + PoseEvaluator).

    python -m styl3r_tpu_torch.eval.eval_pose --config configs/experiment/re10k_eval.yaml \
        [--checkpoint ckpt] [--max-scenes N] [--refine-steps 200] [--tiny] [--cpu] [key=value ...]

For each scene of the test datasets: predict the Gaussians of the two
context views (style := context view 0), solve the second camera by PnP from
its predicted per-pixel means, refine it photometrically against context
image 1 (both compositor kernels, once each a step, on CUDA), and score its
rotation and translation angle errors; prints the pose AUC@{5,10,20} over
the scenes. Runs on CUDA, or raises without it, unless --cpu is given.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="configs/experiment/re10k_eval.yaml")
    parser.add_argument("--checkpoint", default=None, help="torch .ckpt/.pth (default: random weights)")
    parser.add_argument("--max-scenes", type=int, default=None)
    parser.add_argument("--refine-steps", type=int, default=200)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ..device import resolve_device
    from ..infer.cli import TINY, TINY_RENDER, load_model
    from ..models.styl3r import normalize_images
    from ..train.trainer import build_datasets
    from ..utils.config import load_config
    from .pose import pnp_pose_from_gaussians, pose_auc, pose_error_deg, refine_pose_photometric

    device = resolve_device("cpu" if args.cpu else None)
    cfg = load_config(args.config, args.overrides)
    datasets = build_datasets(cfg, "test", cfg.seed)
    # f32 compute, as the JAX eval_pose.py's model.
    model = load_model(args.checkpoint, device, sh_degree=cfg.model.encoder.sh_degree,
                       backbone_dtype=torch.float32, **(TINY if args.tiny else {}))
    render_kwargs = dict(TINY_RENDER) if args.tiny else {}

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    errors = []
    n_scenes = 0
    for ds in datasets:
        for ex in ds:
            imgs, intr = tensor(ex.context.image)[None], tensor(ex.context.intrinsics)[None]
            # no_grad, not inference_mode: the Gaussians enter the refinement's graph.
            with torch.no_grad():
                gaussians, aux = model.encoder(
                    normalize_images(imgs), intr, normalize_images(imgs[:, 0]), return_aux=True
                )
            # PnP from the predicted means of the second context view.
            pose0 = pnp_pose_from_gaussians(
                aux["pts3d"][0, 1].float().cpu().numpy(), aux["densities"][0, 1].float().cpu().numpy(),
                ex.context.intrinsics[1],
            )
            refined = refine_pose_photometric(
                gaussians, tensor(pose0), intr[0, 1], tensor(ex.context.image[1]),
                float(ex.context.near[1]), float(ex.context.far[1]), steps=args.refine_steps, **render_kwargs,
            )
            r_err, t_err = pose_error_deg(refined.cpu().numpy(), ex.context.extrinsics[1])
            errors.append(max(r_err, t_err))
            n_scenes += 1
            print(f"{ex.scene}: R={r_err:.2f}deg t={t_err:.2f}deg", flush=True)
            if args.max_scenes and n_scenes >= args.max_scenes:
                break
        if args.max_scenes and n_scenes >= args.max_scenes:
            break

    aucs = pose_auc(errors)
    print(f"pose AUC over {n_scenes} scenes: " + ", ".join(f"@{t}={v:.4f}" for t, v in aucs.items()))
    return aucs


if __name__ == "__main__":
    main()
