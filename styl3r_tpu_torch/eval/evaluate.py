"""Evaluation over a dataset (counterpart of evaluate.py; the reference's
mode=test).

    python -m styl3r_tpu_torch.eval.evaluate --config configs/experiment/re10k_eval.yaml \
        [--checkpoint ckpt] [--max-scenes N] [--tiny] [--cpu] [key=value ...]

Runs the deterministic protocol of eval/harness.py over the test datasets:
predict with the identity style, optionally pose-align the targets
(test.align_pose; both compositor kernels, once each a step, on CUDA),
render them, and score PSNR/SSIM (and LPIPS when losses.lpips_weights and
losses.lpips_vgg16_weights are set) per overlap bucket; writes scores.json,
benchmark.json and peak_memory.json (and, with test.save_image, each
target's render as images/<scene>/NNNN.png) under test.output_path. Runs on
CUDA, or raises without it, unless --cpu is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="configs/experiment/re10k_eval.yaml")
    parser.add_argument("--checkpoint", default=None, help="torch .ckpt/.pth (default: random weights)")
    parser.add_argument("--max-scenes", type=int, default=None)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..infer.cli import TINY, TINY_RENDER, load_model
    from ..models.styl3r import Batch, batch_to
    from ..train.trainer import build_datasets, render_settings
    from ..utils.config import load_config
    from .harness import EvalHarness

    device = resolve_device("cpu" if args.cpu else None)
    cfg = load_config(args.config, args.overrides)
    datasets = build_datasets(cfg, "test", cfg.seed)
    # f32 compute, as the JAX evaluate.py's model.
    model = load_model(args.checkpoint, device, sh_degree=cfg.model.encoder.sh_degree,
                       backbone_dtype=torch.float32, **(TINY if args.tiny else {}))
    h, w = cfg.datasets[0].input_image_shape
    render_kwargs = render_settings(cfg, device)
    if args.tiny:
        render_kwargs.update(TINY_RENDER)

    # LPIPS is part of the headline protocol (model_wrapper_style.py:399),
    # whenever its weights are configured.
    lpips_apply = None
    if cfg.losses.lpips_weights and cfg.losses.lpips_vgg16_weights:
        from ..losses.lpips import LPIPSVgg16, convert_lpips_state
        from ..utils.checkpoint import load_torch_state_dict

        lpips = LPIPSVgg16()
        lpips.load_state_dict(convert_lpips_state(
            load_torch_state_dict(cfg.losses.lpips_weights), load_torch_state_dict(cfg.losses.lpips_vgg16_weights),
        ))
        lpips_apply = lpips.to(device).requires_grad_(False)
        print("LPIPS enabled")
    else:
        print("LPIPS weights not configured (losses.lpips_weights + "
              "losses.lpips_vgg16_weights) — scores.json will omit lpips")

    harness = EvalHarness(
        model, image_shape=(h, w),
        align_pose=cfg.test.align_pose, pose_align_steps=cfg.test.pose_align_steps,
        rot_opt_lr=cfg.test.rot_opt_lr, trans_opt_lr=cfg.test.trans_opt_lr,
        lpips_apply=lpips_apply, output_path=Path(cfg.test.output_path), save_images=cfg.test.save_image,
        save_videos=cfg.test.save_video, render_kwargs=render_kwargs,
    )

    n_scenes = 0
    for ds in datasets:
        for example in ds:
            ctx, tgt = example.context, example.target
            batch = batch_to(Batch(
                context_images=ctx.image[None], context_intrinsics=ctx.intrinsics[None],
                target_extrinsics=tgt.extrinsics[None], target_intrinsics=tgt.intrinsics[None],
                target_near=tgt.near[None], target_far=tgt.far[None],
                style_image=ctx.image[0][None], target_images=tgt.image[None],
            ), device)
            overlap = float(ctx.overlap[0]) if ctx.overlap is not None else None
            harness.test_step(batch, example.scene, overlap)
            n_scenes += 1
            if n_scenes % 25 == 0:
                print(f"{n_scenes} scenes...", flush=True)
            if args.max_scenes and n_scenes >= args.max_scenes:
                break
        if args.max_scenes and n_scenes >= args.max_scenes:
            break

    means = harness.finish()
    print(f"evaluated {n_scenes} scenes -> {cfg.test.output_path}")
    return means


if __name__ == "__main__":
    main()
