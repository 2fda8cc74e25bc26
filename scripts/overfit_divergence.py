#!/usr/bin/env python3
"""Step by step, where a from-scratch stage-1 overfit run on one NVIDIA GPU
goes non-finite, through the compositor kernels and through their plain
versions.

    python3 scripts/overfit_divergence.py [--warmup 5] [--steps 20] [--model full]

Runs the stage-1 steps of `python -m styl3r_tpu_torch.train.overfit_colmap`
(its model, `stage1_loss`, samplers, render caps and dropout generators;
lr 2e-4 after `--warmup` steps) on chip_smoke.py's synthetic 48-frame 256^2
COLMAP scene, once through each compositor from the same scratch-initialized
weights, and prints each step's metrics, the largest raw norm the pts3d
heads' bounded postprocess saw, and how many parameters got a non-finite
gradient. The bound, d_min + span * tanh(expm1(|raw|) / span), has a
gradient of 0 * inf once expm1 overflows f32 (|raw| above ~88.7).
"""

import argparse
import contextlib
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--model", default="full")
    parser.add_argument("--size", type=int, default=256)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as c
    from styl3r_tpu_torch.bench.common import no_tf32, plain_compositor
    from styl3r_tpu_torch.models import dpt
    from styl3r_tpu_torch.train import overfit_colmap as oc
    from styl3r_tpu_torch.train.step import TrainState, make_optimizer, make_train_step
    from styl3r_tpu_torch.train.trainer import step_generator
    from styl3r_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        print("overfit_divergence: no CUDA device", file=sys.stderr)
        return 1
    cuda_build.build(cuda_build.KERNELS)
    no_tf32()
    dev = torch.device("cuda")
    print(c.card_line(), flush=True)

    raw_max = [0.0]
    bounded = dpt.reg_dense_pts3d

    def recording(raw, bound=None, d_min=0.1):
        raw_max[0] = max(raw_max[0], float(torch.linalg.norm(raw.detach().float(), dim=-1).max()))
        return bounded(raw, bound, d_min)

    dpt.reg_dense_pts3d = recording
    with tempfile.TemporaryDirectory(prefix="styl3r_divergence_") as tmp:
        scene = c.overfit_scene(os.path.join(tmp, "scene"), size=args.size)
        images, intrinsics, poses = oc.load_scene(scene, args.size)
    n = len(images)
    _, _, train_set = oc.split_frames(n, 10)
    model = oc.build_model(args.model, dev)
    initial = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    hw = (args.size, args.size)
    for route in ("kernels", "plain"):
        model.load_state_dict(initial)
        rng = np.random.default_rng(0)
        optimizer = make_optimizer(model, lr=2e-4, warmup_steps=args.warmup, total_steps=args.steps,
                                   backbone_lr_multiplier=1.0)
        nonfinite = []
        update = optimizer.step

        def checked_update():
            nonfinite.append([name for name, p in model.named_parameters()
                              if p.grad is not None and not bool(torch.isfinite(p.grad).all())])
            return update()

        optimizer.step = checked_update
        step = make_train_step(model, optimizer, hw, stylized=False, loss_fn=oc.stage1_loss,
                               **oc.render_settings(args.size))
        state = TrainState()
        with plain_compositor() if route == "plain" else contextlib.nullcontext():
            for i in range(args.steps):
                raw_max[0] = 0.0
                batch = oc.make_batch(images, intrinsics, poses, [oc.sample_train(rng, n, train_set, 3, 12, 2)], 2,
                                      dev)
                metrics = step(state, batch, step_generator(1, i, dev))
                print(f"{route} step {i + 1}: " + ", ".join(f"{k} {float(v):.6g}" for k, v in metrics.items())
                      + f", raw norm max {raw_max[0]:.4g}, non-finite gradients in {len(nonfinite[-1])} parameters "
                      f"{nonfinite[-1][:2]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
