#!/usr/bin/env python3
"""How far two runs of the same training fit drift apart on one NVIDIA GPU.

    python3 scripts/fit_repeatability.py [--steps 4] [--batch-size 2]

Runs `python -m styl3r_tpu_torch.train.main` twice, in this process, on
configs/experiment/re10k_2view_nvs.yaml (stage 1, full width, random weights,
the config's renderer caps) over chip_smoke.py's synthetic RE10K chunks, with
a checkpoint at the middle step, and prints each step's loss and gradient
norm in both runs and the distance between the runs' weights at the middle
step and at the last, beside what the last half of the steps changed. The
card's convolution backward is not deterministic: this is the spread a
comparison of two fits (chip_smoke.py's distributed phase, a resume) has to
allow.
"""

import argparse
import gc
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=2)
    args = parser.parse_args(argv)

    import torch

    import chip_smoke as c
    from styl3r_tpu_torch.train import main as train_main
    from styl3r_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        print("fit_repeatability: no CUDA device", file=sys.stderr)
        return 1
    cuda_build.build(cuda_build.KERNELS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = c.card_line()
    half = args.steps // 2
    with tempfile.TemporaryDirectory(prefix="styl3r_repeat_") as tmp:
        root = os.path.join(tmp, "re10k")
        c.fit_chunks(root)
        runs = []
        for name in ("first", "second"):
            out = os.path.join(tmp, name)
            train_main.main(c.dist_fit_args(root, out, args.batch_size, args.steps,
                                            f"checkpointing.every_n_train_steps={half}", "checkpointing.save_top_k=-1"))
            ckpt = os.path.join(out, "checkpoints")
            rec = c.fit_metrics(out)["train"]
            runs.append(dict(mid=c.checkpoint_weights(os.path.join(ckpt, f"step_{half}.pt")),
                             last=c.checkpoint_weights(os.path.join(ckpt, "final.pt")),
                             loss=[r["loss"] for r in rec], grad_norm=[r["grad_norm"] for r in rec]))
            shutil.rmtree(out)
            gc.collect()
            torch.cuda.empty_cache()
    a, b = runs
    moved = c.weights_distance(a["last"], a["mid"])
    print(f"losses: {a['loss']} / {b['loss']}")
    print(f"grad norms: {a['grad_norm']} / {b['grad_norm']}")
    print(f"weights apart at step {half}: {c.weights_distance(a['mid'], b['mid']):.6g}; at step {args.steps}: "
          f"{c.weights_distance(a['last'], b['last']):.6g}, {c.weights_distance(a['last'], b['last']) / moved:.4g} of "
          f"what steps {half + 1}-{args.steps} changed ({moved:.6g}, L2) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
