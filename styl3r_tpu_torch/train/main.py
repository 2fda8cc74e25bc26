"""Training entry point (counterpart of train.py; the reference's
`python -m src.main_style`).

    python -m styl3r_tpu_torch.train.main --config configs/experiment/re10k_3view_style.yaml \
        [--max-steps N] [--cpu] [key.sub=value ...]
    torchrun --nproc_per_node=N -m styl3r_tpu_torch.train.main ...   # data-parallel over N cards

The experiment config selects stage-0 distillation
(re10k_style_distill.yaml: a frozen MASt3R teacher, `train.distiller=<.pth>`,
drawn at random without one), stage-1 novel-view pretraining or stage-2
stylization. Runs on CUDA, or raises without it, unless --cpu is given.
Weights:
  * model.encoder.pretrained_weights=<.ckpt/.pth>: a Styl3R, NoPoSplat or
    raw MASt3R torch checkpoint, warm-started by its flavor;
  * model.encoder.stylizer_pretrained_weights=<.ckpt/.pth>: the token
    stylizer's own warm start;
  * checkpointing.load=<file>: the weights of a checkpoint, and with
    checkpointing.resume=true also its optimizer state, step and data position.
The final state goes to <checkpointing.output_dir>/checkpoints/final.pt.
Under torchrun each process is one rank of a data-parallel run over NCCL (gloo
with --cpu); `train.batch_size` is the global batch, split over the ranks, and
rank 0 alone prints, logs and writes checkpoints.
"""

from __future__ import annotations

import argparse


def main(argv=None, model=None, teacher=None):
    """`model` and `teacher` replace the full-width model and distillation
    teacher the config would build (the tests pass tiny ones)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="configs/main.yaml")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from ..parallel import init_distributed

    rank, world, device = init_distributed("cpu" if args.cpu else "cuda")
    try:
        state = _train(args, rank, world, device, model, teacher)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        print("done")
    return state


def _train(args, rank: int, world: int, device, model, teacher):
    from ..utils.checkpoint import (
        convert_stylizer_weights,
        load_torch_state_dict,
        warm_start_encoder_params,
    )
    from ..utils.config import load_config
    from .trainer import Trainer

    def say(msg):
        if rank == 0:
            print(msg)

    cfg = load_config(args.config, args.overrides)
    say(f"device: {device}; ranks={world} mode={cfg.mode} datasets={len(cfg.datasets)} batch={cfg.train.batch_size}")

    trainer = Trainer(cfg, model=model, device=device, teacher=teacher)
    try:
        # Warm starts (main_style.py:128-168), loaded over the model's init
        # inside fit.
        warm_start = None
        if cfg.model.encoder.pretrained_weights:
            sd = load_torch_state_dict(cfg.model.encoder.pretrained_weights)
            warm_start = warm_start_encoder_params(sd, cfg.model.encoder.sh_degree)
            say(f"warm-started encoder from {cfg.model.encoder.pretrained_weights}")
        if cfg.model.encoder.stylizer_pretrained_weights:
            sty = convert_stylizer_weights(load_torch_state_dict(cfg.model.encoder.stylizer_pretrained_weights))
            warm_start = {**(warm_start or {}), **sty}
            say(f"warm-started stylizer from {cfg.model.encoder.stylizer_pretrained_weights}")

        # A resume restores the weights with the rest of the state (fit).
        init_params = None
        if cfg.checkpointing.load and not cfg.checkpointing.resume:
            init_params = trainer.load_params_lazy(cfg.checkpointing.load)
            say(f"loaded weights from {cfg.checkpointing.load}")

        state = trainer.fit(max_steps=args.max_steps, init_params=init_params, warm_start=warm_start)
        trainer.save_checkpoint(state, trainer.output_dir / "checkpoints" / "final.pt")
    finally:
        trainer.close()
    return state


if __name__ == "__main__":
    main()
