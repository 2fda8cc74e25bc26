#!/usr/bin/env python3
"""Convert an orbax checkpoint of the JAX package into a torch file that
styl3r_tpu_torch reads.

    python scripts/orbax_to_torch.py <orbax checkpoint directory> <out.pth>

Run it where JAX and orbax are installed (the machine that trained with the
JAX package); the port itself imports neither. The directory is restored
with orbax's StandardCheckpointer; a trainer's full state ({"params",
"opt_state", "step"}) gives its params, the optimizer state is dropped. The
params become the port's state dict (utils/convert.py::from_jax_params, the
reference's key names), saved with torch.save, which
`utils/checkpoint.py::load_checkpoint` (and so every entry point's
--checkpoint) loads strictly.
"""

import argparse
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def convert(src: Path, dst: Path) -> int:
    """Writes dst; returns the number of tensors in its state dict."""
    import orbax.checkpoint as ocp
    import torch

    from styl3r_tpu_torch.utils.convert import from_jax_params

    restored = ocp.StandardCheckpointer().restore(Path(src).absolute())
    # Trainer.save_checkpoint(full=True) wraps the params with the optimizer
    # state and the step (styl3r_tpu/infer/cli.py:99-103 unwraps them too).
    if isinstance(restored, dict) and "opt_state" in restored:
        restored = restored["params"]
    state_dict = from_jax_params(restored)
    dst = Path(dst)
    dst.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state_dict, dst)
    return len(state_dict)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src", type=Path, help="orbax checkpoint directory (params, or a trainer's full state)")
    parser.add_argument("dst", type=Path, help="the .pth to write")
    args = parser.parse_args(argv)
    if not args.src.is_dir():
        raise SystemExit(f"{args.src} is not an orbax checkpoint directory")
    n = convert(args.src, args.dst)
    print(f"wrote {args.dst}: {n} tensors")


if __name__ == "__main__":
    main()
