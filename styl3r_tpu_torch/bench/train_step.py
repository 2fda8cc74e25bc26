"""The training step's forward + backward, examples/s (counterpart of
scripts/bench_train_step.py):

    python -m styl3r_tpu_torch.bench.train_step [--cases 128:jnp,128:pallas,...] [--pair-cap 4]
        [--output FILE]
    python -m styl3r_tpu_torch.bench.train_step --cpu --tiny --cases 32:jnp,32:pallas:b2:stage2

A case is size:impl[:bN][:stage1|stage2]: b scenes (default 1) of 2 views
at size^2 (32^2 with --tiny), rendered through the compositor kernels
(pallas) or their plain versions (jnp); stage 1's loss is the MSE to the
target views, stage 2's the style loss (losses/style.py) with VGG19 at
random weights. A step is the loss and the squared norm of its gradient
with respect to every weight, with no optimizer, as in JAX. The model holds
f32 weights and computes in bf16 (backbone, stylizer, DPT trunks); random
weights from seed 0, one model for every case. Each case draws its scene
from a fresh seed-0 generator, so the two 128^2 cases differ only in their
compositor; its step is timed over 5 steps back to back after a first one.

Prints a line a case and one JSON line last: `{case}` (ms a step),
`{case}:examples_per_sec_chip`, `{case}:live_pairs` and `{case}:pair_slots`
(the pair cap is lossless while the live pairs fit; an overflow prints a
WARNING), `{case}:loss`, `{case}:grad_sq_norm` and `{case}:route`, and
`kernel_speedup_128` (128:jnp over 128:pallas). With --cpu a pallas case
runs the plain compositor and says so in `{case}:route`.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..losses.style import style_loss
from ..losses.vgg import VGG19Features
from ..models.styl3r import Styl3rModel
from ..parallel.tp import global_sq_norm
from ..utils.convert import init_like_flax_
from .batch import example_batch
from .common import TINY_HEADS, device_names, no_tf32, route, route_name
from .timing import back_to_back_ms

DEFAULT_CASES = "128:jnp,128:pallas,256:pallas:b2:stage1,256:pallas:b2:stage2"
TIMED_STEPS = 5
VGG_SEED = 3


class Case(NamedTuple):
    size: int
    impl: str
    b: int
    stage: str


def parse_case(case: str) -> Case:
    """size:impl[:bN][:stage1|stage2] -> Case (b 1 and stage1 by default)."""
    parts = case.split(":")
    if len(parts) < 2 or parts[1] not in ("jnp", "pallas"):
        raise ValueError(f"case {case!r} is not size:jnp|pallas[:bN][:stage1|stage2]")
    b = next((int(p[1:]) for p in parts[2:] if p.startswith("b")), 1)
    stage = next((p for p in parts[2:] if p.startswith("stage")), "stage1")
    if stage not in ("stage1", "stage2"):
        raise ValueError(f"case {case!r}: unknown {stage}")
    return Case(int(parts[0]), parts[1], b, stage)


def training_model(device: torch.device, dims: Dict[str, object]) -> Styl3rModel:
    """f32 weights from seed 0, bf16 compute in the backbone, the stylizer
    and the DPT trunks."""
    return Styl3rModel(sh_degree=0, backbone_dtype=torch.bfloat16, head_trunk_dtype=torch.bfloat16,
                       device=device, seed=0, **dims)


def random_vgg(device: torch.device) -> VGG19Features:
    """VGG19 at random weights drawn on the CPU from seed VGG_SEED, frozen."""
    vgg = VGG19Features()
    init_like_flax_(vgg, torch.Generator().manual_seed(VGG_SEED))
    return vgg.to(device).requires_grad_(False)


def loss_of(stage: str, vgg: Optional[VGG19Features]) -> Callable:
    """loss(output, batch): stage 1's MSE or stage 2's style loss."""
    if stage == "stage2":
        return lambda out, batch: style_loss(vgg, out.color, batch.target_images, batch.style_image)[0]
    return lambda out, batch: ((out.color - batch.target_images) ** 2).mean()


def gradient_step(model: Styl3rModel, batch, hw, loss_fn, render_kwargs):
    """step(carry) -> (loss, squared gradient norm, render): the forward on
    the context images plus `carry`, the loss and its gradient to every
    weight."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(carry):
        b2 = batch._replace(context_images=batch.context_images + carry)
        _, out = model(b2, hw, **render_kwargs)
        loss = loss_fn(out, b2)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), global_sq_norm([g for g in grads if g is not None]), out

    return step


def case_batch(case: Case, hw, device):
    """The case's scene: b scenes of 2 views at hw, from a fresh seed-0
    generator."""
    return example_batch(np.random.default_rng(0), b=case.b, v=2, h=hw[0], w=hw[1], t=1, style_hw=hw[0],
                         device=device)


def run_case(model, case: Case, device, hw, render_kwargs, vgg) -> Dict[str, object]:
    """The case's live pairs, the loss and gradient norm of one step, and
    the ms of a step back to back."""
    batch = case_batch(case, hw, device)
    step = gradient_step(model, batch, hw, loss_of(case.stage, vgg), render_kwargs)
    loss, sq_norm, out = step(torch.zeros((), device=device))  # also the warm-up

    def chained(carry):
        loss, sq_norm, _ = step(carry)
        return carry * 0.5 + (loss + sq_norm) * 1e-12

    ms = back_to_back_ms(chained, TIMED_STEPS, device, warm=0)
    return {"ms": ms, "live_pairs": int(out.live_pairs.max()), "pair_slots": int(out.pair_slots.min()),
            "loss": float(loss), "grad_sq_norm": float(sq_norm)}


def main(argv=None, model: Optional[Styl3rModel] = None) -> Dict[str, object]:
    """Runs every case, prints the results as the last line and returns
    them. `model`, if given, is trained in place of the one the flags build
    (its widths must be the flags'; its weights are not changed)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--output", default="", help="also write the results to this JSON file, case by case")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU; pallas cases take the plain compositor")
    parser.add_argument("--pair-cap", type=int, default=4,
                        help="pair_cap_per_gaussian of the render (0 = every slot; lossless while live pairs fit)")
    parser.add_argument("--tiny", action="store_true", help="tiny widths, every case at 32^2")
    parser.add_argument("--cases", default=DEFAULT_CASES, help="comma-separated size:impl[:bN][:stage1|stage2]")
    args = parser.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    no_tf32()
    cases = {case: parse_case(case) for case in args.cases.split(",")}
    if model is None:
        model = training_model(dev, TINY_HEADS if args.tiny else {})
    vgg = random_vgg(dev) if any(c.stage == "stage2" for c in cases.values()) else None
    render_kwargs = dict(max_per_tile=2048, max_tiles_per_gaussian=8, pair_cap_per_gaussian=args.pair_cap)

    results: Dict[str, object] = {}
    for name, case in cases.items():
        impl = case.impl if dev.type == "cuda" else "jnp"
        size = 32 if args.tiny else case.size
        with route(impl):
            res = run_case(model, case, dev, (size, size), render_kwargs, vgg)
        if res["live_pairs"] > res["pair_slots"]:
            print(f"WARNING {name}: pair_cap overflow ({res['live_pairs']} > {res['pair_slots']})", file=sys.stderr)
        results[name] = round(res["ms"], 2)
        results[f"{name}:examples_per_sec_chip"] = round(case.b / (res["ms"] / 1e3), 2)
        for key in ("live_pairs", "pair_slots", "loss", "grad_sq_norm"):
            results[f"{name}:{key}"] = res[key]
        results[f"{name}:route"] = route_name(impl)
        print(f"train fwd+bwd {name} ({route_name(impl)}, {size}^2): {res['ms']:.1f} ms/step "
              f"({case.b / (res['ms'] / 1e3):.2f} ex/s), loss {res['loss']:.6g}, |grad|^2 {res['grad_sq_norm']:.6g}",
              flush=True)
        if args.output:
            Path(args.output).write_text(json.dumps(results, indent=2))

    if "128:jnp" in results and "128:pallas" in results:
        results["kernel_speedup_128"] = round(results["128:jnp"] / results["128:pallas"], 2)
    results["head_trunk_dtype"] = "bfloat16"
    results.update(device_names(dev))
    if args.output:
        Path(args.output).write_text(json.dumps(results, indent=2))
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
