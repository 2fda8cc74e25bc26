"""Scenes/s of the 2-view 256^2 predict + render at b = 1 (counterpart of
bench.py):

    python -m styl3r_tpu_torch.bench.serve [--iters 30] [--views 2] [--batch 1] [--size 256]
        [--impl auto|jnp|pallas] [--keep-f32-params] [--pair-cap 2] [--extra FILE]
    python -m styl3r_tpu_torch.bench.serve --cpu --tiny --iters 2   # a quick run on the CPU

The full-width model (random weights from seed 0, bf16 backbone, stylizer
and DPT trunks stored in bf16) predicts and renders bench.py's scene with 8
tiles a Gaussian, 2048 pairs a tile and a cap of --pair-cap pair slots a
Gaussian. Prints one JSON line, bench.py's record:

  * `value`: scenes/s of --iters forwards back to back, each input
    perturbed by the previous output, one synchronise at the end (the
    device's throughput, as bench.py's in-jit scan measures it);
  * `latency_ms`: the median of 10 forwards each synchronised, with its
    `encoder_ms` and `render_ms`;
  * `live_pairs_max` / `pair_slots`: the cap is lossless while live pairs
    fit; an overflow prints a WARNING and sets `pair_cap_overflow`;
  * `tflops`, `peak_tflops`, `mfu`: utils/flops.py's FLOPs over `value`'s
    time against the H100's bf16 peak (None on the CPU), `model_gflops`;
  * `host_syncs`: the synchronisations of one forward with the host;
  * `spans`: each span of utils/trace.py in a forward (its total over the
    forward), the median of 10 more forwards with the tracer on, in ms;
  * `device`, `card`: the device, and the card's name and power limit.

--impl jnp renders through the plain compositor (on the card too); pallas
launches the compositor kernel and needs the card. An out-of-memory error
raises: bench.py's ladder of smaller configurations is not ported, so the
record always names what ran.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.styl3r import Batch, Styl3rModel
from ..utils import flops, trace
from .batch import example_batch
from .common import TINY, device_names, flops_dims, no_tf32, resolve_impl, route, route_name, serving_model
from .timing import back_to_back_ms, elapsed_ms, host_syncs, stamp, synchronize

LATENCY_REPS = 10


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--tiny", action="store_true", help="tiny trunk widths at 64^2 (a quick run)")
    parser.add_argument("--iters", type=int, default=30, help="forwards back to back in the timing")
    parser.add_argument("--views", type=int, default=2)
    parser.add_argument("--batch", type=int, default=1, help="scenes per forward")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--impl", default="auto", choices=["auto", "jnp", "pallas"],
                        help="jnp: the plain compositor; pallas: the compositor kernel (the card)")
    parser.add_argument("--keep-f32-params", action="store_true",
                        help="keep f32 weights (bf16 compute by autocast) instead of storing the trunks in bf16")
    parser.add_argument("--extra", default="", help="also write the record to this JSON file")
    parser.add_argument("--pair-cap", type=int, default=2,
                        help="pair_cap_per_gaussian: pair slots kept a Gaussian, lossless while the live pairs fit")
    return parser.parse_args(argv)


def measure(model: Styl3rModel, batch: Batch, hw: Tuple[int, int], render_kwargs: Dict[str, int],
            iters: int) -> Dict[str, object]:
    """One checked forward (its live pairs and pair slots), then the
    throughput of `iters` forwards back to back, the latency of
    LATENCY_REPS synchronised forwards split into encoder and render, the
    host syncs of one forward, and the spans of LATENCY_REPS more forwards
    with the tracer on; under torch.inference_mode."""
    from ..models.decoder import render_gaussians

    dev = batch.context_images.device
    b = batch.context_images.shape[0]
    with torch.inference_mode():
        gaussians, out = model(batch, hw, **render_kwargs)
        if not all(bool(torch.isfinite(x).all()) for x in (*gaussians, out.color, out.depth, out.alpha)):
            raise AssertionError("serve: non-finite Gaussians or render")
        live, slots = int(out.live_pairs.max()), int(out.pair_slots.min())
        del gaussians, out

        def step(carry):
            _, o = model(batch._replace(context_images=batch.context_images + carry), hw, **render_kwargs)
            return o.color.mean() * 1e-12

        ms = back_to_back_ms(step, iters, dev)
        enc_ms, ren_ms = [], []
        for _ in range(LATENCY_REPS):
            t0 = stamp(dev)
            g = model.predict_gaussians(batch)
            t1 = stamp(dev)
            render_gaussians(g, batch.target_extrinsics, batch.target_intrinsics, batch.target_near,
                             batch.target_far, hw, **render_kwargs)
            t2 = stamp(dev)
            synchronize(dev)
            enc_ms.append(elapsed_ms(t0, t1))
            ren_ms.append(elapsed_ms(t1, t2))
        syncs = host_syncs(lambda: model(batch, hw, **render_kwargs))
        trace.drain()
        traced = []
        for _ in range(LATENCY_REPS):
            with trace.enabled():
                model(batch, hw, **render_kwargs)
            traced.append(trace.drain())
    return {
        "ms": ms,
        "scenes_per_sec": b / (ms / 1e3),
        "latency_ms": statistics.median(a + r for a, r in zip(enc_ms, ren_ms)),
        "encoder_ms": statistics.median(enc_ms),
        "render_ms": statistics.median(ren_ms),
        "live_pairs_max": live,
        "pair_slots": slots,
        "host_syncs": syncs,
        "spans": {name: statistics.median(rep.get(name, (0.0, 0))[0] for rep in traced) for name in traced[0]},
    }


def main(argv=None, model: Optional[Styl3rModel] = None) -> Dict[str, object]:
    """Runs the benchmark, prints its record as the last line and returns
    it. `model`, if given, is served in place of the one the flags build
    (its widths must be the flags')."""
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    impl = resolve_impl(args.impl, dev)
    no_tf32()
    dims = TINY if args.tiny else {}
    h = w = 64 if args.tiny else args.size
    if model is None:
        model = serving_model(dev, dims, args.keep_f32_params)
    batch = example_batch(np.random.default_rng(0), b=args.batch, v=args.views, h=h, w=w, t=1, style_hw=h,
                          device=dev)
    render_kwargs = dict(max_tiles_per_gaussian=8, max_per_tile=512 if args.tiny else 2048,
                         pair_cap_per_gaussian=args.pair_cap)
    with route(impl):
        res = measure(model, batch, (h, w), render_kwargs, args.iters)
    record = {
        "metric": (
            f"scenes/sec/chip ({args.views}-view {h}x{w} b={args.batch} predict+render, {route_name(impl)}, "
            f"{'f32' if args.keep_f32_params else 'bf16-trunk'}, mpt={render_kwargs['max_per_tile']}, "
            f"cap={args.pair_cap}, n={args.iters})"
        ),
        "value": round(res["scenes_per_sec"], 4),
        "unit": "scenes/s",
        "vs_baseline": round(res["scenes_per_sec"] / 1.0, 4),
        "live_pairs_max": res["live_pairs_max"],
        "pair_slots": res["pair_slots"],
    }
    if res["live_pairs_max"] > res["pair_slots"]:
        print(f"WARNING: pair_cap OVERFLOW — live pairs {res['live_pairs_max']} > kept slots {res['pair_slots']}; "
              f"the measured render drops content. Raise --pair-cap.", file=sys.stderr)
        record["pair_cap_overflow"] = True
    fwd_flops = flops.styl3r_forward_flops(b=args.batch, v=args.views, h=h, w=w, style_hw=h, n_targets=1,
                                           pair_cap_per_gaussian=args.pair_cap, **flops_dims(dims))["total"]
    util = flops.mfu(fwd_flops, res["ms"] / 1e3)
    on_card = dev.type == "cuda"
    record.update(
        tflops=round(util["tflops"], 3),
        peak_tflops=util["peak_tflops"] if on_card else None,
        mfu=round(util["mfu"], 4) if on_card else None,
        model_gflops=round(fwd_flops / 1e9, 1),
        latency_ms=res["latency_ms"],
        encoder_ms=res["encoder_ms"],
        render_ms=res["render_ms"],
        host_syncs=res["host_syncs"],
        spans=res["spans"],
        **device_names(dev),
    )
    if args.extra:
        with open(args.extra, "w") as f:
            json.dump(record, f, indent=2)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
