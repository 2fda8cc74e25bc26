#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one NVIDIA GPU.

    python3 scripts/profile_port.py [--out chiprun_out/profile_port]

Builds the model that chip_smoke.py serves (full width, random weights from a
seed, bf16 backbone/stylizer and DPT trunks) on one 2-view 256^2 scene, then
prints:
  * the time of each stage (the encoder's top-level modules, the adapter and
    the render), from CUDA events recorded by module hooks, median over
    ITERS warm forwards;
  * the host-clock time of ITERS forwards with no profiler attached;
  * from torch.profiler over ITERS more forwards: the device time per
    forward, its share of the profiled window and of the unprofiled time,
    and the kernels that take the most device time.
The profiler's table also goes to `--out`.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 5
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def stage_times(model, batch, hw, render_kwargs, iters):
    """Median ms of each top-level encoder module and of the render, from
    CUDA events at module boundaries. 'adapter' is what lies between the
    last head and the end of predict_gaussians."""
    from styl3r_tpu_torch.models.decoder import render_gaussians

    enc = model.encoder
    events = {}
    hooks = []
    for name, mod in enc.named_children():
        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.setdefault(name, []).append([ev, None])

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev

        hooks.append(mod.register_forward_pre_hook(pre))
        hooks.append(mod.register_forward_hook(post))
    rows = {}
    try:
        for _ in range(iters):
            events.clear()
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            g = model.predict_gaussians(batch)
            e[1].record()
            render_gaussians(g, batch.target_extrinsics, batch.target_intrinsics, batch.target_near,
                             batch.target_far, hw, **render_kwargs)
            e[2].record()
            torch.cuda.synchronize()
            last_head_end = max((pair[1] for v in events.values() for pair in v),
                                key=lambda ev: e[0].elapsed_time(ev))
            per = {name: sum(a.elapsed_time(b) for a, b in v) for name, v in events.items()}
            per["adapter"] = last_head_end.elapsed_time(e[1])
            per["encoder total"] = e[0].elapsed_time(e[1])
            per["render"] = e[1].elapsed_time(e[2])
            for k, v in per.items():
                rows.setdefault(k, []).append(v)
    finally:
        for h in hooks:
            h.remove()
    return {k: statistics.median(v) for k, v in rows.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "profile_port"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from styl3r_tpu_torch.models.styl3r import Styl3rModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    hw = (256, 256)
    render_kwargs = dict(max_tiles_per_gaussian=8, max_per_tile=2048, pair_cap_per_gaussian=2)
    model = Styl3rModel(sh_degree=0, backbone_dtype=torch.bfloat16, head_trunk_dtype=torch.bfloat16,
                        device=dev, seed=0).cast_dtypes()  # bf16 storage for serving
    batch = chip_smoke.example_batch(0, dev)
    with torch.inference_mode():
        for _ in range(3):
            model(batch, hw, **render_kwargs)
        torch.cuda.synchronize()
        stages = stage_times(model, batch, hw, render_kwargs, ITERS)
        print(f"stages, ms (median of {ITERS}) [{card}]:", flush=True)
        for k, v in stages.items():
            print(f"  {k:28s} {v:9.3f}", flush=True)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            model(batch, hw, **render_kwargs)
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ITERS):
                model(batch, hw, **render_kwargs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    device_ms = device_us / 1e3 / ITERS
    busy, busy_unprofiled = device_ms / wall_ms, device_ms / plain_wall_ms
    print(f"profiler: device busy {device_ms:.2f} ms/forward = {busy:.3f} of the profiled window "
          f"({wall_ms:.2f} ms/forward on the host clock) and {busy_unprofiled:.3f} of the unprofiled "
          f"time ({plain_wall_ms:.2f} ms/forward), {launches / ITERS:.0f} device kernels/forward [{card}]",
          flush=True)
    table = events.table(sort_by="self_device_time_total", row_limit=40, max_name_column_width=70)
    print(table, flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "table.txt"), "w") as f:
        f.write(table)
    print(json.dumps({"card": card, "stages_ms": stages, "unprofiled_ms_per_forward": plain_wall_ms,
                      "profiled_ms_per_forward": wall_ms, "device_ms_per_forward": device_ms,
                      "device_busy_profiled": busy, "device_busy_unprofiled": busy_unprofiled,
                      "kernels_per_forward": launches / ITERS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
