"""Serving in a closed loop: one client hands over a request's host
arrays, waits until its renders are back on the host, and sends the next.
A request is `traffic.batch` scenes predicted and rendered by
Styl3rModel.forward (predict_gaussians, then render_gaussians) under
inference mode. A request whose live pairs exceed its kept pair slots has
dropped content and counts as failed.

End to end: `latency_p95_ms` (all requests of the window, host clock) and
`scenes_per_s` (scenes back on the host over the window's seconds).
Traced run: spans around predict_gaussians and render_gaussians over the
window, the host's syncs in one request, and a profiled slice of
`trace_requests` requests whose compositor inputs are kept for the
roofline count.

Check, after the window: for a sample of the finished requests, drawn
from the seed, and the window's last, the reference works the Gaussians
out again in float32 from the same host arrays, and renders the program's
Gaussians with the reference renderer; both are compared with the
program's answers."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from ..core import Context, Outcome, Spans, free, limits_checks, pick, profiled, quantile, rel_l2, synchronize, widths
from ..counts import flops
from ..program import serving_model
from ..reference import lowprec
from ..reference.init import drawn
from ..reference.model import Styl3rRef, batch_on
from ..scenes import pool
from ..timing import host_syncs

GAUSSIAN_FIELDS = ("means", "covariances", "harmonics", "opacities")
RENDER_FIELDS = ("color", "depth", "alpha")


def make_request(model, hw: Tuple[int, int], render: Dict[str, int], device: torch.device):
    """request(arrays) -> (gaussians on the device, (color, depth, alpha) on
    the host, dropped): one request of the timed path."""
    from styl3r_tpu_torch.models.styl3r import batch_to

    def request(arrays):
        with torch.inference_mode():
            batch = batch_to(arrays, device)
            gaussians, out = model(batch, hw, **render)
            rendered = (out.color.cpu(), out.depth.cpu(), out.alpha.cpu())
            dropped = bool((out.live_pairs > out.pair_slots).any())
        return gaussians, rendered, dropped

    return request


def reference_model(config: dict, device: torch.device) -> Styl3rRef:
    return drawn(lambda: Styl3rRef(sh_degree=config["sh_degree"], **widths(config)),
                 config["weight_seed"], device).eval()


def low_precision_parts(ref: Styl3rRef) -> List[torch.nn.Module]:
    """The modules the serving configuration computes in bfloat16: the
    backbone, the stylizer, and each DPT head's trunk (what cast_dtypes
    stores in bfloat16)."""
    enc = ref.encoder
    parts = [enc.backbone, enc.token_stylizer]
    for head in enc.heads():
        parts += [head.dpt.act_postprocess, head.dpt.scratch, head.dpt.head["0"]]
        if getattr(head.dpt, "input_merger", None) is not None:
            parts.append(head.dpt.input_merger)
    return parts


def control_request(ref: Styl3rRef, hw, render, device):
    """The control in the program's place: the reference one precision step
    below the configuration (fp8 where it states bfloat16, TF32 where it
    states float32 matmuls and convolutions, bfloat16 in the compositor)."""
    def request(arrays):
        with lowprec.fp8_layers(low_precision_parts(ref)), lowprec.tf32(), lowprec.bf16_compositor(), \
                torch.no_grad():
            gaussians, out = ref(batch_on(arrays, device), hw, **render)
        return gaussians, (out.color.cpu(), out.depth.cpu(), out.alpha.cpu()), False
    return request


def compare(answers: Dict[int, tuple], scenes: list, ref: Styl3rRef, hw, render, device) -> Dict[str, float]:
    """The worst relative L2 gap (float64) over the compared requests of
    each Gaussian field against the reference's own Gaussians (worked out
    from the same host arrays), and of each render against the reference
    renderer's image of the program's Gaussians (the renderer judged on
    its own input). `answers` maps a request's index to the program's
    (gaussians on the host, (color, depth, alpha)); request i served scene
    i mod len(scenes)."""
    from ..reference.decoder import render_gaussians

    worst = {f"{name}_rel_l2": 0.0 for name in (*GAUSSIAN_FIELDS, *RENDER_FIELDS)}
    for i, (gaussians, rendered) in answers.items():
        batch = batch_on(scenes[i % len(scenes)], device)
        with torch.no_grad():
            ref_g = ref.predict_gaussians(batch)
        on_device = type(gaussians)(*(None if x is None else x.to(device) for x in gaussians))
        with torch.no_grad():
            out = render_gaussians(on_device, batch.target_extrinsics, batch.target_intrinsics, batch.target_near,
                                   batch.target_far, hw, **render)
        ref_r = (out.color, out.depth, out.alpha)
        pairs = [(f, getattr(gaussians, f), getattr(ref_g, f)) for f in GAUSSIAN_FIELDS]
        pairs += list(zip(RENDER_FIELDS, rendered, ref_r))
        for name, a, b in pairs:
            key = f"{name}_rel_l2"
            worst[key] = max(worst[key], rel_l2(a, b))
    worst["gaussians_rel_l2"] = max(worst[f"{f}_rel_l2"] for f in GAUSSIAN_FIELDS)
    worst["render_rel_l2"] = max(worst[f"{f}_rel_l2"] for f in RENDER_FIELDS)
    return worst


def host_gaussians(gaussians):
    return type(gaussians)(*(None if x is None else x.float().cpu() for x in gaussians))


def run(ctx: Context, program_request=None) -> Outcome:
    """`program_request`, if given, replaces the program's request (the
    tests break the timed path with it)."""
    from styl3r_tpu_torch.models import styl3r as styl3r_module
    from styl3r_tpu_torch.ops.rasterizer import composite

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    tr, render = wl["traffic_parameters"], wl["render"]
    hw = (tr["size"], tr["size"])
    lowprec.no_tf32()
    model = serving_model(cfg, dev)
    scenes = pool(ctx.seed, tr)
    request = (program_request or make_request)(model, hw, render, dev)
    for k in range(wl["warmup"]):
        request(scenes[k % len(scenes)])

    spans = Spans(dev) if ctx.trace else None
    render_gaussians = styl3r_module.render_gaussians
    if spans:
        model.predict_gaussians = spans.wrap("encoder", model.predict_gaussians)
        styl3r_module.render_gaussians = spans.wrap("renderer", render_gaussians)
    check = wl["check"]
    sample = set(pick(ctx.seed, check["sample"], check["sample_among"]))
    kept, latencies, failed = {}, [], 0
    ctx.setup_done()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        gaussians, rendered, dropped = request(scenes[i % len(scenes)])
        latencies.append(time.perf_counter() - t)
        failed += dropped
        if i in sample:
            kept[i] = (gaussians, rendered)
        last = (i, gaussians, rendered)
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kept[last[0]] = last[1:]
    del last
    n = len(latencies)
    scenes_done = n * tr["batch"]
    end_to_end = {
        "latency_p95_ms": 1e3 * quantile(latencies, 0.95),
        "scenes_per_s": scenes_done / window_s,
    }
    record = {
        "calls": n, "scenes": scenes_done, "window_s": window_s, "window_peak_bytes": peak,
        "latencies_ms": [1e3 * x for x in latencies],
        "flops_per_call": flops.styl3r_forward_flops(
            b=tr["batch"], v=tr["views"], h=hw[0], w=hw[1], style_hw=tr.get("style_size", hw[0]),
            n_targets=tr["targets"], pair_cap_per_gaussian=render.get("pair_cap_per_gaussian", 0),
            **flops.dims(cfg["widths"]))["total"],
    }
    if spans:
        del model.predict_gaussians
        styl3r_module.render_gaussians = render_gaussians
        record["spans_ms"] = spans.ms()
        if dev.type == "cuda":
            record["host_syncs"] = host_syncs(lambda: request(scenes[0]))
            captured = []
            launch = composite.composite_tiles

            def capture(*args):
                captured.append(args)
                return launch(*args)

            composite.composite_tiles = capture
            calls = iter(range(10**9))
            try:
                record["trace"] = profiled(lambda: request(scenes[next(calls) % len(scenes)]), wl["trace_requests"])
            finally:
                composite.composite_tiles = launch
            record["trace_calls"] = wl["trace_requests"]
            record["composite_inputs"] = captured

    answers = {j: (host_gaussians(g), r) for j, (g, r) in kept.items()}
    del kept, model, request
    free(dev)
    ref = reference_model(cfg, dev)
    values = compare(answers, scenes, ref, hw, render, dev)
    del ref
    free(dev)
    return Outcome(attempted=n, failed=failed, end_to_end=end_to_end, record=record,
                   memory_peak_bytes=peak, checks=limits_checks(values, check["limits"]))



def readings(ctx: Context, seeds, control_seeds, last_index: int = 150):
    """The compared numbers of sound program runs on `seeds` and of the
    control on `control_seeds`, in one process (portbench/calibrate.py):
    each seed's sample of requests, as a window would draw it, plus request
    `last_index`, served by the timed path's request function."""
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    tr, render = wl["traffic_parameters"], wl["render"]
    hw = (tr["size"], tr["size"])
    lowprec.no_tf32()
    model = serving_model(cfg, dev)
    request = make_request(model, hw, render, dev)
    ref = reference_model(cfg, dev)
    control = control_request(ref, hw, render, dev)
    check = wl["check"]
    out = []
    for kind, seed in [("program", s) for s in seeds] + [("control", s) for s in control_seeds]:
        scenes = pool(seed, tr)
        serve = request if kind == "program" else control
        for k in range(wl["warmup"] if kind == "program" else 0):
            serve(scenes[k % len(scenes)])
        answers = {}
        for i in pick(seed, check["sample"], check["sample_among"]) + [last_index]:
            g, rendered, _ = serve(scenes[i % len(scenes)])
            answers[i] = (host_gaussians(g), rendered)
        out.append(dict(kind=kind, seed=seed, **compare(answers, scenes, ref, hw, render, dev)))
        ctx.log(str(out[-1]))
    return out
