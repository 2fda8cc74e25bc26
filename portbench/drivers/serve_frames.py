"""Scene reconstruction in a closed loop: one client hands over a request's
host arrays, `traffic.frames` unposed views of one scene, waits until every
view's pose encoding, depth, depth confidence, world points and point
confidence (float32) are back on the host, and sends the next. A request is
one forward of styl3r_tpu_torch's VGGT (models/vggt.py) under inference
mode: the aggregator in the configuration's autocast dtype over float32
weights, the heads in float32, with the configuration's TF32 settings.

End to end: `latency_p95_ms` (all requests of the window, host clock).
Traced run: a profiled slice of `trace_requests` requests, in which the
program's spans (patch_embed, frame_blocks, global_blocks, camera_head,
heads, rope) record, and the forward's attention calls, kept for the
attention roofline.

Check, after the window, with the program freed: for a sample of the
finished requests, drawn from the seed, and the window's last, the reference
(portbench/reference/vggt.py, float32, TF32 off) works the answers out again
from the same host arrays; the worst relative L2 gap of each output over
the sample is compared with its limit."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..core import DTYPES, Context, Outcome, free, limits_checks, pick, profiled, quantile, rel_l2, synchronize
from ..counts import vggt as counts
from ..reference import lowprec
from ..reference import vggt as reference

FIELDS = ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf")


def widths(cfg: dict) -> dict:
    w = dict(cfg["widths"])
    w["head_out_channels"] = tuple(w["head_out_channels"])
    w["head_layers"] = tuple(w["head_layers"])
    return w


def pool(seed: int, tr: dict) -> List[np.ndarray]:
    """`traffic.pool` scenes drawn from the seed on the host: (batch,
    frames, 3, height, width) float32 images in [0, 1]; scene k from the
    seed and k alone."""
    shape = (tr["batch"], tr["frames"], 3, tr["height"], tr["width"])
    return [np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, k]).random(shape, dtype=np.float32)
            for k in range(tr["pool"])]


def set_tf32(cfg: dict) -> None:
    """The configuration's TF32 settings for the program."""
    torch.backends.cuda.matmul.allow_tf32 = cfg["precision"]["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["precision"]["cudnn_tf32"]


def reference_model(cfg: dict, device: torch.device):
    return reference.draw(cfg["weight_seed"], device, **widths(cfg))


def program_model(cfg: dict, device: torch.device):
    """VGGT as the configuration states it, with the benchmark's weights
    (the reference's, drawn from the weight seed) loaded by key name."""
    from styl3r_tpu_torch.models.registry import get_model

    model = get_model("vggt", **widths(cfg), compute_dtype=DTYPES[cfg["precision"]["aggregator_dtype"]],
                      device=device, seed=cfg["weight_seed"])
    ref = reference_model(cfg, device)
    model.load_state_dict(ref.state_dict())
    del ref
    free(device)
    return model.eval()


def make_request(model, device: torch.device):
    """request(arrays) -> the outputs on the host (float32)."""
    def request(arrays):
        with torch.inference_mode():
            out = model(torch.from_numpy(arrays).to(device))
            return {k: out[k].float().cpu() for k in FIELDS}
    return request


def control_request(ref, device: torch.device):
    """The control in the program's place: the reference one precision step
    below the configuration, fp8 (e4m3) inputs and weights in each of the
    aggregator's linears and convolutions and the heads in bfloat16."""
    def request(arrays):
        with lowprec.fp8_layers([ref.aggregator]), torch.no_grad():
            out = ref(torch.from_numpy(arrays).to(device), heads_dtype=torch.bfloat16)
        return {k: out[k].cpu() for k in FIELDS}
    return request


def compare(answers: Dict[int, dict], scenes: list, ref, device: torch.device) -> Dict[str, float]:
    """The worst relative L2 gap (float64) over the compared requests of
    each output against the reference's from the same host arrays: pose
    encodings, depth, world points, and the larger of the two confidences'.
    Request i served scene i mod len(scenes)."""
    worst = {"pose_rel_l2": 0.0, "depth_rel_l2": 0.0, "points_rel_l2": 0.0, "conf_rel_l2": 0.0}
    for i, got in answers.items():
        with torch.no_grad():
            want = ref(torch.from_numpy(scenes[i % len(scenes)]).to(device))
        gaps = {"pose_rel_l2": rel_l2(got["pose_enc"], want["pose_enc"]),
                "depth_rel_l2": rel_l2(got["depth"], want["depth"]),
                "points_rel_l2": rel_l2(got["world_points"], want["world_points"]),
                "conf_rel_l2": max(rel_l2(got["depth_conf"], want["depth_conf"]),
                                   rel_l2(got["world_points_conf"], want["world_points_conf"]))}
        del want
        worst = {k: max(v, gaps[k]) for k, v in worst.items()}
    return worst


def run(ctx: Context) -> Outcome:
    from styl3r_tpu_torch.models import vggt  # noqa: F401  (a program without VGGT stops here)

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    tr = wl["traffic_parameters"]
    set_tf32(cfg)
    model = program_model(cfg, dev)
    scenes = pool(ctx.seed, tr)
    request = make_request(model, dev)
    for k in range(wl["warmup"]):
        request(scenes[k % len(scenes)])
    check = wl["check"]
    sample = set(pick(ctx.seed, check["sample"], check["sample_among"]))
    kept, latencies = {}, []
    ctx.setup_done()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        out = request(scenes[i % len(scenes)])
        latencies.append(time.perf_counter() - t)
        if i in sample:
            kept[i] = out
        last = (i, out)
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kept[last[0]] = last[1]
    del last, out
    n = len(latencies)
    shape = (tr["batch"], tr["frames"], tr["height"], tr["width"])
    record = {
        "calls": n, "window_s": window_s, "window_peak_bytes": peak,
        "latencies_ms": [1e3 * x for x in latencies],
        "flops_per_call": counts.forward_flops(widths(cfg), *shape)["total"],
    }
    if ctx.trace and dev.type == "cuda":
        calls = iter(range(10**9))
        record["trace"] = profiled(lambda: request(scenes[next(calls) % len(scenes)]), wl["trace_requests"])
        record["trace_calls"] = wl["trace_requests"]
        record["attention_calls"] = counts.attention_calls(widths(cfg), *shape) * wl["trace_requests"]
    del model, request
    free(dev)
    lowprec.no_tf32()
    ref = reference_model(cfg, dev)
    values = compare(kept, scenes, ref, dev)
    ctx.log("check: " + ", ".join(f"{k}={v}" for k, v in values.items()))
    del ref
    free(dev)
    return Outcome(attempted=n, failed=0, end_to_end={"latency_p95_ms": 1e3 * quantile(latencies, 0.95)},
                   record=record, memory_peak_bytes=peak, checks=limits_checks(values, check["limits"]))


def readings(ctx: Context, seeds, control_seeds, last_index: int = 80):
    """The compared numbers of sound program runs on `seeds` and of the
    control on `control_seeds`, in one process (portbench/calibrate.py):
    each seed's sample of requests, as a window would draw it, plus request
    `last_index`. The program and the reference are not held at once."""
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    tr = wl["traffic_parameters"]
    check = wl["check"]
    answers = {}
    set_tf32(cfg)
    model = program_model(cfg, dev)
    request = make_request(model, dev)
    for k in range(wl["warmup"]):
        request(pool(0, tr)[0])
    for seed in seeds:
        scenes = pool(seed, tr)
        answers[("program", seed)] = {i: request(scenes[i % len(scenes)])
                                      for i in pick(seed, check["sample"], check["sample_among"]) + [last_index]}
    del model, request
    free(dev)
    lowprec.no_tf32()
    ref = reference_model(cfg, dev)
    if control_seeds:
        control = control_request(ref, dev)
        for seed in control_seeds:
            scenes = pool(seed, tr)
            answers[("control", seed)] = {i: control(scenes[i % len(scenes)])
                                          for i in pick(seed, check["sample"], check["sample_among"]) + [last_index]}
    out = []
    for (kind, seed), got in answers.items():
        out.append(dict(kind=kind, seed=seed, **compare(got, pool(seed, tr), ref, dev)))
        ctx.log(str(out[-1]))
    return out
