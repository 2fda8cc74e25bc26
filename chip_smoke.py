#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (styl3r_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles every kernel under styl3r_tpu_torch/csrc with nvcc;
  3. kernels: holds each kernel against its plain PyTorch version on a dense
     saturating Gaussian cloud at the main path's scale;
  4. main path: the full-width model (ViT-L 24x1024 encoders, 12x768
     decoders, random weights from a seed, bf16 trunks) serves three 2-view
     256^2 scenes through Styl3rModel.forward; every kernel must have been
     launched; then the kernels are held against their plain versions on
     the main path's own inputs, and 10 warm forwards are timed;
  5. kernel times: each kernel's device time (torch.profiler), call time and
     plain version's time (CUDA events), beside its bound;
  6. reference: a tiny-width model's Gaussians on the card agree with the
     same model's on the CPU (whose agreement with the JAX package the CPU
     tests show).
The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_FLOPS = 67e12  # H100 SXM FP32 (non-tensor) peak, 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TOL = 1e-5  # kernel vs plain, f32 values of order 1: rounding only
# Per (pixel, pair) evaluation of the compositor: 11 for the quadratic
# power, 1 exp, 2 for the clamped alpha, 1 weight, 8 for four
# multiply-adds into r, g, b, depth, 2 for the transmittance update.
COMPOSITE_OPS_PER_EVAL = 25


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Median milliseconds of `reps` calls, each between two CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_device_ms(fn, reps, kernel_name):
    """Mean device time of one launch of the CUDA kernel whose name contains
    `kernel_name`, from torch.profiler over `reps` calls of `fn`: the
    kernel's own time, without the host's time to call it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel_name in e.key]
    count = sum(e.count for e in hits)
    if count != reps:
        raise AssertionError(f"profiler saw {count} launches of {kernel_name}, expected {reps}")
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def example_batch(seed, device, v=2, hw=256, t=1):
    """bench.py's scene: v context views + a style image, uniform noise from
    `seed`, one target at the first context camera."""
    import numpy as np

    from styl3r_tpu_torch.models.styl3r import Batch, batch_to

    rng = np.random.default_rng(seed)
    k = np.asarray([[1.1, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1.0]], np.float32)
    return batch_to(Batch(
        context_images=rng.uniform(0, 1, (1, v, hw, hw, 3)),
        context_intrinsics=np.broadcast_to(k, (1, v, 3, 3)),
        target_extrinsics=np.broadcast_to(np.eye(4, dtype=np.float32), (1, t, 4, 4)),
        target_intrinsics=np.broadcast_to(k, (1, t, 3, 3)),
        target_near=np.full((1, t), 1.0),
        target_far=np.full((1, t), 100.0),
        style_image=rng.uniform(0, 1, (1, hw, hw, 3)),
    ), device)


def composite_work(inputs, n_done):
    """(evaluations, bytes) the compositor needs for these inputs: the
    (pixel, pair) evaluations of the pairs in range within the windows each
    tile composited; each pair row read once, outputs written once."""
    import torch

    starts = inputs.starts.long()
    ends = starts + inputs.counts.long()
    walked = (starts // 128) * 128 + 128 * n_done.long()
    pairs = int(torch.clamp(torch.minimum(ends, walked) - starts, min=0).sum())
    n_tiles = starts.numel()
    nbytes = pairs * 48 + n_tiles * 8 + inputs.n_views * 12 + n_tiles * (256 * 24 + 4)
    return pairs * 256, nbytes


def check_composite(inputs, max_per_tile, reps=20):
    """Kernel vs plain on one set of compositor inputs: the largest error,
    the median times of a kernel call and of a plain call (CUDA events), and
    the bound. The kernel's device time is taken later (composite_device_ms),
    after the main path's timing, because the profiler it uses stays
    attached and slows every later launch."""
    import torch

    from styl3r_tpu_torch.ops.rasterizer import composite

    args = (inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds, inputs.grid, max_per_tile, inputs.n_views)
    kern = composite.composite_tiles(*args)
    plain = composite.composite_tiles_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(kern.n_done, plain.n_done):
        raise AssertionError("composite_fwd: n_done differs from the plain version")
    depth_scale = max(1.0, float(plain.depth.abs().max()))
    err = 0.0
    for name in ("color", "alpha", "t_final", "depth"):
        a, b = getattr(kern, name), getattr(plain, name)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"composite_fwd: non-finite {name}")
        e = float((a - b).abs().max())
        limit = TOL * (depth_scale if name == "depth" else 1.0)
        if e > limit:
            raise AssertionError(f"composite_fwd: {name} differs from the plain version by {e} > {limit}")
        err = max(err, e / (depth_scale if name == "depth" else 1.0))
    call_ms = cuda_ms(lambda: composite.composite_tiles(*args), reps)
    plain_ms = cuda_ms(lambda: composite.composite_tiles_plain(*args), max(5, reps // 4))
    evals, nbytes = composite_work(inputs, plain.n_done)
    t_ops = evals * COMPOSITE_OPS_PER_EVAL / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return dict(
        args=args, max_abs_err=err, call_ms=call_ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes", evals=evals,
        n_done_max=int(plain.n_done.max()), alpha_saturated=float((plain.alpha > 0.99).float().mean()),
    )


def composite_device_ms(res, reps=20):
    """Adds the kernel's device time on the inputs that check_composite held."""
    from styl3r_tpu_torch.ops.rasterizer import composite

    res["ms"] = kernel_device_ms(lambda: composite.composite_tiles(*res["args"]), reps, "composite_fwd_kernel")
    return res


def dense_cloud_inputs(device, g=131072, n_views=2, hw=(256, 256), max_per_tile=2048):
    """131,072 isotropic Gaussians (scale 0.02, opacity 0.95) at z ~ 1 seen
    by two cameras at 256^2: multi-window tiles and the early exit."""
    import torch

    from styl3r_tpu_torch.ops.rasterizer.camera import make_raster_camera
    from styl3r_tpu_torch.ops.rasterizer.render import composite_inputs

    gen = torch.Generator(device).manual_seed(7)
    xy = torch.rand(g, 2, generator=gen, device=device) * 0.8 - 0.4
    z = 1.0 + 0.05 * torch.randn(g, generator=gen, device=device)
    means = torch.cat([xy * z[:, None], z[:, None]], 1)
    sh = 0.5 + 0.1 * torch.randn(g, 3, 1, generator=gen, device=device)
    ext = torch.eye(4, device=device).repeat(n_views, 1, 1)
    ext[:, 0, 3] = 0.02 * torch.arange(n_views, device=device)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], device=device).repeat(n_views, 1, 1)
    cams = make_raster_camera(ext, k, torch.full((n_views,), 0.1, device=device),
                              torch.full((n_views,), 100.0, device=device), hw)

    def per_view(x):
        return x[None].expand(n_views, *x.shape)

    return composite_inputs(
        cams, per_view(means), None, per_view(sh), per_view(torch.full((g,), 0.95, device=device)), hw,
        scales=per_view(torch.full((g, 3), 0.02, device=device)),
        rotations=per_view(torch.tensor([0.0, 0.0, 0.0, 1.0], device=device).expand(g, 4)),
        max_tiles_per_gaussian=8, max_per_tile=max_per_tile,
    )


def main_path_inputs(gaussians, batch, hw, render_kwargs):
    """The compositor inputs of render_gaussians for one scene and one
    target (b = v = 1, no scale invariance): the main path's own."""
    import torch

    from styl3r_tpu_torch.ops.rasterizer.camera import make_raster_camera
    from styl3r_tpu_torch.ops.rasterizer.render import composite_inputs

    dev = batch.target_extrinsics.device
    zeros = torch.zeros(1, 3, device=dev)
    cams = make_raster_camera(
        batch.target_extrinsics[0], batch.target_intrinsics[0], batch.target_near[0],
        batch.target_far[0], hw, cam_rot_delta=zeros, cam_trans_delta=zeros,
    )
    g = gaussians.means.shape[1]
    return composite_inputs(
        cams, gaussians.means, None, gaussians.harmonics, gaussians.opacities, hw,
        torch.zeros(1, 3, device=dev), scales=gaussians.scales, rotations=gaussians.rotations,
        max_tiles_per_gaussian=render_kwargs["max_tiles_per_gaussian"],
        max_per_tile=render_kwargs["max_per_tile"],
        pair_cap=render_kwargs["pair_cap_per_gaussian"] * g,
    )


def reference_phase(card):
    """A tiny-width model on the card against the same weights on the CPU,
    whose agreement with the JAX package the CPU tests show: the Gaussians
    are held at 1e-4 of each field's scale (f32 on both, but the card's
    attention and convolutions sum in other orders, and expm1 in the pts3d
    head amplifies that)."""
    import torch

    from styl3r_tpu_torch.models.styl3r import Styl3rModel, batch_to

    tiny = dict(
        enc_depth=2, dec_depth=4, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2,
        head_feature_dim=16, head_last_dim=16, head_layer_dims=(8, 8, 16, 16),
    )
    cpu = Styl3rModel(sh_degree=1, device="cpu", seed=1, **tiny)
    gpu = Styl3rModel(sh_degree=1, device="cuda", seed=1, **tiny)
    gpu.load_state_dict(cpu.state_dict())
    batch = example_batch(5, "cpu", hw=64)
    with torch.inference_mode():
        g_ref = cpu.predict_gaussians(batch)
        g_gpu = gpu.predict_gaussians(batch_to(batch, "cuda"))
    worst = 0.0
    for name in g_ref._fields:
        ref = getattr(g_ref, name)
        err = float((getattr(g_gpu, name).cpu() - ref).abs().max()) / max(1.0, float(ref.abs().max()))
        worst = max(worst, err)
        if err > 1e-4:
            raise AssertionError(f"reference: Gaussians' {name} differ from the CPU by {err} of their scale")
    log(f"reference: tiny model on the card vs the CPU: Gaussians within {worst:.3g} of their scale [{card}]")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from styl3r_tpu_torch.models.styl3r import Styl3rModel
    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.utils import cuda_build, flops

    # f32 stays f32: no TF32 in the f32 matmuls and convs (heads, renderer).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    build_logs = cuda_build.build(cuda_build.KERNELS)
    log(f"build: {len(cuda_build.KERNELS)} kernel(s) for sm_90a in {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- kernels on a dense cloud at the main path's scale ---------------------
    dense = dense_cloud_inputs(dev)
    live = int(dense.live_pairs)
    res_dense = check_composite(dense, 2048)
    if live <= 100_000 or res_dense["alpha_saturated"] <= 0.3:
        raise AssertionError(f"dense cloud too sparse: {live} live pairs, "
                             f"{res_dense['alpha_saturated']:.2f} of pixels saturated")
    log(f"kernel composite_fwd, dense cloud (2 views 256^2, 131072 Gaussians, {live} live pairs, "
        f"{res_dense['alpha_saturated']:.3f} of pixels at alpha > 0.99, up to {res_dense['n_done_max']} windows): "
        f"agrees with the plain version, max err {res_dense['max_abs_err']:.3g}")

    # -- main path -----------------------------------------------------------
    hw = (256, 256)
    render_kwargs = dict(max_tiles_per_gaussian=8, max_per_tile=2048, pair_cap_per_gaussian=2)
    t0 = time.perf_counter()
    model = Styl3rModel(sh_degree=0, backbone_dtype=torch.bfloat16, head_trunk_dtype=torch.bfloat16,
                        device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {n_params:,} parameters (bf16 backbone + stylizer and DPT trunks), "
        f"built in {time.perf_counter() - t0:.1f} s")
    if n_params != 1_043_732_697:
        raise AssertionError(f"parameter count {n_params} is not the full-width model's")

    composite.launches = 0
    with torch.inference_mode():
        for i, seed in enumerate((0, 1, 2)):
            batch = example_batch(seed, dev)
            gaussians, out = model(batch, hw, **render_kwargs)
            torch.cuda.synchronize()
            live, slots = int(out.live_pairs.max()), int(out.pair_slots.min())
            finite = all(bool(torch.isfinite(x).all()) for x in (*gaussians, out.color, out.depth, out.alpha))
            if not finite or out.color.shape != (1, 1, *hw, 3) or gaussians.means.shape != (1, 2 * 256 * 256, 3):
                raise AssertionError(f"scene {seed}: non-finite or misshapen output")
            if not 0 < live <= slots:
                raise AssertionError(f"scene {seed}: live pairs {live}, pair slots {slots}")
            if composite.launches != i + 1:
                raise AssertionError(f"scene {seed}: compositor launches {composite.launches}, expected {i + 1}")
            log(f"scene {seed}: color mean {float(out.color.mean()):.4f}, alpha max {float(out.alpha.max()):.4f}, "
                f"live pairs {live} of {slots} slots, compositor launches {composite.launches}")
    launches = {"composite_fwd": composite.launches}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    with torch.inference_mode():
        res_main = check_composite(main_path_inputs(gaussians, batch, hw, render_kwargs), 2048)
    log(f"kernel composite_fwd, main path's own inputs: agrees with the plain version, "
        f"max err {res_main['max_abs_err']:.3g}")

    # -- timing: 10 warm forwards, encoder and render split --------------------
    from styl3r_tpu_torch.models.decoder import render_gaussians

    enc_ms, ren_ms = [], []
    with torch.inference_mode():
        for _ in range(10):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            g = model.predict_gaussians(batch)
            e[1].record()
            render_gaussians(g, batch.target_extrinsics, batch.target_intrinsics, batch.target_near,
                             batch.target_far, hw, **render_kwargs)
            e[2].record()
            torch.cuda.synchronize()
            enc_ms.append(e[0].elapsed_time(e[1]))
            ren_ms.append(e[1].elapsed_time(e[2]))
    total = [a + b for a, b in zip(enc_ms, ren_ms)]
    step_ms = statistics.median(total)
    fwd_flops = flops.styl3r_forward_flops(b=1, v=2, h=256, w=256, style_hw=256, n_targets=1,
                                           pair_cap_per_gaussian=2)["total"]
    util = flops.mfu(fwd_flops, step_ms / 1e3)
    log(f"main path: {1e3 / step_ms:.3f} scenes/s, {step_ms:.2f} ms/scene (encoder "
        f"{statistics.median(enc_ms):.2f} ms, render {statistics.median(ren_ms):.2f} ms; median of 10), "
        f"{util['tflops']:.1f} TFLOP/s = MFU {util['mfu']:.4f} of 989 TFLOP/s bf16 [{card}]")

    # -- kernel times: device time from the profiler, after the main path's
    # timing, which the profiler's attached tracing would slow down ---------
    for what, res in (("dense cloud", res_dense), ("main path's own inputs", res_main)):
        composite_device_ms(res)
        log(f"kernel composite_fwd, {what}: {res['ms']:.4f} ms on the device, {res['call_ms']:.4f} ms a call "
            f"(CUDA events, median of 20), plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.5f} ms "
            f"({res['bound_by']}, {res['evals']} pixel-pair evaluations) [{card}]")

    reference_phase(card)

    kernels = [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "styl3r_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "styl3r_tpu/ops/rasterizer/pallas_kernel.py:151",
        "launches": launches["composite_fwd"],
        "max_abs_err": max(res_dense["max_abs_err"], res_main["max_abs_err"]),
        "ms": res_main["ms"],
        "call_ms": res_main["call_ms"],
        "plain_ms": res_main["plain_ms"],
        "bound_ms": res_main["bound_ms"],
        "bound_by": res_main["bound_by"],
        "library_ms": None,
        "dense_cloud": {k: res_dense[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "evals")},
    }]
    print(json.dumps({"kernels": kernels, "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
