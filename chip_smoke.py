#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (styl3r_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles every kernel under styl3r_tpu_torch/csrc with nvcc, all
     at once;
  3. kernels: holds each kernel against its plain PyTorch version on a dense
     saturating Gaussian cloud at the main path's scale (the backward with
     cotangents from a seeded generator; two calls of each kernel bitwise
     equal); prints the windows each tile has in range and walked;
  4. serving path: the full-width model (ViT-L 24x1024 encoders, 12x768
     decoders, random weights from a seed, bf16 backbone/stylizer and DPT
     trunks stored in bf16) serves three 2-view 256^2 scenes through
     Styl3rModel.forward; the forward compositor must have been launched
     once a scene; then it is held against its plain version on the path's
     own inputs, and 10 warm forwards are timed;
  5. inference path: the same model through the inference entry points'
     flow, styl3r_tpu_torch.infer.cli.run_scene_inference, on a synthetic
     scene (2 context views, 3 targets, a style image, all 256^2): two
     predicts, 100 pose-alignment steps (each launching the forward and the
     backward compositor once), two renders and a 60-frame video (six
     launches); every output file is checked, and the phases timed with
     CUDA events. Both kernels are then held against their plain versions
     on the alignment's own inputs, the forward also on the video's, and
     the camera deltas' gradients of the whole render, kernels against
     plain versions; then two 4-view predicts + renders, and pose recovery
     on a synthetic cloud of 131,072 Gaussians (the error falls below 0.3x
     of its start; both kernels held on its first step's inputs);
  6. evaluation entry points, at full width with random weights (f32
     compute, as the JAX scripts'), on two synthetic RE10K test scenes with
     an evaluation index of 2 context views and 3 targets each:
     styl3r_tpu_torch.eval.evaluate.main with 100 pose-alignment steps a
     scene (each launching each kernel once) and the renders saved (scores,
     benchmark and peak-memory JSON, 3 PNGs a scene; its predict, alignment
     and render times from benchmark.json); eval.compute_metrics.main on
     those PNGs against the targets' (its PSNR within 0.1 dB of
     scores.json's); eval.eval_pose.main with 200 refinement steps a scene
     (each launching each kernel once; finite AUCs; CUDA events around each
     refinement). Both kernels are held against their plain versions on a
     refinement's own first step (the scene whose PnP pose sees the most
     Gaussians), the backward on the MSE + SSIM loss's cotangents; then the
     refinement recovers a 2-degree perturbation on a synthetic cloud of
     131,072 Gaussians at 256^2 (the rotation error falls below 0.3x of its
     start in 200 steps), and both kernels are held on its first step's
     inputs too;
  7. training, stage 1: the full-width model with f32 master weights, bf16
     compute and scratch_init_heads; both kernels are held against their
     plain versions on the path's own inputs (the backward with MSE
     cotangents); then 2 warm and 5 timed steps of make_train_step (MSE,
     make_optimizer) on b = 2 2-view 256^2 scenes, each of which launches
     each compositor kernel once; the warm steps' gradients reach the
     geometry heads;
  8. training, stage 2: the same model, back at its scratch-initialized
     weights, and batch, make_stage2_optimizer and style 10 + identity with
     VGG19 at random weights; every step launches
     each kernel twice, leaves the frozen parameters bitwise unchanged and,
     from the second step, changes the stylizer and the appearance head;
  9. training entry point: styl3r_tpu_torch.train.main.main on the paper's
     stage 2 (configs/experiment/re10k_3view_style.yaml, full width, 3
     context views + 4 targets at 256^2, no pair cap) over synthetic RE10K
     chunks (360x640 noise JPEGs), 4 steps at b = 2 with a validation and a
     checkpoint every 2 steps; each step launches each kernel twice, each
     validation the forward 4 times; the validation images and checkpoints
     are checked, and the run is repeated as 2 steps plus a resume from
     their step-2 checkpoint, whose losses and last weights must match the
     uninterrupted run's. Step, validation and checkpoint times and sizes
     are read from the run's metrics.jsonl. Both kernels are held
     against their plain versions on the first step's own inputs and the
     forward on the first validation's orthographic projection;
 10. kernel times: each kernel's device time (torch.profiler, summed over
     the backward's two launches a call) and launch shape (grid, block and
     registers a thread, from the profiler's trace of the same calls), call
     time and plain version's time (CUDA events), beside its bound;
 11. reference: a tiny-width model's Gaussians on the card agree with the
     same model's on the CPU (whose agreement with the JAX package the CPU
     tests show).
The line before the last is a JSON object with every kernel's numbers; the
last line is {"ok": true, "device": {...}}.
"""

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_FLOPS = 67e12  # H100 SXM FP32 (non-tensor) peak, 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TOL = 1e-5  # kernel vs plain, f32 values of order 1: rounding only
# Backward kernel vs plain: each pair's gradients are sums over 256 pixels
# taken in another order, and the window-level reconstruction divides by
# products of (1 - alpha), so 1e-4 of each gradient column's largest
# magnitude. Pairs no window walked must be exactly 0 in both.
BWD_TOL = 1e-4
# Per (pixel, pair) evaluation of the compositor: 11 for the quadratic
# power, 1 exp, 2 for the clamped alpha, 1 weight, 8 for four
# multiply-adds into r, g, b, depth, 2 for the transmittance update.
COMPOSITE_OPS_PER_EVAL = 25
# Per (pixel, pair) evaluation of the backward, each operation the function
# needs counted once (a transcendental counts 1): offsets 2, power 9, clamped
# alpha with its exp 4, masks 2, log1p 2, window sum 1, T_i 4, weight 1, q 7,
# color/depth grads 4, live 1, dalpha 9, geometry and opacity grads 18,
# suffix 2, and 10 for the sums over pixels of the ten gradient columns.
# csrc/composite_bwd.cu recomputes the first 19 (all before the window sum)
# in its second pass; that is its own cost and not in the bound.
COMPOSITE_BWD_OPS_PER_EVAL = 76


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


def kernel_device_ms(fn, reps, kernel_names, attempts=3):
    """Device time of one call of `fn`, summed over the CUDA kernels it
    launches, from torch.profiler over `reps` calls: each name in
    `kernel_names` must match kernels launched once a call. Returns the sum,
    each kernel's mean time a call (the kernels' own time, without the
    host's time to call them) and each kernel's launch shape in the same
    calls (launch_shapes). The profiler on the card now and then records
    fewer launches than were made; such a window is measured again, up to
    `attempts` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        each, lost = {}, None
        for name in kernel_names:
            hits = [e for e in prof.key_averages() if name in e.key]
            count = sum(e.count for e in hits)
            if count != reps:
                lost = f"profiler saw {count} launches of {name}, expected {reps}"
                break
            each[name] = sum(e.self_device_time_total for e in hits) / count / 1e3
        if lost is None:
            return sum(each.values()), each, launch_shapes(prof, kernel_names)
        log(f"{lost}; measuring again")
    raise AssertionError(lost)


def launch_shapes(prof, kernel_names):
    """Each named kernel's launch as the profiler's trace recorded it:
    {name: {"grid": [x, y, z], "block": [x, y, z], "registers": n}}, the
    registers a thread; raises if the calls launched a kernel in more than
    one shape."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    shapes = {}
    for name in kernel_names:
        seen = {
            (tuple(e["args"]["grid"]), tuple(e["args"]["block"]), e["args"]["registers per thread"])
            for e in events if e.get("cat") == "kernel" and name in e.get("name", "")
        }
        if len(seen) != 1:
            raise AssertionError(f"profiler trace: {name} launched in {len(seen)} shapes: {sorted(seen)}")
        grid, block, regs = seen.pop()
        shapes[name] = {"grid": list(grid), "block": list(block), "registers": regs}
    return shapes


def shape_text(shape):
    blocks = shape["grid"][0] * shape["grid"][1] * shape["grid"][2]
    return (f"{blocks} blocks (grid {'x'.join(map(str, shape['grid']))}) of "
            f"{shape['block'][0] * shape['block'][1] * shape['block'][2]} threads, "
            f"{shape['registers']} registers a thread")


def example_batch(seed, device, v=2, hw=256, t=1, b=1, targets=False):
    """bench.py's scene (bench_train_step.py's with b > 1): v context views
    + a style image, uniform noise from `seed`, t targets at the first
    context camera, with target images if `targets`."""
    import numpy as np

    from styl3r_tpu_torch.models.styl3r import Batch, batch_to

    rng = np.random.default_rng(seed)
    k = np.asarray([[1.1, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1.0]], np.float32)
    return batch_to(Batch(
        context_images=rng.uniform(0, 1, (b, v, hw, hw, 3)),
        context_intrinsics=np.broadcast_to(k, (b, v, 3, 3)),
        target_extrinsics=np.broadcast_to(np.eye(4, dtype=np.float32), (b, t, 4, 4)),
        target_intrinsics=np.broadcast_to(k, (b, t, 3, 3)),
        target_near=np.full((b, t), 1.0),
        target_far=np.full((b, t), 100.0),
        style_image=rng.uniform(0, 1, (b, hw, hw, 3)),
        target_images=rng.uniform(0, 1, (b, t, hw, hw, 3)) if targets else None,
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


def window_counts(inputs, max_per_tile, n_done):
    """The windows each tile has in range (its clamped count from its
    aligned base, at most max_windows) and those it walked (n_done): sum,
    mean and max over the tiles."""
    import torch

    from styl3r_tpu_torch.ops.rasterizer import composite

    starts = inputs.starts.long()
    ends = starts + inputs.counts.long()
    in_range = torch.clamp((ends - (starts // 128) * 128 + 127) // 128, max=composite.max_windows(max_per_tile))
    return {name: {"sum": int(x.sum()), "mean": float(x.float().mean()), "max": int(x.max())}
            for name, x in (("in_range", in_range), ("walked", n_done.long()))}


def check_composite(inputs, max_per_tile, reps=20):
    """Kernel vs plain on one set of compositor inputs: the largest error,
    two kernel calls bitwise equal, the median times of a kernel call and of
    a plain call (CUDA events), the bound, and the windows in range and
    walked. The kernel's device time and launch shape are taken
    later (composite_device_ms), after the main path's timing, because the
    profiler it uses stays attached and slows every later launch."""
    import torch

    from styl3r_tpu_torch.ops.rasterizer import composite

    args = (inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds, inputs.grid, max_per_tile, inputs.n_views)
    kern = composite.composite_tiles(*args)
    plain = composite.composite_tiles_plain(*args)
    again = composite.composite_tiles(*args)
    torch.cuda.synchronize()
    if not torch.equal(kern.n_done, plain.n_done):
        raise AssertionError("composite_fwd: n_done differs from the plain version")
    if not all(torch.equal(a, b) for a, b in zip(kern, again)):
        raise AssertionError("composite_fwd: two calls on the same inputs differ")
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
        windows=window_counts(inputs, max_per_tile, plain.n_done),
    )


def fwd_windows_line(res):
    win = res["windows"]
    return (f"windows a tile in range: sum {win['in_range']['sum']}, mean {win['in_range']['mean']:.3f}, max "
            f"{win['in_range']['max']}; walked: sum {win['walked']['sum']}, mean {win['walked']['mean']:.3f}, max "
            f"{win['walked']['max']}; two calls bitwise equal")


def composite_device_ms(res, reps=20):
    """Adds the kernel's device time and launch shape on the inputs that
    check_composite held, with the threads a pixel and blocks a tile that
    shape gives."""
    from styl3r_tpu_torch.ops.rasterizer import composite

    res["ms"], _, shapes = kernel_device_ms(lambda: composite.composite_tiles(*res["args"]), reps,
                                            ("composite_fwd_kernel",))
    shape = shapes["composite_fwd_kernel"]
    n_tiles = res["args"][1].numel()
    blocks = shape["grid"][0] * shape["grid"][1] * shape["grid"][2]
    threads = blocks * shape["block"][0] * shape["block"][1] * shape["block"][2]
    res["launch"] = {**shape, "blocks_per_tile": blocks / n_tiles, "threads_per_pixel": threads / (n_tiles * composite.P)}
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


def main_path_inputs(gaussians, extrinsics, intrinsics, near, far, hw, render_kwargs):
    """The compositor inputs of render_gaussians(..., **render_kwargs) for b
    scenes and t cameras each (no scale invariance, black background, zero
    camera deltas; render_gaussians' defaults for the caps not given): a
    path's own."""
    import torch

    from styl3r_tpu_torch.ops.rasterizer.camera import make_raster_camera
    from styl3r_tpu_torch.ops.rasterizer.render import composite_inputs

    dev = extrinsics.device
    b, t = extrinsics.shape[:2]
    n = b * t
    zeros = torch.zeros(n, 3, device=dev)
    cams = make_raster_camera(
        extrinsics.reshape(n, 4, 4), intrinsics.reshape(n, 3, 3), near.reshape(n), far.reshape(n), hw,
        cam_rot_delta=zeros, cam_trans_delta=zeros,
    )

    def per_view(x):
        return x[:, None].expand(b, t, *x.shape[1:]).reshape(n, *x.shape[1:])

    g = gaussians.means.shape[1]
    pair_cap = render_kwargs.get("pair_cap_per_gaussian", 0)
    return composite_inputs(
        cams, per_view(gaussians.means), None, per_view(gaussians.harmonics),
        per_view(gaussians.opacities), hw, zeros,
        scales=per_view(gaussians.scales), rotations=per_view(gaussians.rotations),
        max_tiles_per_gaussian=render_kwargs.get("max_tiles_per_gaussian", 32),
        max_per_tile=render_kwargs.get("max_per_tile", 4096),
        pair_cap=pair_cap * n * g if pair_cap else None,
    )


def composite_bwd_work(inputs, n_done):
    """(evaluations, bytes) the backward kernels need for these inputs: the
    walked (pixel, pair) evaluations; each walked pair's row read once and
    its gradient row written once, the per-pixel t_final and four
    cotangents and the per-tile ranges read once. The other pairs' rows stay
    as the wrapper's zero-fill of the gradient left them; that fill is a
    separate launch, outside the kernels' device time and this bound."""
    evals, _ = composite_work(inputs, n_done)
    n_tiles = inputs.starts.numel()
    nbytes = 2 * (evals // 256) * 48 + n_tiles * (256 * 24 + 12)
    return evals, nbytes


def walked_pairs(inputs, n_done):
    """(n_pairs,) bool: the pairs inside their tile's clamped range and
    inside the windows the forward composited; every other pair's gradient
    is exactly 0."""
    import torch

    starts = inputs.starts.long()
    ends = torch.minimum(starts + inputs.counts.long(), (starts // 128) * 128 + 128 * n_done.long())
    keep = ends > starts
    delta = torch.zeros(inputs.attrs.shape[0] + 1, dtype=torch.long, device=starts.device)
    delta.index_add_(0, starts[keep], torch.ones_like(starts[keep]))
    delta.index_add_(0, ends[keep], -torch.ones_like(ends[keep]))
    return torch.cumsum(delta, 0)[:-1] > 0


def check_composite_bwd(inputs, max_per_tile, dcolor, ddepth, dalpha, reps=20):
    """The kernels' pipeline (backward kernel on the forward kernel's n_done
    and t_final) vs the plain one (plain backward on the plain forward's) on
    one set of compositor inputs and cotangents: the largest error, exact
    zeros, the median times of a kernel call and of a plain call (CUDA
    events, on the kernel's forward state), and the bound."""
    import torch

    from styl3r_tpu_torch.ops.rasterizer import composite

    fwd_args = (inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds, inputs.grid, max_per_tile,
                inputs.n_views)
    fwd, fwd_plain = composite.composite_tiles(*fwd_args), composite.composite_tiles_plain(*fwd_args)
    cot = (dcolor.contiguous(), ddepth.contiguous(), dalpha.contiguous(), inputs.grid, inputs.n_views)
    args = (inputs.attrs, inputs.starts, inputs.counts, fwd.n_done, fwd.t_final, *cot)
    kern = composite.composite_backward(*args, max_per_tile=max_per_tile)
    plain = composite.composite_backward_plain(
        inputs.attrs, inputs.starts, inputs.counts, fwd_plain.n_done, fwd_plain.t_final, *cot
    )
    torch.cuda.synchronize()
    if not bool(torch.isfinite(kern).all()):
        raise AssertionError("composite_bwd: non-finite gradients")
    walked = walked_pairs(inputs, fwd.n_done)
    if bool((kern[~walked] != 0).any()) or bool((plain[~walked] != 0).any()):
        raise AssertionError("composite_bwd: a pair no window walked has a gradient")
    # Elsewhere an exact 0 of one version may be a denormal of the other:
    # T_i deep behind saturated pixels underflows at other points.
    zero_mismatch = (plain == 0) != (kern == 0)
    err = rel = 0.0
    for c in range(composite.N_GRAD):
        scale = float(plain[:, c].abs().max())
        e = float((kern[:, c] - plain[:, c]).abs().max())
        if e > BWD_TOL * scale:
            raise AssertionError(f"composite_bwd: column {c} differs from the plain version by {e} > {BWD_TOL} * {scale}")
        err, rel = max(err, e), max(rel, e / scale if scale > 0 else 0.0)
    call_ms = cuda_ms(lambda: composite.composite_backward(*args, max_per_tile=max_per_tile), reps)
    plain_ms = cuda_ms(lambda: composite.composite_backward_plain(*args), max(3, reps // 4))
    evals, nbytes = composite_bwd_work(inputs, fwd.n_done)
    t_ops = evals * COMPOSITE_BWD_OPS_PER_EVAL / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    if not torch.equal(kern, composite.composite_backward(*args, max_per_tile=max_per_tile)):
        raise AssertionError("composite_bwd: two calls on the same inputs differ")
    n_done = fwd.n_done.long()
    return dict(
        args=args, max_per_tile=max_per_tile, max_abs_err=err, max_rel_err=rel, call_ms=call_ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes", evals=evals,
        pairs_with_grad=int((plain.abs().sum(1) > 0).sum()), n_done_max=int(n_done.max()),
        n_done_mean=float(n_done.float().mean()), walked=int(walked.sum()), zero_mismatch=int(zero_mismatch.sum()),
        zero_mismatch_max=float(torch.where(zero_mismatch, (kern - plain).abs(), torch.zeros_like(kern)).max()),
        # Each phase has a block for every (tile, window) it launches; those
        # of windows a tile walked do the work, the others exit at once.
        walked_blocks=2 * int(n_done.sum()),
    )


def windows_line(res):
    return f"windows walked per tile: max {res['n_done_max']}, mean {res['n_done_mean']:.3f}"


def composite_bwd_device_ms(res, reps=20):
    """Adds the backward kernel's device time and its two phases' launch
    shapes on the inputs check_composite_bwd held."""
    from styl3r_tpu_torch.ops.rasterizer import composite

    res["ms"], each, shapes = kernel_device_ms(
        lambda: composite.composite_backward(*res["args"], max_per_tile=res["max_per_tile"]), reps,
        ("bwd_sums_kernel", "bwd_grad_kernel"))
    res["phase_ms"] = {"sums": each["bwd_sums_kernel"], "grad": each["bwd_grad_kernel"]}
    res["launch"] = {"sums": shapes["bwd_sums_kernel"], "grad": shapes["bwd_grad_kernel"]}
    return res


def image_cotangents(inputs, max_per_tile, loss_of_images):
    """A loss's cotangents at the compositor's outputs: dL/dcolor in the
    tile layout of loss_of_images((n_views, h, w, 3) rendered colors); depth
    and alpha get none, and with a black background the folded dalpha is 0."""
    import torch

    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.ops.rasterizer.render import _tiles_to_image

    out = composite.composite_tiles(
        inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds, inputs.grid, max_per_tile, inputs.n_views
    )
    with torch.enable_grad():
        color = out.color.detach().requires_grad_()
        loss = loss_of_images(_tiles_to_image(color, inputs.n_views, *inputs.grid))
        (dcolor,) = torch.autograd.grad(loss, color)
    return dcolor, torch.zeros_like(out.depth), torch.zeros_like(out.alpha)


def mse_cotangents(inputs, max_per_tile, target_images):
    """The stage-1 and alignment loss's cotangents: mean((color - target)^2)."""
    def loss(image):
        return ((image - target_images.reshape(image.shape)) ** 2).mean()

    return image_cotangents(inputs, max_per_tile, loss)


def refine_cotangents(inputs, max_per_tile, target_image):
    """The photometric refinement's cotangents: its loss, MSE + 0.2 * (1 -
    SSIM), on the one view's render. The SSIM term's 11x11 Gaussian filter
    reaches every pixel."""
    from styl3r_tpu_torch.eval.pose import photometric_loss

    return image_cotangents(inputs, max_per_tile, lambda image: photometric_loss(image[0], target_image))


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


def synthetic_scene(seed=0, n_frames=6, hw=256):
    """A scene as the inference entry points read one: n_frames frames of
    uniform noise at hw^2, c2w poses whose camera slides 0.05 along x a
    frame (as tests/test_data.py's chunks do), normalized intrinsics, and a
    style image."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n_frames, hw, hw, 3)).astype(np.float32)
    intrinsics = np.tile(np.asarray([[0.8, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32), (n_frames, 1, 1))
    extrinsics = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    extrinsics[:, 0, 3] = 0.05 * np.arange(n_frames)
    style = rng.uniform(0, 1, (hw, hw, 3)).astype(np.float32)
    return images, intrinsics, extrinsics, style


@contextlib.contextmanager
def plain_compositor():
    """render_gaussians and its gradient through the plain versions on the
    card's tensors: composite_tiles and composite_backward are swapped for
    composite_tiles_plain and composite_backward_plain (no launch counted)."""
    from styl3r_tpu_torch.ops.rasterizer import composite

    saved = composite.composite_tiles, composite.composite_backward
    composite.composite_tiles = composite.composite_tiles_plain
    composite.composite_backward = lambda *args, max_per_tile: composite.composite_backward_plain(*args)
    try:
        yield
    finally:
        composite.composite_tiles, composite.composite_backward = saved


def delta_grads(gaussians, extrinsics, intrinsics, near, far, images, hw, render_kwargs):
    """Gradients of pose alignment's loss, mean((color - images)^2), w.r.t.
    zero rotation and translation deltas of each camera."""
    import torch

    from styl3r_tpu_torch.models.decoder import render_gaussians

    b, v = extrinsics.shape[:2]
    rot = torch.zeros(b, v, 3, device=extrinsics.device, requires_grad=True)
    trans = torch.zeros(b, v, 3, device=extrinsics.device, requires_grad=True)
    with torch.enable_grad():
        out = render_gaussians(gaussians, extrinsics, intrinsics, near, far, hw, cam_rot_delta=rot,
                               cam_trans_delta=trans, **render_kwargs)
        return torch.autograd.grad(((out.color - images) ** 2).mean(), (rot, trans))


def inference_phase(model, card, steps=100, frames=60, size=256):
    """The re10k entry point's flow, run_scene_inference, on the full-width
    model: 2 context views and 3 targets of a synthetic 256^2 scene, a 256^2
    style image, `steps` pose-alignment steps and a `frames`-frame video,
    into a temporary directory. Each alignment step launches each kernel
    once, each render and each 10-frame video chunk the forward once. Then
    both kernels are held against their plain versions on the alignment's
    own inputs (its first step: 3 fused target views of the predicted
    Gaussians), the forward also on the first video chunk's, and the camera
    deltas' gradients of the whole render, kernels against plain versions."""
    import tempfile

    import numpy as np
    import torch

    from styl3r_tpu_torch.eval.benchmarker import Benchmarker
    from styl3r_tpu_torch.infer import cli, pipeline
    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.utils.ply_export import load_ply

    images, intrinsics, extrinsics, style = synthetic_scene(hw=size)
    context, targets = [0, 5], [1, 2, 3]
    hw = (size, size)
    # The alignment's and the renders' inputs, recorded as the path passes them.
    align_calls, render_calls = [], []
    real_align, real_render = cli.align_target_poses, pipeline.InferencePipeline.render

    def record_align(*args, **kwargs):
        align_calls.append((args, kwargs))
        return real_align(*args, **kwargs)

    def record_render(self, *args, **kwargs):
        render_calls.append((args, kwargs))
        return real_render(self, *args, **kwargs)

    bench = Benchmarker(model.device)
    with tempfile.TemporaryDirectory() as out_dir:
        cli.align_target_poses, pipeline.InferencePipeline.render = record_align, record_render
        try:
            composite.launches = composite.backward_launches = 0
            metrics = cli.run_scene_inference(
                model, images, intrinsics, extrinsics, context, targets, style, out_dir, image_shape=hw,
                align_pose_steps=steps, video_frames=frames, benchmarker=bench,
            )
            torch.cuda.synchronize()
            launches = {"composite_fwd": composite.launches, "composite_bwd": composite.backward_launches}
        finally:
            cli.align_target_poses, pipeline.InferencePipeline.render = real_align, real_render
        expected = (steps + 2 + -(-frames // 10), steps)
        if (launches["composite_fwd"], launches["composite_bwd"]) != expected:
            raise AssertionError(f"inference path: compositor launches (fwd, bwd) "
                                 f"{launches['composite_fwd'], launches['composite_bwd']}, expected {expected}")
        names = {p.name for p in os.scandir(out_dir)}
        wanted = {"style.png", "gaussians.ply", "gaussians_stylized.ply", "info.json", "interpolation",
                  *(f"context_{i:04d}.png" for i in context),
                  *(f"{kind}_{i:04d}.png" for i in targets for kind in ("target_gt", "color", "stylized_color"))}
        if names - {"interpolation.mp4"} != wanted:
            raise AssertionError(f"inference path wrote {sorted(names)}, expected {sorted(wanted)}")
        video = sorted(os.listdir(os.path.join(out_dir, "interpolation")))
        if video != [f"{i:04d}.png" for i in range(frames)]:
            raise AssertionError(f"inference path: {len(video)} video frames, expected {frames}")
        vertices = [len(load_ply(os.path.join(out_dir, name))["x"]) for name in ("gaussians.ply", "gaussians_stylized.ply")]
        if vertices != [2 * hw[0] * hw[1]] * 2:
            raise AssertionError(f"inference path: PLYs hold {vertices} vertices, expected {2 * hw[0] * hw[1]}")
        with open(os.path.join(out_dir, "info.json")) as f:
            info = json.load(f)
        if not np.isfinite(info["psnr_unstylized"]) or info != metrics:
            raise AssertionError(f"inference path: info.json {info}, returned {metrics}")

    ms = {tag: [1e3 * x for x in times] for tag, times in bench.execution_times.items()}
    t = len(targets)
    times = dict(
        predict_ms=ms["encoder"], align_ms_per_step=statistics.mean(ms["optimize"]),
        render_ms=[statistics.mean(ms["decoder"][i : i + t]) * t for i in range(0, 2 * t, t)],
        video_ms_per_frame=statistics.mean(ms["video"]),
    )
    log(f"inference path: run_scene_inference, 2 context views + 3 targets at {size}^2, {steps} alignment steps, "
        f"{frames} video frames: predict {times['predict_ms'][0]:.2f} and {times['predict_ms'][1]:.2f} ms, "
        f"alignment {times['align_ms_per_step']:.2f} ms/step, renders {times['render_ms'][0]:.2f} and "
        f"{times['render_ms'][1]:.2f} ms (3 views), video {times['video_ms_per_frame']:.2f} ms/frame; PSNR "
        f"{metrics['psnr_unstylized']:.4f}; PLYs {vertices[0]} vertices; launches fwd {launches['composite_fwd']} "
        f"bwd {launches['composite_bwd']} [{card}]")

    # The kernels on the alignment's own inputs: its first step's.
    (args, kwargs), = align_calls
    gaussians, ext, k, near, far, target_images, _ = args
    render_kwargs = {key: v for key, v in kwargs.items() if key != "steps"}
    max_per_tile = render_kwargs["max_per_tile"]
    with torch.no_grad():
        inputs = main_path_inputs(gaussians, ext, k, near, far, hw, render_kwargs)
        fwd = check_composite(inputs, max_per_tile)
        bwd = check_composite_bwd(inputs, max_per_tile, *mse_cotangents(inputs, max_per_tile, target_images))
    log(f"kernel composite_fwd, alignment's own inputs (3 fused {size}^2 views, {int(inputs.live_pairs)} live "
        f"pairs): agrees with the plain version, max err {fwd['max_abs_err']:.3g}; {fwd_windows_line(fwd)}")
    log(f"kernel composite_bwd, alignment's own inputs and MSE cotangents: agrees with the plain version, max err "
        f"{bwd['max_abs_err']:.3g} ({bwd['max_rel_err']:.3g} of its column's largest gradient), "
        f"{bwd['pairs_with_grad']} pairs with a gradient of {bwd['walked']} walked; {windows_line(bwd)}")
    kern = delta_grads(gaussians, ext, k, near, far, target_images, hw, render_kwargs)
    with plain_compositor():
        plain = delta_grads(gaussians, ext, k, near, far, target_images, hw, render_kwargs)
    grad_err = {}
    for name, a, b in zip(("rot", "trans"), kern, plain):
        scale = float(b.abs().max())
        if not scale > 0:
            raise AssertionError(f"camera-delta gradient {name}: no gradient reached the deltas")
        grad_err[name] = float((a - b).abs().max()) / scale
        if not grad_err[name] <= 1e-3:
            raise AssertionError(f"camera-delta gradient {name}: kernels vs plain {grad_err[name]} of {scale}")
    log(f"camera-delta gradients of the alignment's render, kernels vs plain versions: rotation within "
        f"{grad_err['rot']:.3g}, translation within {grad_err['trans']:.3g} of the largest component")

    # The forward on the first video chunk's inputs (10 views, the
    # renderer's default caps, as the reference's video takes).
    (args, kwargs) = render_calls[2]
    video_gaussians, video_ext, video_k, video_near, video_far = args
    video_max = kwargs.get("max_per_tile", 4096)
    with torch.no_grad():
        video_inputs = main_path_inputs(video_gaussians, video_ext, video_k, video_near, video_far, hw, kwargs)
        video_fwd = check_composite(video_inputs, video_max)
    log(f"kernel composite_fwd, the video's first chunk ({video_ext.shape[1]} fused {size}^2 views, max_per_tile "
        f"{video_max}, {int(video_inputs.live_pairs)} live pairs): agrees with the plain version, max err "
        f"{video_fwd['max_abs_err']:.3g}; {fwd_windows_line(video_fwd)}")
    return dict(launches=launches, times=times, psnr_unstylized=metrics["psnr_unstylized"], ply_vertices=vertices[0],
                fwd=fwd, bwd=bwd, video_fwd=video_fwd, delta_grad_rel_err=grad_err,
                live_pairs=int(inputs.live_pairs))


def four_view_phase(model, card, hw, render_kwargs):
    """A 4-view predict and render at full width (infer_tnt_batch's
    context), twice, each timed with CUDA events: the first call at these
    shapes, and a warm one."""
    import torch

    from styl3r_tpu_torch.ops.rasterizer import composite

    batch = example_batch(7, model.device, v=4)
    g = 4 * hw[0] * hw[1]
    times = []
    composite.launches = composite.backward_launches = 0
    for i in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            start.record()
            gaussians, out = model(batch, hw, **render_kwargs)
            end.record()
            torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        finite = all(bool(torch.isfinite(x).all()) for x in (*gaussians, out.color, out.depth, out.alpha))
        if not finite or out.color.shape != (1, 1, *hw, 3) or gaussians.means.shape != (1, g, 3):
            raise AssertionError("4-view predict: non-finite or misshapen output")
        live, slots = int(out.live_pairs.max()), int(out.pair_slots.min())
        if composite.launches != i + 1 or not 0 < live <= slots:
            raise AssertionError(f"4-view predict: {composite.launches} launches after {i + 1} calls, live pairs "
                                 f"{live} of {slots} slots")
    launches = {"composite_fwd": composite.launches, "composite_bwd": composite.backward_launches}
    log(f"4-view predict + render at {hw[0]}x{hw[1]}: {times[0]:.2f} ms the first call at these shapes, "
        f"{times[1]:.2f} ms the second; {g} Gaussians, live pairs {live} [{card}]")
    return dict(ms=times, gaussians=g, live_pairs=live, launches=launches)


def recovery_cloud(device, g=131072, seed=0, size=1 / 16):
    """tests/test_infer.py::make_scene's cloud scaled up to g Gaussians,
    drawn the same way from numpy's generator, each `size` times as large as
    there: 256x as many Gaussians at 1/16 of the size cover the view as the
    512 there do. At full size the front layer hides the rest and the view
    is nearly a plane at z = 2, where a turn about y and a shift along x
    look alike, and the pose error stalls above 0.3x of its start."""
    import numpy as np
    import torch

    from styl3r_tpu_torch.geometry.gaussians import Gaussians
    from styl3r_tpu_torch.ops.rasterizer.project import SH_C0

    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, g), rng.uniform(-1.5, 1.5, g), rng.uniform(2, 6, g)], -1)
    scales = rng.uniform(0.02, 0.08, (g, 3)) * size
    quats = rng.normal(size=(g, 4))
    sh = (rng.uniform(0, 1, (g, 3)) - 0.5)[..., None] / SH_C0
    opacities = rng.uniform(0.5, 1.0, g)

    def tensor(x):
        return torch.tensor(x, dtype=torch.float32, device=device)[None]

    return Gaussians(tensor(means), None, tensor(sh), tensor(opacities), tensor(scales), tensor(quats))


def recovery_phase(card, device="cuda", g=131072, steps=60, hw=(256, 256)):
    """tests/test_infer.py::test_pose_alignment_recovers_perturbation at the
    main path's scale: from the identity, align_target_poses brings one
    view's pose error below 0.3x of its start."""
    import torch

    from styl3r_tpu_torch.geometry.se3 import se3_exp
    from styl3r_tpu_torch.infer.pipeline import align_target_poses
    from styl3r_tpu_torch.models.decoder import render_gaussians
    from styl3r_tpu_torch.ops.rasterizer import composite

    dev = torch.device(device)
    gaussians = recovery_cloud(dev, g)
    true_ext = se3_exp(torch.tensor([0.05, -0.03, 0.0, 0.0, 0.02, 0.0], device=dev))[None, None]
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], device=dev)[None, None]
    near, far = torch.full((1, 1), 0.1, device=dev), torch.full((1, 1), 100.0, device=dev)
    render_kwargs = dict(max_per_tile=2048, max_tiles_per_gaussian=8)
    with torch.no_grad():
        target = render_gaussians(gaussians, true_ext, k, near, far, hw, **render_kwargs)
    start = torch.eye(4, device=dev)[None, None]
    # The first step's camera-delta gradients on these dense inputs (tiles of
    # several windows), kernels against plain versions.
    kern = delta_grads(gaussians, start, k, near, far, target.color, hw, render_kwargs)
    with plain_compositor():
        plain = delta_grads(gaussians, start, k, near, far, target.color, hw, render_kwargs)
    grad_err = {name: float((a - b).abs().max() / b.abs().max()) for name, a, b in zip(("rot", "trans"), kern, plain)}
    log(f"pose recovery's first step, camera-delta gradients, kernels vs plain versions: rotation within "
        f"{grad_err['rot']:.3g}, translation within {grad_err['trans']:.3g} of the largest component")
    if not max(grad_err.values()) <= 1e-3:
        raise AssertionError(f"pose recovery: camera-delta gradients differ from the plain versions: {grad_err}")
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    composite.launches = composite.backward_launches = 0
    t0.record()
    aligned = align_target_poses(gaussians, start, k, near, far, target.color, hw, steps=steps,
                                 rot_lr=5e-3, trans_lr=5e-3, **render_kwargs)
    t1.record()
    torch.cuda.synchronize()
    launches = {"composite_fwd": composite.launches, "composite_bwd": composite.backward_launches}
    if (launches["composite_fwd"], launches["composite_bwd"]) != (steps, steps):
        raise AssertionError(f"pose recovery: compositor launches {launches}, expected {steps} of each")
    before = float((start - true_ext).abs().max())
    after = float((aligned - true_ext).abs().max())
    if not after < 0.3 * before:
        raise AssertionError(f"pose recovery: error {after} after {steps} steps, from {before}")
    ms = t0.elapsed_time(t1) / steps
    log(f"pose recovery, {g} Gaussians at {hw[0]}x{hw[1]} ({int(target.live_pairs.max())} live pairs): "
        f"pose error {before:.4f} -> {after:.4f} ({after / before:.3f}x) in {steps} steps, {ms:.2f} ms/step [{card}]")
    # Both kernels on the first step's inputs, the backward on its MSE cotangents.
    with torch.no_grad():
        inputs = main_path_inputs(gaussians, start, k, near, far, hw, render_kwargs)
        fwd = check_composite(inputs, 2048)
        bwd = check_composite_bwd(inputs, 2048, *mse_cotangents(inputs, 2048, target.color))
    log(f"kernel composite_fwd, pose recovery's first step ({int(inputs.live_pairs)} live pairs): agrees with the "
        f"plain version, max err {fwd['max_abs_err']:.3g}; {fwd_windows_line(fwd)}")
    log(f"kernel composite_bwd, pose recovery's first step and MSE cotangents: agrees with the plain version, max "
        f"err {bwd['max_abs_err']:.3g} ({bwd['max_rel_err']:.3g} of its column's largest gradient); "
        f"{windows_line(bwd)}")
    return dict(before=before, after=after, ratio=after / before, steps=steps, ms_per_step=ms,
                live_pairs=int(target.live_pairs.max()), delta_grad_rel_err=grad_err, launches=launches,
                fwd=fwd, bwd=bwd)


EVAL_CONFIG = "configs/experiment/re10k_eval.yaml"
# Each synthetic scene's entry in the evaluation phase's index: two context
# views and three targets between them.
EVAL_VIEWS = {"context": [0, 10], "target": [3, 5, 7], "overlap": "medium"}
# compute_metrics' PSNR over evaluate's 8-bit PNGs against the same targets'
# PNGs, beside scores.json's over the float renders: the two quantizations
# move the PSNR of a noise scene by a few thousandths of a dB.
EVAL_PSNR_TOL = 0.1
# tests/test_pose.py::test_photometric_refinement_recovers_pnp_error's
# perturbation: about 2 degrees of rotation (the last three components) and
# 2% of translation.
REFINE_PERTURBATION = [0.02, -0.015, 0.01, 0.02, -0.025, 0.015]
# The refinement's recovery on recovery_cloud at 256^2: the rotation error
# after 200 steps, as a share of its start. The cloud's Gaussians are drawn
# at half of tests/test_infer.py's size. On the CPU, at 256^2, 131,072
# Gaussians of that size bring it to 0.123x; at a quarter of that size
# (and at 32,768 Gaussians of 1/8 and 1/4 of it at 128^2) the error grows
# to 1.3-2.0x instead: sub-pixel Gaussians give the 2-degree start no slope
# to follow.
REFINE_RECOVERY_BOUND = 0.3
REFINE_CLOUD_SIZE = 0.5


def refine_recovery_phase(card, device="cuda", g=131072, steps=200, hw=(256, 256)):
    """tests/test_pose.py::test_photometric_refinement_recovers_pnp_error at
    the main path's scale: refine_pose_photometric from about 2 degrees off
    brings the rotation error below REFINE_RECOVERY_BOUND of its start, each
    step launching each kernel once. Then both kernels are held against
    their plain versions on the first step's inputs, the backward on the
    refinement loss's (MSE + SSIM) cotangents."""
    import numpy as np
    import torch

    from styl3r_tpu_torch.eval.pose import pose_error_deg, refine_pose_photometric
    from styl3r_tpu_torch.geometry.se3 import se3_exp
    from styl3r_tpu_torch.models.decoder import render_gaussians
    from styl3r_tpu_torch.ops.rasterizer import composite

    dev = torch.device(device)
    gaussians = recovery_cloud(dev, g, size=REFINE_CLOUD_SIZE)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], device=dev)
    near, far = 0.1, 100.0
    render_kwargs = dict(max_per_tile=2048, max_tiles_per_gaussian=8)
    with torch.no_grad():
        target = render_gaussians(gaussians, torch.eye(4, device=dev)[None, None], k[None, None],
                                  torch.full((1, 1), near, device=dev), torch.full((1, 1), far, device=dev), hw,
                                  **render_kwargs)
    start = se3_exp(torch.tensor(REFINE_PERTURBATION, device=dev))
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    composite.launches = composite.backward_launches = 0
    t0.record()
    refined = refine_pose_photometric(gaussians, start, k, target.color[0, 0], near, far, steps=steps,
                                      **render_kwargs)
    t1.record()
    torch.cuda.synchronize()
    launches = {"composite_fwd": composite.launches, "composite_bwd": composite.backward_launches}
    if (launches["composite_fwd"], launches["composite_bwd"]) != (steps, steps):
        raise AssertionError(f"refinement recovery: compositor launches {launches}, expected {steps} of each")
    r0, _ = pose_error_deg(start.cpu().numpy(), np.eye(4))
    r1, _ = pose_error_deg(refined.cpu().numpy(), np.eye(4))
    t_err = float(refined[:3, 3].norm())
    if not r1 < REFINE_RECOVERY_BOUND * r0:
        raise AssertionError(f"refinement recovery: rotation error {r1} deg after {steps} steps, from {r0} deg "
                             f"(bound {REFINE_RECOVERY_BOUND}x)")
    ms = t0.elapsed_time(t1) / steps
    log(f"refinement recovery, {g} Gaussians at {REFINE_CLOUD_SIZE} of test_infer's size, {hw[0]}x{hw[1]} "
        f"({int(target.live_pairs.max())} live pairs): rotation error {r0:.4f} -> {r1:.4f} deg ({r1 / r0:.3f}x, "
        f"bound {REFINE_RECOVERY_BOUND}), translation {float(start[:3, 3].norm()):.4f} -> {t_err:.4f}, in {steps} "
        f"steps, {ms:.2f} ms/step [{card}]")

    with torch.no_grad():
        inputs = main_path_inputs(gaussians, start[None, None], k[None, None], torch.full((1, 1), near, device=dev),
                                  torch.full((1, 1), far, device=dev), hw, render_kwargs)
        fwd = check_composite(inputs, 2048)
        bwd = check_composite_bwd(inputs, 2048, *refine_cotangents(inputs, 2048, target.color[0, 0]))
    log(f"kernel composite_fwd, the refinement recovery's first step ({int(inputs.live_pairs)} live pairs): agrees "
        f"with the plain version, max err {fwd['max_abs_err']:.3g}; {fwd_windows_line(fwd)}")
    log(f"kernel composite_bwd, the refinement recovery's first step and MSE + SSIM cotangents: agrees with the "
        f"plain version, max err {bwd['max_abs_err']:.3g} ({bwd['max_rel_err']:.3g} of its column's largest "
        f"gradient), {bwd['pairs_with_grad']} pairs with a gradient of {bwd['walked']} walked; {windows_line(bwd)}")
    return dict(r0_deg=r0, r1_deg=r1, ratio=r1 / r0, t0=float(start[:3, 3].norm()), t1=t_err, steps=steps,
                ms_per_step=ms, live_pairs=int(target.live_pairs.max()), launches=launches, fwd=fwd, bwd=bwd)


def evaluation_phase(card, scenes=2, align_steps=100, refine_steps=200, hw=(256, 256)):
    """The evaluation entry points at full width with random weights from a
    seed, on synthetic RE10K test chunks (12 noise JPEGs of 360x640 a scene)
    and an evaluation index of 2 context views and 3 targets a scene:
      * eval.evaluate.main with pose alignment (align_steps steps a scene,
        each launching each kernel once) and the renders saved: the three
        JSON files, finite scores, 3 PNGs a scene; its times from
        benchmark.json;
      * eval.compute_metrics.main on those PNGs against the same targets'
        PNGs: its PSNR within EVAL_PSNR_TOL of scores.json's;
      * eval.eval_pose.main with refine_steps refinement steps a scene, each
        launching each kernel once: finite AUCs; each refinement timed with
        CUDA events. Both kernels are held against their plain versions on
        a refinement's own first step (the backward on its MSE + SSIM
        cotangents);
      * the refinement's recovery on a synthetic cloud
        (refine_recovery_phase)."""
    import tempfile

    import numpy as np
    import torch

    from styl3r_tpu_torch.eval import compute_metrics, eval_pose, evaluate, harness, pose
    from styl3r_tpu_torch.infer.cli import save_image
    from styl3r_tpu_torch.infer.pipeline import default_render_kwargs
    from styl3r_tpu_torch.ops.rasterizer import composite

    with tempfile.TemporaryDirectory(prefix="styl3r_eval_") as tmp:
        root = os.path.join(tmp, "re10k")
        fit_chunks(root, n_scenes=scenes, n_frames=12, seed=1, stage="test")
        index = os.path.join(tmp, "index.json")
        with open(index, "w") as f:
            json.dump({f"scene_{i}": EVAL_VIEWS for i in range(scenes)}, f)
        data = ["--config", os.path.join(ROOT, EVAL_CONFIG), "--max-scenes", str(scenes),
                f"datasets.0.roots=[{root}]", f"datasets.0.view_sampler.index_path={index}"]
        n_targets = len(EVAL_VIEWS["target"])

        # -- evaluate, with pose alignment ---------------------------------------
        out = os.path.join(tmp, "evaluate")
        targets, align_launches = [], []
        real_step, real_align = harness.EvalHarness.test_step, harness.align_target_poses

        def record_step(self, batch, scene="", overlap=None):
            targets.append((scene, batch.target_images[0].cpu().numpy()))
            return real_step(self, batch, scene, overlap)

        def record_align(*args, **kwargs):
            before = (composite.launches, composite.backward_launches)
            ext = real_align(*args, **kwargs)
            align_launches.append((composite.launches - before[0], composite.backward_launches - before[1]))
            return ext

        harness.EvalHarness.test_step, harness.align_target_poses = record_step, record_align
        try:
            torch.cuda.reset_peak_memory_stats()  # peak_memory.json: evaluate's own peak
            composite.launches = composite.backward_launches = 0
            t0 = time.perf_counter()
            means = evaluate.main([*data, f"test.output_path={out}", "test.align_pose=true",
                                   f"test.pose_align_steps={align_steps}", "test.save_image=true"])
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            eval_launches = {"composite_fwd": composite.launches, "composite_bwd": composite.backward_launches}
        finally:
            harness.EvalHarness.test_step, harness.align_target_poses = real_step, real_align
        gc.collect()
        torch.cuda.empty_cache()
        if align_launches != [(align_steps, align_steps)] * scenes:
            raise AssertionError(f"evaluate: each alignment's (fwd, bwd) launches {align_launches}, expected "
                                 f"{align_steps} of each a scene")
        expected = (scenes * (align_steps + 1), scenes * align_steps)
        if (eval_launches["composite_fwd"], eval_launches["composite_bwd"]) != expected:
            raise AssertionError(f"evaluate: compositor launches {eval_launches}, expected (fwd, bwd) {expected}")
        with open(os.path.join(out, "scores.json")) as f:
            scores = json.load(f)
        with open(os.path.join(out, "benchmark.json")) as f:
            bench = json.load(f)
        with open(os.path.join(out, "peak_memory.json")) as f:
            peak = json.load(f)
        if scores != means or not all(math.isfinite(scores[k]) for k in ("psnr/all", "ssim/all")):
            raise AssertionError(f"evaluate: scores.json {scores}, returned {means}")
        if list(peak) != [torch.cuda.get_device_name(0)] or not list(peak.values())[0] > 0:
            raise AssertionError(f"evaluate: peak_memory.json {peak}")
        pngs = sorted(os.path.relpath(os.path.join(d, name), os.path.join(out, "images"))
                      for d, _, names in os.walk(os.path.join(out, "images")) for name in names)
        wanted = [f"scene_{s}/{i:04d}.png" for s in range(scenes) for i in range(n_targets)]
        if pngs != wanted or [scene for scene, _ in targets] != [f"scene_{s}" for s in range(scenes)]:
            raise AssertionError(f"evaluate wrote {pngs}, expected {wanted}")
        times = dict(
            predict_ms=1e3 * bench["encoder"], predict_steady_ms=1e3 * bench["encoder_steady"],
            align_ms_per_step=1e3 * bench["optimize"] / align_steps,
            align_steady_ms_per_step=1e3 * bench["optimize_steady"] / align_steps,
            render_ms=1e3 * bench["decoder"] * n_targets, render_steady_ms=1e3 * bench["decoder_steady"] * n_targets,
        )
        log(f"evaluate: {scenes} scenes of 2 context views + {n_targets} targets at {hw[0]}^2, {align_steps} "
            f"alignment steps each, in {eval_s:.1f} s with the model's build: predict {times['predict_ms']:.2f} ms "
            f"(the second scene {times['predict_steady_ms']:.2f}), alignment {times['align_ms_per_step']:.2f} ms/step "
            f"({times['align_steady_ms_per_step']:.2f}), render {times['render_ms']:.2f} ms for {n_targets} views "
            f"({times['render_steady_ms']:.2f}) (benchmark.json, CUDA events); PSNR {scores['psnr/all']:.4f}, SSIM "
            f"{scores['ssim/all']:.4f}; peak memory {list(peak.values())[0] / 2**30:.2f} GiB; launches fwd "
            f"{eval_launches['composite_fwd']} bwd {eval_launches['composite_bwd']} [{card}]")

        # -- compute_metrics on evaluate's PNGs -----------------------------------
        gt = os.path.join(tmp, "gt")
        for scene, images in targets:
            for i, image in enumerate(images):
                save_image(os.path.join(gt, scene, f"{i:04d}.png"), image)
        pred = os.path.join(out, "images")
        offline = compute_metrics.main(["--gt-dir", gt, "--pred-dir", pred])[pred]
        psnr_gap = abs(offline["psnr/all"] - scores["psnr/all"])
        if not psnr_gap <= EVAL_PSNR_TOL:
            raise AssertionError(f"compute_metrics: PSNR {offline['psnr/all']} against scores.json's "
                                 f"{scores['psnr/all']} (bound {EVAL_PSNR_TOL} dB)")
        log(f"compute_metrics: {scenes * n_targets} PNGs, PSNR {offline['psnr/all']:.4f} (scores.json's within "
            f"{psnr_gap:.4f} dB, bound {EVAL_PSNR_TOL}), SSIM {offline['ssim/all']:.4f}")

        # -- eval_pose, with photometric refinement --------------------------------
        refinements = []
        real_refine = pose.refine_pose_photometric

        def record_refine(*args, steps, **kwargs):
            before = (composite.launches, composite.backward_launches)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            refined = real_refine(*args, steps=steps, **kwargs)
            end.record()
            torch.cuda.synchronize()
            refinements.append(dict(
                args=args, kwargs=kwargs, ms_per_step=start.elapsed_time(end) / steps,
                launches=(composite.launches - before[0], composite.backward_launches - before[1]),
            ))
            return refined

        pose.refine_pose_photometric = record_refine
        try:
            composite.launches = composite.backward_launches = 0
            t0 = time.perf_counter()
            aucs = eval_pose.main([*data, "--refine-steps", str(refine_steps)])
            torch.cuda.synchronize()
            pose_s = time.perf_counter() - t0
            pose_launches = {"composite_fwd": composite.launches, "composite_bwd": composite.backward_launches}
        finally:
            pose.refine_pose_photometric = real_refine
        if sorted(aucs) != [5, 10, 20] or not all(math.isfinite(v) for v in aucs.values()):
            raise AssertionError(f"eval_pose: AUCs {aucs}")
        if [r["launches"] for r in refinements] != [(refine_steps, refine_steps)] * scenes:
            raise AssertionError(f"eval_pose: each refinement's (fwd, bwd) launches "
                                 f"{[r['launches'] for r in refinements]}, expected {refine_steps} of each a scene")
        if (pose_launches["composite_fwd"], pose_launches["composite_bwd"]) != (scenes * refine_steps,) * 2:
            raise AssertionError(f"eval_pose: compositor launches {pose_launches}")
        refine_ms = [r["ms_per_step"] for r in refinements]
        log(f"eval_pose: {scenes} scenes, PnP + {refine_steps} refinement steps each, in {pose_s:.1f} s with the "
            f"model's build: refinement {', '.join(f'{x:.2f}' for x in refine_ms)} ms/step (CUDA events); AUC "
            f"{', '.join(f'@{t}={v:.4f}' for t, v in aucs.items())}; launches fwd {pose_launches['composite_fwd']} "
            f"bwd {pose_launches['composite_bwd']} [{card}]")

        # The kernels on a refinement's own inputs, its first step: the
        # scene whose PnP pose sees the most of its Gaussians (random
        # weights may put the pose where it sees none).
        def first_step(call):
            gaussians, init, k, _, near, far = call["args"]
            render_kwargs = default_render_kwargs(call["kwargs"])
            dev = init.device
            with torch.no_grad():
                return main_path_inputs(gaussians, init[None, None], k[None, None],
                                        torch.full((1, 1), near, device=dev), torch.full((1, 1), far, device=dev), hw,
                                        render_kwargs), render_kwargs["max_per_tile"]

        steps_in = [first_step(call) for call in refinements]
        live = [int(inputs.live_pairs) for inputs, _ in steps_in]
        best = live.index(max(live))
        inputs, max_per_tile = steps_in[best]
        target_image = refinements[best]["args"][3]
        with torch.no_grad():
            fwd = check_composite(inputs, max_per_tile)
            bwd = check_composite_bwd(inputs, max_per_tile, *refine_cotangents(inputs, max_per_tile, target_image))
        log(f"kernel composite_fwd, eval_pose's refinement of scene_{best}, first step ({live[best]} live pairs from "
            f"the PnP pose; {live} in the scenes): agrees with the plain version, max err {fwd['max_abs_err']:.3g}; "
            f"{fwd_windows_line(fwd)}")
        log(f"kernel composite_bwd, eval_pose's refinement of scene_{best}, first step, and MSE + SSIM cotangents: "
            f"agrees with the plain version, max err {bwd['max_abs_err']:.3g} ({bwd['max_rel_err']:.3g} of its "
            f"column's largest gradient), {bwd['pairs_with_grad']} pairs with a gradient of {bwd['walked']} walked; "
            f"{windows_line(bwd)}")
        del refinements, steps_in, inputs
    gc.collect()
    torch.cuda.empty_cache()
    recovery = refine_recovery_phase(card)
    return dict(
        launches={"evaluate": eval_launches, "eval_pose": pose_launches, "refine_recovery": recovery.pop("launches")},
        evaluate={**times, "seconds": eval_s, "scores": scores, "peak_bytes": list(peak.values())[0],
                  "compute_metrics_psnr": offline["psnr/all"], "compute_metrics_ssim": offline["ssim/all"]},
        eval_pose={"seconds": pose_s, "aucs": {str(t): v for t, v in aucs.items()}, "refine_ms_per_step": refine_ms,
                   "refine_live_pairs": live},
        fwd=fwd, bwd=bwd, recovery_fwd=recovery.pop("fwd"), recovery_bwd=recovery.pop("bwd"), recovery=recovery,
    )


def train_phase(model, batch, hw, render_kwargs, card, stage, reps=5, warm=2):
    """Drive make_train_step on the full-width model: `warm` + `reps` steps,
    each checked, the last `reps` timed with CUDA events."""
    import torch

    from styl3r_tpu_torch.losses.vgg import VGG19Features
    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.train.losses import LossBundle
    from styl3r_tpu_torch.train.step import TrainState, make_optimizer, make_stage2_optimizer, make_train_step
    from styl3r_tpu_torch.utils.convert import init_like_flax_

    dev = batch.context_images.device
    if stage == 1:
        optimizer = make_optimizer(model)
        step = make_train_step(model, optimizer, hw, stylized=False, **render_kwargs)
        per_step = 1  # one forward and one backward render a step
    else:
        vgg = VGG19Features().to(dev)
        init_like_flax_(vgg, torch.Generator(dev).manual_seed(3))
        loss_fn = LossBundle(mse_weight=None, style_weight=10.0, identity=True, vgg19=vgg.requires_grad_(False))
        optimizer = make_stage2_optimizer(model)
        step = make_train_step(model, optimizer, hw, loss_fn=loss_fn, stylized=True, identity_branch=True,
                               **render_kwargs)
        per_step = 2  # the main and the identity forward
        frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
        enc = model.encoder
        watched = {
            "token_stylizer": enc.token_stylizer.dec_blocks[0].mlp.fc1.weight,
            "gaussian_appearance_head": enc.gaussian_appearance_head.dpt.head["4"].weight,
        }
        before = {k: v.detach().clone() for k, v in watched.items()}
    geometry_heads = ("downstream_head1", "downstream_head2", "gaussian_param_head", "gaussian_param_head2")
    model.zero_grad(set_to_none=True)
    generator = torch.Generator(dev).manual_seed(stage)
    state = TrainState()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite.launches = composite.backward_launches = 0
    times, losses, lives = [], [], []
    for i in range(warm + reps):
        fwd0, bwd0 = composite.launches, composite.backward_launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(state, batch, generator)
        end.record()
        torch.cuda.synchronize()
        if i >= warm:
            times.append(start.elapsed_time(end))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        live, slots = int(metrics["live_pairs"]), int(metrics["pair_slots"])
        losses.append(loss)
        lives.append(live)
        where = f"stage {stage} step {i}"
        if not (torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"]) and gnorm > 0):
            raise AssertionError(f"{where}: loss {loss}, grad norm {gnorm}")
        if live > slots:
            raise AssertionError(f"{where}: the pair cap dropped pairs ({live} live > {slots} slots)")
        launched = (composite.launches - fwd0, composite.backward_launches - bwd0)
        if launched != (per_step, per_step):
            raise AssertionError(f"{where}: compositor launches (fwd, bwd) {launched}, expected {per_step} each")
        if stage == 1:
            # Held at the warm steps, whose render holds ~81 k live pairs:
            # later, Adam's first updates on random weights move the geometry
            # out of view (PERF.md §7), and a context view none of whose
            # Gaussians reaches the target gives its head no gradient at all.
            for name in geometry_heads if i < warm else ():
                g = getattr(model.encoder, name).dpt.head["4"].weight.grad
                if g is None or not bool((g != 0).any()):
                    raise AssertionError(f"{where}: no gradient reached {name} ({live} live pairs)")
        else:
            for name, p in model.named_parameters():
                if name in frozen and not torch.equal(p, frozen[name]):
                    raise AssertionError(f"{where}: frozen parameter {name} changed")
            if i >= 1:
                for name, p in watched.items():
                    if torch.equal(p, before[name]):
                        raise AssertionError(f"{where}: {name} did not change")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.median(times)
    b = batch.context_images.shape[0]
    timed_lives = lives[warm:]
    log(f"training stage {stage}: {ms:.2f} ms/step, {1e3 * b / ms:.3f} examples/s (median of {reps}, b = {b}), "
        f"peak memory {peak_gb:.2f} GiB; loss {losses[0]:.5f} -> {losses[-1]:.5f}, grad norm {gnorm:.4g}, "
        f"live pairs {lives[0]} at the first step, {min(timed_lives)}-{max(timed_lives)} in the timed steps, "
        f"of {slots} slots; launches fwd {composite.launches} bwd {composite.backward_launches} [{card}]")
    return dict(ms=ms, examples_per_s=1e3 * b / ms, peak_gib=peak_gb, fwd=composite.launches,
                bwd=composite.backward_launches, losses=losses, live_pairs=lives)


FIT_CONFIG = "configs/experiment/re10k_3view_style.yaml"
# A resumed step's loss against the uninterrupted run's: the card's
# convolutions and matmuls are not bitwise deterministic (the CPU test holds
# the resume bit for bit), and the resumed run starts from weights that went
# through two such steps of their own.
RESUME_TOL = 1e-3
# The resumed run's weights at the last step against the uninterrupted
# run's, as a share of what the two steps after the checkpoint changed: a
# resume that dropped the restored weights, the Adam moments or the
# schedule's position misses by about that whole change (the warm-up's
# learning rates are too small for the loss to show it), while the card's
# nondeterminism leaves a small part of it.
RESUME_PARAM_TOL = 0.1


def fit_chunks(root, n_scenes=4, n_frames=100, hw=(360, 640), seed=0, stage="train"):
    """Synthetic RE10K chunks in `root`/`stage`: n_scenes scenes of n_frames
    noise JPEGs at RE10K's 360x640, cameras sliding 0.05 along x a frame
    with normalized intrinsics fx 0.8 / fy 0.9 (tests/test_data.py:42), and
    a style root with train/scene_style_mapping_all.json."""
    import io

    import numpy as np
    import torch
    from PIL import Image

    rng = np.random.default_rng(seed)

    def jpeg(shape):
        buf = io.BytesIO()
        Image.fromarray((rng.uniform(0, 1, (*shape, 3)) * 255).astype(np.uint8)).save(buf, format="JPEG", quality=90)
        return buf.getvalue()

    scenes = []
    for i in range(n_scenes):
        cameras = np.zeros((n_frames, 18), np.float32)
        cameras[:, 0], cameras[:, 1], cameras[:, 2:4] = 0.8, 0.9, 0.5
        w2c = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
        w2c[:, 0, 3] = -0.05 * np.arange(n_frames)
        cameras[:, 6:] = w2c[:, :3].reshape(n_frames, 12)
        images = [torch.frombuffer(bytearray(jpeg(hw)), dtype=torch.uint8) for _ in range(n_frames)]
        scenes.append({"key": f"scene_{i}", "cameras": torch.from_numpy(cameras), "images": images, "url": ""})
    os.makedirs(os.path.join(root, stage))
    torch.save(scenes, os.path.join(root, stage, "000000.torch"))
    style_dir = os.path.join(root, "styles", "train")
    os.makedirs(style_dir)
    Image.open(io.BytesIO(jpeg((400, 600)))).save(os.path.join(style_dir, "style0.jpg"))
    with open(os.path.join(style_dir, "scene_style_mapping_all.json"), "w") as f:
        json.dump({s["key"]: "style0.jpg" for s in scenes}, f)
    return sum(len(im) for s in scenes for im in s["images"])


class FitProbe:
    """Records the compositor's inputs as one `fit` run passes them: the
    first two forwards and the first backward (the first train step's
    stylized and identity renders) and the first orthographic forward (the
    first validation's projections). The run's times and sizes come from
    its metrics.jsonl."""

    def __init__(self):
        self.train_fwd, self.bwd, self.ortho_fwd = [], None, None
        self._in_ortho = False

    @contextlib.contextmanager
    def attached(self):
        from styl3r_tpu_torch.ops.rasterizer import composite
        from styl3r_tpu_torch.train import trainer as trainer_mod

        probe = self
        saved = (trainer_mod.render_orthographic, composite.composite_tiles, composite.composite_backward)
        render_ortho, fwd, bwd = saved

        def tagged_ortho(*args, **kwargs):
            probe._in_ortho = True
            try:
                return render_ortho(*args, **kwargs)
            finally:
                probe._in_ortho = False

        def record_fwd(*args):
            if probe._in_ortho:
                probe.ortho_fwd = probe.ortho_fwd or args
            elif len(probe.train_fwd) < 2:
                probe.train_fwd.append(args)
            return fwd(*args)

        def record_bwd(*args, **kwargs):
            probe.bwd = probe.bwd or (args, kwargs["max_per_tile"])
            return bwd(*args, **kwargs)

        trainer_mod.render_orthographic = tagged_ortho
        composite.composite_tiles, composite.composite_backward = record_fwd, record_bwd
        try:
            yield self
        finally:
            trainer_mod.render_orthographic, composite.composite_tiles, composite.composite_backward = saved


def compositor_inputs(args):
    """composite_tiles' positional arguments as the inputs check_composite takes."""
    import types

    attrs, starts, counts, backgrounds, grid, max_per_tile, n_views = args
    return types.SimpleNamespace(attrs=attrs, starts=starts, counts=counts, backgrounds=backgrounds, grid=grid,
                                 n_views=n_views, live_pairs=None), max_per_tile


def fit_metrics(out_dir):
    """A fit's metrics.jsonl by kind of record: train steps, validations'
    scores and times, checkpoint saves and restores."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    kinds = dict(train="loss", val="val_psnr", validate="validate_seconds", save="checkpoint_seconds",
                 restore="restore_seconds")
    return {kind: [r for r in records if key in r] for kind, key in kinds.items()}


def checkpoint_weights(path):
    """A trainer checkpoint's model weights, on the host."""
    import torch

    return {k: v.clone() for k, v in torch.load(path, map_location="cpu", weights_only=True, mmap=True)["model"].items()}


def weights_distance(a, b):
    """The Euclidean distance between two state dicts' floating weights
    (taken on the card, in f64)."""
    total = 0.0
    for k, x in a.items():
        if x.is_floating_point():
            total += float((x.cuda().double() - b[k].cuda().double()).square().sum())
    return math.sqrt(total)


def fit_phase(card, batch_size=2, steps=4):
    """The training entry point, styl3r_tpu_torch.train.main.main, in-process
    on the paper's stage 2 (re10k_3view_style.yaml: 3 context views, 4
    targets, style 10 + identity with VGG19 at random weights, stylizer-only;
    the config's renderer caps, no pair cap), full width, on synthetic
    chunks: `steps` steps at b = `batch_size` (the config's 14 cut), a
    validation and a checkpoint every 2 steps, keeping 1. Then the run is
    repeated as an interrupted one: 2 steps, and a resume from their step-2
    checkpoint to step `steps`, whose losses must match the uninterrupted
    run's within RESUME_TOL and whose last weights the uninterrupted run's
    within RESUME_PARAM_TOL of what steps 3-4 changed. Both kernels are
    held against their plain
    versions on the first step's own inputs (forwards and the backward with
    the style loss's cotangents) and the forward on the first validation's
    orthographic projection."""
    import shutil
    import tempfile

    import torch

    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.train import main as train_main

    n_params = 1_043_732_697
    # Each checkpoint holds at most the f32 weights and two Adam moments of
    # every weight; a run keeps up to three files while it saves.
    need = 3 * 12 * n_params + 2**30
    with tempfile.TemporaryDirectory(prefix="styl3r_fit_") as tmp:
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise AssertionError(f"fit: {free / 2**30:.1f} GiB free under {tmp}, the checkpoints need "
                                 f"{need / 2**30:.1f} GiB")
        root = os.path.join(tmp, "re10k")
        t0 = time.perf_counter()
        jpeg_bytes = fit_chunks(root)
        log(f"fit: wrote 4 synthetic scenes of 100 360x640 JPEG frames ({jpeg_bytes / 2**20:.1f} MiB) in "
            f"{time.perf_counter() - t0:.1f} s")

        def run(out, max_steps, *extra):
            args = ["--config", os.path.join(ROOT, FIT_CONFIG), "--max-steps", str(max_steps),
                    f"datasets.0.roots=[{root}]", f"datasets.0.style_root={os.path.join(root, 'styles')}",
                    f"train.batch_size={batch_size}", "train.val_every_n_steps=2", "train.log_every_n_steps=1",
                    "checkpointing.every_n_train_steps=2", "checkpointing.save_top_k=1",
                    f"checkpointing.output_dir={out}", *extra]
            probe = FitProbe()
            with probe.attached():
                t0 = time.perf_counter()
                state = train_main.main(args)
                torch.cuda.synchronize()
            return state, probe, time.perf_counter() - t0, fit_metrics(out)

        # -- the uninterrupted run: the phase's main path ---------------------
        whole = os.path.join(tmp, "whole")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        composite.launches = composite.backward_launches = 0
        state, probe, seconds, rec = run(whole, steps)
        launches = {"composite_fwd": composite.launches, "composite_bwd": composite.backward_launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        train_rec, val_rec = rec["train"], rec["val"]
        losses = [r["loss"] for r in train_rec]
        if state.step != steps or [r["step"] for r in train_rec] != list(range(1, steps + 1)):
            raise AssertionError(f"fit: {state.step} steps, logged {[r['step'] for r in train_rec]}")
        if not all(math.isfinite(x) for x in losses) or len(val_rec) != steps // 2:
            raise AssertionError(f"fit: losses {losses}, {len(val_rec)} validations")
        # Each step renders twice (stylized and identity) and each validation
        # 4 times (targets, trajectory, projections, wobble).
        expected = (2 * steps + 4 * (steps // 2), 2 * steps)
        if (launches["composite_fwd"], launches["composite_bwd"]) != expected:
            raise AssertionError(f"fit: compositor launches {launches}, expected (fwd, bwd) {expected}")
        for name in ("val_comparison", "val_trajectory", "val_projections", "val_cameras", "val_camera_frustums"):
            pngs = sorted(os.listdir(os.path.join(whole, name)))
            if pngs != [f"{s:08d}.png" for s in range(2, steps + 1, 2)]:
                raise AssertionError(f"fit: {name} holds {pngs}")
        ckpts = sorted(os.listdir(os.path.join(whole, "checkpoints")))
        if ckpts != ["final.pt", f"step_{steps}.pt"]:
            raise AssertionError(f"fit: checkpoints {ckpts}")
        step_ms = [r["step_ms"] for r in train_rec]
        val_ms = [1e3 * r["validate_seconds"] for r in rec["validate"]]
        save_s, ckpt_bytes = [r["checkpoint_seconds"] for r in rec["save"]], int(rec["save"][0]["checkpoint_bytes"])
        data_s = [r["data_seconds"] for r in train_rec]
        live, slots = int(train_rec[0]["live_pairs"]), int(train_rec[0]["pair_slots"])
        log(f"fit: {steps} steps of stage 2 at b = {batch_size} (3 context views + 4 targets, no pair cap) "
            f"in {seconds:.1f} s with the model's build, 2 validations and {len(save_s)} checkpoints: "
            f"{statistics.median(step_ms[1:]):.2f} ms/step (median of steps 2-{steps}; the trainer's CUDA events), "
            f"the first {step_ms[0]:.2f} ms; data wait {1e3 * statistics.median(data_s[1:]):.2f} ms/step (median; "
            f"{1e3 * data_s[0]:.2f} ms for the first batch); validate {statistics.median(val_ms):.2f} ms (host "
            f"clock); peak "
            f"memory {peak_gib:.2f} GiB; loss {losses[0]:.5f} -> {losses[-1]:.5f}; live pairs {live} of {slots} "
            f"slots at the first step; launches fwd {launches['composite_fwd']} bwd {launches['composite_bwd']} "
            f"[{card}]")
        log(f"fit: checkpoint {ckpt_bytes} bytes ({ckpt_bytes / 2**30:.2f} GiB), saved in "
            f"{', '.join(f'{t:.2f}' for t in save_s)} s [{card}]")

        # -- the kernels on the fit's own inputs --------------------------------
        bwd_args, bwd_max = probe.bwd
        fwd_calls = probe.train_fwd
        inputs, max_per_tile = compositor_inputs(fwd_calls[0])
        in_range = int(inputs.counts.long().sum())
        with torch.no_grad():
            fwd_res = check_composite(inputs, max_per_tile)
            # The backward's own forward: the call whose pair rows it was given.
            own, = [c for c in fwd_calls if c[0].data_ptr() == bwd_args[0].data_ptr()]
            bwd_inputs, _ = compositor_inputs(own)
            bwd_res = check_composite_bwd(bwd_inputs, bwd_max, *bwd_args[5:8])
            ortho_inputs, ortho_max = compositor_inputs(probe.ortho_fwd)
            ortho_res = check_composite(ortho_inputs, ortho_max)
        size = f"{16 * inputs.grid[0]}x{16 * inputs.grid[1]}"
        log(f"kernel composite_fwd, the fit's first step's own inputs ({inputs.n_views} fused {size} views, "
            f"max_per_tile {max_per_tile}, {in_range} pairs in range): agrees with the plain version, max err "
            f"{fwd_res['max_abs_err']:.3g}; {fwd_windows_line(fwd_res)}")
        log(f"kernel composite_bwd, the fit's first step's own inputs and style-loss cotangents: agrees with the "
            f"plain version, max err {bwd_res['max_abs_err']:.3g} ({bwd_res['max_rel_err']:.3g} of its column's "
            f"largest gradient), {bwd_res['pairs_with_grad']} pairs with a gradient of {bwd_res['walked']} walked, "
            f"up to {bwd_res['n_done_max']} windows; {bwd_res['zero_mismatch']} values 0 in one version only, at "
            f"most {bwd_res['zero_mismatch_max']:.3g}; two calls bitwise equal")
        log(f"kernel composite_fwd, the first validation's orthographic projection (3 views of 256^2, "
            f"max_per_tile {ortho_max}): agrees with the plain version, max err {ortho_res['max_abs_err']:.3g}; "
            f"{fwd_windows_line(ortho_res)}")
        del probe, fwd_calls, bwd_args, own, inputs, bwd_inputs, ortho_inputs
        whole_weights = checkpoint_weights(os.path.join(whole, "checkpoints", "final.pt"))
        shutil.rmtree(whole)

        # -- the interrupted run and its resume ---------------------------------
        part = os.path.join(tmp, "part")
        gc.collect()
        torch.cuda.empty_cache()
        composite.launches = composite.backward_launches = 0
        run(part, steps // 2)
        resume_ckpt = os.path.join(part, "checkpoints", f"step_{steps // 2}.pt")
        start_weights = checkpoint_weights(resume_ckpt)
        resumed, _, _, rec = run(part, steps, f"checkpointing.load={resume_ckpt}", "checkpointing.resume=true")
        resume_launches = {"composite_fwd": composite.launches, "composite_bwd": composite.backward_launches}
        part_rec = rec["train"]
        if resumed.step != steps or [r["step"] for r in part_rec] != list(range(1, steps + 1)):
            raise AssertionError(f"fit resume: {resumed.step} steps, logged {[r['step'] for r in part_rec]}")
        resume_err = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(part_rec, train_rec)]
        if not max(resume_err) <= RESUME_TOL:
            raise AssertionError(f"fit resume: losses {[r['loss'] for r in part_rec]} against the uninterrupted "
                                 f"run's {losses}: relative {resume_err} > {RESUME_TOL}")
        resumed_weights = checkpoint_weights(os.path.join(part, "checkpoints", "final.pt"))
        moved = weights_distance(whole_weights, start_weights)
        param_err = weights_distance(resumed_weights, whole_weights) / moved
        del whole_weights, start_weights, resumed_weights
        if not (moved > 0 and param_err <= RESUME_PARAM_TOL):
            raise AssertionError(f"fit resume: the resumed run's step-{steps} weights are {param_err:.3g} of the "
                                 f"change over steps 3-{steps} ({moved:.4g}) from the uninterrupted run's "
                                 f"(bound {RESUME_PARAM_TOL})")
        load_s, load_bytes = rec["restore"][0]["restore_seconds"], int(rec["restore"][0]["restore_bytes"])
        first_wait = part_rec[steps // 2]["data_seconds"]
        log(f"fit resume: 2 steps, then a resume from the step-2 checkpoint to step {steps}: losses of steps 1-{steps} "
            f"within {', '.join(f'{e:.3g}' for e in resume_err)} of the uninterrupted run's (relative; bound "
            f"{RESUME_TOL}); step-{steps} weights {param_err:.3g} of the change over steps 3-{steps} ({moved:.4g}, "
            f"L2) from the uninterrupted run's (bound {RESUME_PARAM_TOL}); restored {load_bytes} bytes in "
            f"{load_s:.2f} s; first resumed batch after {1e3 * first_wait:.2f} ms [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        launches=launches, resume_launches=resume_launches, steps=steps, batch_size=batch_size,
        step_ms=step_ms, data_wait_ms=[1e3 * x for x in data_s], validate_ms=val_ms, peak_gib=peak_gib,
        checkpoint_bytes=ckpt_bytes, save_s=save_s, load_s=load_s,
        losses=losses, resume_losses=[r["loss"] for r in part_rec], resume_rel_err=resume_err,
        resume_param_err=param_err, resume_first_wait_ms=1e3 * first_wait,
        live_pairs=live, pair_slots=slots, val_psnr=[r["val_psnr"] for r in val_rec],
        fwd=fwd_res, bwd=bwd_res, ortho_fwd=ortho_res,
    )


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from styl3r_tpu_torch.models.styl3r import Styl3rModel
    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.train.scratch_init import scratch_init_heads
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
    log(f"kernel composite_fwd, dense cloud: {fwd_windows_line(res_dense)}")
    gen = torch.Generator(dev).manual_seed(11)
    n_tiles = dense.starts.numel()
    cot = [torch.randn(*shape, generator=gen, device=dev) for shape in ((n_tiles, 256, 3), (n_tiles, 256), (n_tiles, 256))]
    bwd_dense = check_composite_bwd(dense, 2048, *cot)
    log(f"kernel composite_bwd, dense cloud, seeded cotangents: agrees with the plain version, max err "
        f"{bwd_dense['max_abs_err']:.3g} ({bwd_dense['max_rel_err']:.3g} of its column's largest gradient), "
        f"{bwd_dense['pairs_with_grad']} pairs with a gradient of {bwd_dense['walked']} walked, up to "
        f"{bwd_dense['n_done_max']} windows; {bwd_dense['zero_mismatch']} values 0 in one version only, "
        f"at most {bwd_dense['zero_mismatch_max']:.3g}; two calls bitwise equal")
    log(f"kernel composite_bwd, dense cloud: {windows_line(bwd_dense)}")

    # -- serving path ----------------------------------------------------------
    hw = (256, 256)
    render_kwargs = dict(max_tiles_per_gaussian=8, max_per_tile=2048, pair_cap_per_gaussian=2)
    t0 = time.perf_counter()
    model = Styl3rModel(sh_degree=0, backbone_dtype=torch.bfloat16, head_trunk_dtype=torch.bfloat16,
                        device=dev, seed=0).cast_dtypes()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {n_params:,} parameters (bf16 backbone + stylizer and DPT trunks, stored in bf16 for serving), "
        f"built in {time.perf_counter() - t0:.1f} s")
    if n_params != 1_043_732_697:
        raise AssertionError(f"parameter count {n_params} is not the full-width model's")

    composite.launches = composite.backward_launches = 0
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
    launches = {"serve": {"composite_fwd": composite.launches, "composite_bwd": composite.backward_launches}}
    if launches["serve"]["composite_fwd"] == 0:
        raise AssertionError("kernel composite_fwd was not launched on the serving path")

    with torch.inference_mode():
        # batch[2:6]: the target cameras (extrinsics, intrinsics, near, far).
        res_main = check_composite(main_path_inputs(gaussians, *batch[2:6], hw, render_kwargs), 2048)
    log(f"kernel composite_fwd, serving path's own inputs: agrees with the plain version, "
        f"max err {res_main['max_abs_err']:.3g}; {fwd_windows_line(res_main)}")

    # -- serving timing: 10 warm forwards, encoder and render split ----------
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
    del gaussians, out, g

    # -- inference path: the entry points' flow, with pose alignment --------
    infer = inference_phase(model, card)
    launches["infer"] = infer["launches"]
    four_view = four_view_phase(model, card, hw, render_kwargs)
    launches["infer_4view"] = four_view.pop("launches")
    del model
    torch.cuda.empty_cache()
    recovery = recovery_phase(card)
    launches["recovery"] = recovery.pop("launches")
    recovery_fwd, recovery_bwd = recovery.pop("fwd"), recovery.pop("bwd")
    torch.cuda.empty_cache()

    # -- evaluation entry points: evaluate, compute_metrics, eval_pose -------
    evaluation = evaluation_phase(card)
    launches.update(evaluation.pop("launches"))
    for path in ("evaluate", "eval_pose", "refine_recovery"):
        for kernel in ("composite_fwd", "composite_bwd"):
            if not launches[path][kernel]:
                raise AssertionError(f"kernel {kernel} was not launched by {path}")
    gc.collect()
    torch.cuda.empty_cache()

    # -- training: full width, f32 master weights, bf16 compute ---------------
    train_kwargs = dict(max_tiles_per_gaussian=8, max_per_tile=2048, pair_cap_per_gaussian=4)
    model = Styl3rModel(sh_degree=0, backbone_dtype=torch.bfloat16, head_trunk_dtype=torch.bfloat16,
                        device=dev, seed=0)
    scratch_init_heads(model)
    if {p.dtype for p in model.parameters()} != {torch.float32}:
        raise AssertionError("a training model must hold f32 parameters")
    train_batch = example_batch(4, dev, b=2, targets=True)

    # The backward kernel on the stage-1 path's own inputs (its first step,
    # dropout aside) and MSE cotangents.
    with torch.no_grad():
        g = model.predict_gaussians(train_batch._replace(style_image=train_batch.context_images[:, 0]))
        train_inputs = main_path_inputs(g, *train_batch[2:6], hw, train_kwargs)
        bwd_main = check_composite_bwd(train_inputs, 2048, *mse_cotangents(train_inputs, 2048, train_batch.target_images))
        res_train = check_composite(train_inputs, 2048)
    log(f"kernel composite_bwd, stage-1 training path's own inputs ({int(train_inputs.live_pairs)} live pairs, "
        f"2 fused 256^2 views) and MSE cotangents: agrees with the plain version, max err "
        f"{bwd_main['max_abs_err']:.3g} ({bwd_main['max_rel_err']:.3g} of its column's largest gradient), "
        f"{bwd_main['pairs_with_grad']} pairs with a gradient of {bwd_main['walked']} walked, up to "
        f"{bwd_main['n_done_max']} windows; {bwd_main['zero_mismatch']} values 0 in one version only, "
        f"at most {bwd_main['zero_mismatch_max']:.3g}; two calls bitwise equal")
    log(f"kernel composite_bwd, stage-1 training path's own inputs: {windows_line(bwd_main)}")
    log(f"kernel composite_fwd, stage-1 training path's own inputs: agrees with the plain version, "
        f"max err {res_train['max_abs_err']:.3g}; {fwd_windows_line(res_train)}")
    del g, train_inputs

    # Stage 2 starts again from the scratch-initialized weights: stage 1's
    # steps on random weights move the geometry out of view, and stage 2's
    # frozen geometry would then keep its render nearly empty. The copy is
    # on the host, out of the stages' peak device memory.
    scratch_state = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    stage1 = train_phase(model, train_batch, hw, train_kwargs, card, stage=1)
    launches["train_stage1"] = {"composite_fwd": stage1["fwd"], "composite_bwd": stage1["bwd"]}
    model.load_state_dict(scratch_state)
    del scratch_state
    gc.collect()  # stage 1's optimizer state
    torch.cuda.empty_cache()
    stage2 = train_phase(model, train_batch, hw, train_kwargs, card, stage=2)
    launches["train_stage2"] = {"composite_fwd": stage2["fwd"], "composite_bwd": stage2["bwd"]}
    for kernel in ("composite_fwd", "composite_bwd"):
        if not any(v[kernel] for k, v in launches.items() if k.startswith("train")):
            raise AssertionError(f"kernel {kernel} was not launched on the training path")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # -- the training entry point: fit, validate, checkpoint, resume --------
    fit = fit_phase(card)
    launches["fit"] = fit.pop("launches")
    launches["fit_resume"] = fit.pop("resume_launches")
    for kernel in ("composite_fwd", "composite_bwd"):
        if not launches["fit"][kernel]:
            raise AssertionError(f"kernel {kernel} was not launched by the fit")

    # -- kernel times: device time from the profiler, after the paths'
    # timing, which the profiler's attached tracing would slow down ---------
    for what, res in (("dense cloud", res_dense), ("serving path's own inputs", res_main),
                      ("stage-1 training path's own inputs", res_train), ("alignment's own inputs", infer["fwd"]),
                      ("the video's first chunk", infer["video_fwd"]), ("the fit's first step's inputs", fit["fwd"]),
                      ("the fit's orthographic projection", fit["ortho_fwd"]),
                      ("pose recovery's first step", recovery_fwd),
                      ("eval_pose's refinement, first step", evaluation["fwd"]),
                      ("the refinement recovery's first step", evaluation["recovery_fwd"])):
        composite_device_ms(res)
        log(f"kernel composite_fwd, {what}: {res['ms']:.4f} ms on the device, {res['call_ms']:.4f} ms a call "
            f"(CUDA events, median of 20), plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.5f} ms "
            f"({res['bound_by']}, {res['evals']} pixel-pair evaluations) [{card}]")
        log(f"kernel composite_fwd, {what}: launched as {shape_text(res['launch'])} (profiler trace): "
            f"{res['launch']['blocks_per_tile']:g} blocks a tile, {res['launch']['threads_per_pixel']:g} threads a pixel")
    for what, res in (("dense cloud", bwd_dense), ("training path's own inputs", bwd_main),
                      ("alignment's own inputs", infer["bwd"]), ("the fit's first step's inputs", fit["bwd"]),
                      ("pose recovery's first step", recovery_bwd),
                      ("eval_pose's refinement, first step", evaluation["bwd"]),
                      ("the refinement recovery's first step", evaluation["recovery_bwd"])):
        composite_bwd_device_ms(res)
        log(f"kernel composite_bwd, {what}: {res['ms']:.4f} ms on the device (window sums "
            f"{res['phase_ms']['sums']:.4f} + gradients {res['phase_ms']['grad']:.4f}), {res['call_ms']:.4f} ms a "
            f"call (CUDA events, median of 20), plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.5f} ms "
            f"({res['bound_by']}, {res['evals']} pixel-pair evaluations) [{card}]")
        log(f"kernel composite_bwd, {what}: window sums launched as {shape_text(res['launch']['sums'])}, gradients "
            f"as {shape_text(res['launch']['grad'])} (profiler trace); {res['walked_blocks']} of the blocks of both "
            f"phases are on walked windows")

    reference_phase(card)

    def numbers(res):
        return {k: res[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "evals")}

    def fwd_numbers(res):
        return {**numbers(res), "windows": res["windows"], "launch": res["launch"]}

    def windows(res):
        return {k: res[k] for k in ("n_done_max", "n_done_mean", "walked_blocks")}

    def count(kernel):
        return {path: v[kernel] for path, v in launches.items()}

    def bwd_numbers(res):
        return {**numbers(res), "phase_ms": res["phase_ms"], "windows": windows(res), "launch": res["launch"],
                "max_abs_err": res["max_abs_err"], "max_rel_err": res["max_rel_err"]}

    all_bwd = (bwd_dense, bwd_main, infer["bwd"], fit["bwd"], recovery_bwd, evaluation["bwd"],
               evaluation["recovery_bwd"])

    kernels = [
        {
            "name": "composite_fwd",
            "route": "cuda",
            "source": "styl3r_tpu_torch/csrc/composite_fwd.cu",
            "replaces": "styl3r_tpu/ops/rasterizer/pallas_kernel.py:151",
            "launches": sum(count("composite_fwd").values()),
            "launches_by_path": count("composite_fwd"),
            "max_abs_err": max(res["max_abs_err"] for res in (res_dense, res_main, res_train, infer["fwd"],
                                                               infer["video_fwd"], fit["fwd"], fit["ortho_fwd"],
                                                               recovery_fwd, evaluation["fwd"],
                                                               evaluation["recovery_fwd"])),
            **{k: res_main[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "windows": res_main["windows"],
            "launch": res_main["launch"],
            "dense_cloud": fwd_numbers(res_dense),
            "train_inputs": fwd_numbers(res_train),
            "align_inputs": fwd_numbers(infer["fwd"]),
            "video_inputs": fwd_numbers(infer["video_fwd"]),
            "fit_inputs": {**fwd_numbers(fit["fwd"]), "max_abs_err": fit["fwd"]["max_abs_err"]},
            "ortho_inputs": {**fwd_numbers(fit["ortho_fwd"]), "max_abs_err": fit["ortho_fwd"]["max_abs_err"]},
            "recovery_inputs": {**fwd_numbers(recovery_fwd), "max_abs_err": recovery_fwd["max_abs_err"]},
            "refine_inputs": {**fwd_numbers(evaluation["fwd"]), "max_abs_err": evaluation["fwd"]["max_abs_err"]},
            "refine_recovery_inputs": {**fwd_numbers(evaluation["recovery_fwd"]),
                                       "max_abs_err": evaluation["recovery_fwd"]["max_abs_err"]},
        },
        {
            "name": "composite_bwd",
            "route": "cuda",
            "source": "styl3r_tpu_torch/csrc/composite_bwd.cu",
            "replaces": "styl3r_tpu/ops/rasterizer/pallas_backward.py:48",
            "launches": sum(count("composite_bwd").values()),
            "launches_by_path": count("composite_bwd"),
            "max_abs_err": max(r["max_abs_err"] for r in all_bwd),
            "max_rel_err": max(r["max_rel_err"] for r in all_bwd),
            **{k: bwd_main[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "phase_ms": bwd_main["phase_ms"],
            "windows": windows(bwd_main),
            "launch": bwd_main["launch"],
            "dense_cloud": {**numbers(bwd_dense), "phase_ms": bwd_dense["phase_ms"], "windows": windows(bwd_dense),
                            "launch": bwd_dense["launch"]},
            "align_inputs": bwd_numbers(infer["bwd"]),
            "fit_inputs": bwd_numbers(fit["bwd"]),
            "recovery_inputs": bwd_numbers(recovery_bwd),
            "refine_inputs": bwd_numbers(evaluation["bwd"]),
            "refine_recovery_inputs": bwd_numbers(evaluation["recovery_bwd"]),
        },
    ]
    training = {f"stage{i}": {k: st[k] for k in ("ms", "examples_per_s", "peak_gib", "live_pairs")}
                for i, st in ((1, stage1), (2, stage2))}
    inference = {
        **infer["times"], "psnr_unstylized": infer["psnr_unstylized"], "ply_vertices": infer["ply_vertices"],
        "launches": infer["launches"], "align_live_pairs": infer["live_pairs"],
        "delta_grad_rel_err": infer["delta_grad_rel_err"], "four_view": four_view, "recovery": recovery,
        "align_inputs_max_abs_err": {"composite_fwd": infer["fwd"]["max_abs_err"],
                                     "composite_bwd": infer["bwd"]["max_abs_err"]},
    }
    fit_summary = {k: v for k, v in fit.items() if k not in ("fwd", "bwd", "ortho_fwd")}
    evaluation_summary = {k: v for k, v in evaluation.items()
                          if k not in ("fwd", "bwd", "recovery_fwd", "recovery_bwd")}
    print(json.dumps({"kernels": kernels, "training": training, "inference": inference,
                      "evaluation": evaluation_summary, "fit": fit_summary, "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
