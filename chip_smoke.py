#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (styl3r_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles every kernel under styl3r_tpu_torch/csrc with nvcc, all
     at once, and the native host loader (styl3r_tpu_torch/native/loader.cpp,
     g++ and libjpeg; where it cannot be built, the reason is printed and the
     datasets decode with PIL, as the JAX package's do);
  3. distributed, first, while this process holds nothing on the card:
     multi-GPU training in child processes started with torchrun's
     environment (`chip_smoke.py --distributed-child ROLE JSON`;
     this process starts no process group): (a) train.main on
     re10k_2view_nvs.yaml (stage 1, full width, b = 2) at world size 1 over
     NCCL, 2 steps and a resume from their checkpoint to step 4, against the
     same fit without a group (the step-2 checkpoint's weights and Adam
     moments, the losses of steps 1-2; steps 3-4 reported), with the step's and
     the gradient all-reduce's times and bytes; (b) 2 ranks over gloo sharing
     the card, a stage-1 and a stage-2 step of the full-width model on a
     global batch of 2, against the mean of the halves' 1-process steps and
     the whole batch's 1-process step, both kernels held against their plain
     versions on rank 0's render and timed; (c) a tensor-parallel stage-1
     step on a (1, 1) (data, model) mesh over NCCL against the unsharded
     step; each part's launches are counted;
  4. kernels: holds each kernel against its plain PyTorch version on a dense
     saturating Gaussian cloud at the main path's scale (the backward with
     cotangents from a seeded generator; two calls of each kernel bitwise
     equal); prints the windows each tile has in range and walked;
  5. serving path: the full-width model (ViT-L 24x1024 encoders, 12x768
     decoders, random weights from a seed, bf16 backbone/stylizer and DPT
     trunks stored in bf16) serves three 2-view 256^2 scenes through
     Styl3rModel.forward; the forward compositor must have been launched
     once a scene; one more forward must launch the RoPE kernel once for
     each of the model's RoPE attentions (120), and on each of their own
     q/k the kernel must equal apply_rope2d on the card bitwise (any gap
     printed in ulp before it fails); then it is timed at the
     serving and stage-0 shapes against its byte bound, with the host's
     time a call and its gradient against autograd through apply_rope2d;
     the compositor is held against its plain version on the path's
     own inputs, and the forward is timed by bench/serve.py's measure: 10
     forwards back to back (throughput), 10 each synchronised (latency,
     encoder and render), and the host syncs of one; the three forwards
     must launch the heads' 3x3 conv kernel (csrc/conv3x3_f32.cu) twice
     each (the points heads' f32 head["2"]; the bf16 trunks bypass it);
     then the conv kernel (conv_phase): against F.conv2d with TF32 off
     (relative L2 at most 1e-5) at every routed head shape and ragged
     ones, with and without bias and ReLU, two calls bitwise equal, its
     gradient against F.conv2d's, no launch in bf16, under TF32 or
     autocast; its device time at the three largest routed shapes and the
     split-K levels against its f32 FFMA bound and cuDNN's f32 time
     (library_ms);
  6. posed route: the serving model's raw Gaussian channels and densities
     for the example batch, as models/encoder.py::_adapt receives them, go
     through posed_gaussian_adapter (each context view's own camera, the
     pixel-centre grid, depths that are each pixel's pts3d norm: 131,072
     Gaussians at 256^2); the target view is rendered with the serving caps
     and its MSE backpropagated to the raw channels and depths, 2 warm-up
     and 5 timed steps, each launching each kernel once; both kernels are
     held against their plain versions on the route's inputs and MSE
     cotangents, and the adapter on the card against the same call on the
     CPU;
  7. inference path: the same model through the inference entry points'
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
  8. evaluation entry points, at full width with random weights (f32
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
  9. training, stage 1: the full-width model with f32 master weights, a
     bf16 backbone, f32 heads (the Trainer's) and scratch_init_heads; both
     kernels are held against their
     plain versions on the path's own inputs (the backward with MSE
     cotangents); then 2 warm and 5 timed steps of make_train_step (MSE,
     make_optimizer) on b = 2 2-view 256^2 scenes, each of which launches
     each compositor kernel once and the heads' conv kernel 97 times (one
     forward); the warm steps' gradients reach the geometry heads;
 10. training, stage 2: the same model, back at its scratch-initialized
     weights, and batch, make_stage2_optimizer and style 10 + identity with
     VGG19 at random weights; every step launches each compositor kernel
     twice and the conv kernel 2 x 97 times (the main and the identity
     forward), leaves the frozen parameters bitwise unchanged and,
     from the second step, changes the stylizer and the appearance head;
 11. training entry point: styl3r_tpu_torch.train.main.main on the paper's
     stage 2 (configs/experiment/re10k_3view_style.yaml, full width, 3
     context views + 4 targets at 256^2, no pair cap) over synthetic RE10K
     chunks (360x640 noise JPEGs), 4 steps at b = 2 with a validation and a
     checkpoint every 2 steps; each step launches each kernel twice, each
     validation the forward 4 times; the validation images and checkpoints
     are checked, and the run is repeated as 2 steps plus a resume from
     their step-2 checkpoint, whose losses and last weights must match the
     uninterrupted run's. Step, validation and checkpoint times and sizes
     are read from the run's metrics.jsonl, and which decoder the dataset
     took (native, or PIL with its reason). Both kernels are held
     against their plain versions on the first step's own inputs and the
     forward on the first validation's orthographic projection;
 12. distillation: styl3r_tpu_torch.train.main.main on stage 0
     (configs/experiment/re10k_style_distill.yaml: the full-width student and
     a full-width DUSt3R/MASt3R teacher at random weights, frozen; Regr3D on
     the student's point maps, encoder-only steps, no render and no
     validation), 4 steps at b = 2 with a checkpoint every 2, then stage 1
     with the term (re10k_2view_nvs.yaml with losses.distill=0.1), 3 steps
     at b = 2, over the fit's synthetic chunks; every step runs the teacher
     once, stage 1 launches each kernel once a step, and every checkpoint
     must hold the student alone (its weights and AdamW moments, no teacher
     key). Step and teacher times (CUDA events), peak memory and checkpoint
     bytes are printed, and both kernels are held against their plain
     versions on stage 1's first step's own inputs and cotangents;
 13. secondary modules, at full width with random weights from fixed seeds,
     each held against the same module and weights on the CPU:
     get_backbone("resnet", model="resnet50") and get_backbone("dino",
     model="dino_vitb8") on 2 views at 256^2 (forward ms, median of 10,
     CUDA events; peak memory); NormalizedVGG (all five slices) on a 256^2
     style image and the Linear3D, AdaIN3D and AdaAttN3D stylizers at
     vgg_layer 3 on 131,072 points (held on 8,192 of them, timed on all);
     get_intrinsic_embedding at degree 4, project_rays of view 0's 65,536
     rays into view 1 (overlaps_image equal on every ray), lift_to_3d and
     get_depth; then a render route for both kernels: the pose-recovery
     cloud (131,072 Gaussians) on 2 views at 256^2, the AdaAttN loss
     (norm="adaattn", random VGG19) plus the depth-smoothness loss of the
     rendered depth weighted by the rendered image, backpropagated to the
     Gaussians (each step launches each kernel once); both kernels held
     against their plain versions on its inputs and cotangents, whose depth
     part, and the backward's depth column, must not be zero;
 14. bench: the measurement entry points through their main(), full
     width: styl3r_tpu_torch.bench.serve at its defaults (30 forwards back
     to back) and bench.stages at 10 iterations on one serving model, then
     bench.train_step's default cases (128:jnp, 128:pallas, and stage 1
     and stage 2 at b = 2, 256^2) on a training model; each prints its
     record on a line of its own. Each launches the forward kernel, stages
     and train_step the backward too; the 128:jnp and 128:pallas losses
     agree within 1e-4 of their size; both kernels are held against their
     plain versions on the 128^2 case's own inputs and MSE cotangents, and
     that step, computing in f32 (in bf16 the card's backward differs from
     run to run by more), through the plain compositor and through the
     kernels gives a loss and a squared gradient norm within 1e-4;
 15. overfit colmap: the scene-overfit entry point,
     styl3r_tpu_torch.train.overfit_colmap.main, at full width in f32 (the
     script's default; pts3d bound 20, scratch_init_heads) on a synthetic
     COLMAP scene built in a temporary directory (48 frames at 256^2 of
     three textured planes ray-cast along a camera arc, with points3D.bin
     sampled on them): 20 stage-1 steps with a held-out evaluation every
     10, then 4 stage-2 steps; each stage-1 step launches each kernel once,
     each stage-2 step twice, each held-out view the forward once; the
     steps and evaluations are timed with CUDA events, the record must be
     finite and carry the card; the scene's sparse anchor reaches both
     contexts; both kernels are held against their plain versions on the
     trained model's render of a training sample and its MSE cotangents;
 16. kernel times: each kernel's device time (torch.profiler, summed over
     the backward's two launches a call) and launch shape (grid, block and
     registers a thread, from the profiler's trace of the same calls), call
     time and plain version's time (CUDA events), beside its bound;
 17. reference: a tiny-width model's Gaussians on the card agree with the
     same model's on the CPU (whose agreement with the JAX package the CPU
     tests show);
 18. VGGT: VGGT-1B (models/vggt.py) at its published widths with random
     weights, one forward of 32 frames of 518x392 and one of 2 (each after a
     warm-up): its kernel launches, RoPE launches (2 x depth = 48 a forward,
     or the phase fails), the SDPA backend its aggregator's attention took
     (from the kernels' names; the math backend fails the phase), the peak
     memory and the latency, and each output's relative L2 gap from the
     plain float32 reference (tests/vggt_reference.py) on the same weights
     and images; with cuDNN's TF32 allowed, as the vggt.serve-32f518 cell
     runs, a request launches the conv kernel 0 times.
Every path that runs the model on the card must launch the RoPE kernel,
and the training paths with f32 heads (stage 1 and 2 above, the fit, stage
0 of the distillation, bench.train_step) the heads' conv kernel.
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
sys.path.insert(0, ROOT)

from styl3r_tpu_torch.bench import batch as bench_batch  # noqa: E402
from styl3r_tpu_torch.bench.common import plain_compositor  # noqa: E402,F401  (the phases' and scripts' plain route)
from styl3r_tpu_torch.bench.timing import card_line, cuda_ms, kernel_device_ms  # noqa: E402,F401
from styl3r_tpu_torch.utils import trace  # noqa: E402
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



def kernel_launches():
    """(forward, backward) compositor kernel launches since trace.reset():
    utils/trace.py's counters, in which a backward call launches its two
    phases."""
    c = trace.counters()
    return c["composite_fwd"], c["composite_bwd"]


def launch_record():
    """Every kernel's launches since trace.reset(), by its name."""
    return trace.counters()


def compositor_launches(record):
    """(forward, backward) compositor launches of a launch_record()."""
    return record["composite_fwd"], record["composite_bwd"]

def log(msg):
    print(msg, flush=True)


def shape_text(shape):
    blocks = shape["grid"][0] * shape["grid"][1] * shape["grid"][2]
    return (f"{blocks} blocks (grid {'x'.join(map(str, shape['grid']))}) of "
            f"{shape['block'][0] * shape['block'][1] * shape['block'][2]} threads, "
            f"{shape['registers']} registers a thread")


def example_batch(seed, device, v=2, hw=256, t=1, b=1, targets=False):
    """bench.py's scene (bench_train_step.py's with b > 1) from a fresh
    generator seeded with `seed`: v context views + a style image of uniform
    noise, t targets (the first at context view 0's camera, the others 0.2
    along x), with target images if `targets`."""
    import numpy as np

    return bench_batch.example_batch(np.random.default_rng(seed), b, v, hw, hw, t, hw, device, targets)


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
        nonzero_by_column=[int((kern[:, c] != 0).sum()) for c in range(composite.N_GRAD)],
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


def render_cotangents(inputs, max_per_tile, loss_of_render):
    """A loss's cotangents at the compositor's outputs: dL/dcolor and
    dL/ddepth in the tile layout of loss_of_render((n_views, h, w, 3)
    rendered colors, (n_views, h, w) rendered depths), zeros where the loss
    does not read depth; alpha gets none, and with a black background the
    folded dalpha is 0."""
    import torch

    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.ops.rasterizer.render import _tiles_to_image

    out = composite.composite_tiles(
        inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds, inputs.grid, max_per_tile, inputs.n_views
    )
    with torch.enable_grad():
        color = out.color.detach().requires_grad_()
        depth = out.depth.detach().requires_grad_()
        loss = loss_of_render(*(_tiles_to_image(x, inputs.n_views, *inputs.grid) for x in (color, depth)))
        dcolor, ddepth = torch.autograd.grad(loss, (color, depth), allow_unused=True)
    return dcolor, torch.zeros_like(depth) if ddepth is None else ddepth, torch.zeros_like(out.alpha)


def image_cotangents(inputs, max_per_tile, loss_of_images):
    """render_cotangents of a loss of the rendered colors alone: the depth's
    cotangent is 0."""
    return render_cotangents(inputs, max_per_tile, lambda color, depth: loss_of_images(color))


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
            trace.reset()
            metrics = cli.run_scene_inference(
                model, images, intrinsics, extrinsics, context, targets, style, out_dir, image_shape=hw,
                align_pose_steps=steps, video_frames=frames, benchmarker=bench,
            )
            torch.cuda.synchronize()
            launches = launch_record()
        finally:
            cli.align_target_poses, pipeline.InferencePipeline.render = real_align, real_render
        expected = (steps + 2 + -(-frames // 10), 2 * steps)
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
    trace.reset()
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
        if kernel_launches()[0] != i + 1 or not 0 < live <= slots:
            raise AssertionError(f"4-view predict: {kernel_launches()[0]} launches after {i + 1} calls, live pairs "
                                 f"{live} of {slots} slots")
    launches = launch_record()
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
    trace.reset()
    t0.record()
    aligned = align_target_poses(gaussians, start, k, near, far, target.color, hw, steps=steps,
                                 rot_lr=5e-3, trans_lr=5e-3, **render_kwargs)
    t1.record()
    torch.cuda.synchronize()
    launches = launch_record()
    if (launches["composite_fwd"], launches["composite_bwd"]) != (steps, 2 * steps):
        raise AssertionError(f"pose recovery: compositor launches {launches}, expected {steps} calls of each")
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
    trace.reset()
    t0.record()
    refined = refine_pose_photometric(gaussians, start, k, target.color[0, 0], near, far, steps=steps,
                                      **render_kwargs)
    t1.record()
    torch.cuda.synchronize()
    launches = launch_record()
    if (launches["composite_fwd"], launches["composite_bwd"]) != (steps, 2 * steps):
        raise AssertionError(f"refinement recovery: compositor launches {launches}, expected {steps} calls of each")
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
            before = kernel_launches()
            ext = real_align(*args, **kwargs)
            align_launches.append((kernel_launches()[0] - before[0], kernel_launches()[1] - before[1]))
            return ext

        harness.EvalHarness.test_step, harness.align_target_poses = record_step, record_align
        try:
            torch.cuda.reset_peak_memory_stats()  # peak_memory.json: evaluate's own peak
            trace.reset()
            t0 = time.perf_counter()
            means = evaluate.main([*data, f"test.output_path={out}", "test.align_pose=true",
                                   f"test.pose_align_steps={align_steps}", "test.save_image=true"])
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            eval_launches = launch_record()
        finally:
            harness.EvalHarness.test_step, harness.align_target_poses = real_step, real_align
        gc.collect()
        torch.cuda.empty_cache()
        if align_launches != [(align_steps, 2 * align_steps)] * scenes:
            raise AssertionError(f"evaluate: each alignment's (fwd, bwd) launches {align_launches}, expected "
                                 f"{align_steps} of each a scene")
        expected = (scenes * (align_steps + 1), 2 * scenes * align_steps)
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
            before = kernel_launches()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            refined = real_refine(*args, steps=steps, **kwargs)
            end.record()
            torch.cuda.synchronize()
            refinements.append(dict(
                args=args, kwargs=kwargs, ms_per_step=start.elapsed_time(end) / steps,
                launches=(kernel_launches()[0] - before[0], kernel_launches()[1] - before[1]),
            ))
            return refined

        pose.refine_pose_photometric = record_refine
        try:
            trace.reset()
            t0 = time.perf_counter()
            aucs = eval_pose.main([*data, "--refine-steps", str(refine_steps)])
            torch.cuda.synchronize()
            pose_s = time.perf_counter() - t0
            pose_launches = launch_record()
        finally:
            pose.refine_pose_photometric = real_refine
        if sorted(aucs) != [5, 10, 20] or not all(math.isfinite(v) for v in aucs.values()):
            raise AssertionError(f"eval_pose: AUCs {aucs}")
        if [r["launches"] for r in refinements] != [(refine_steps, 2 * refine_steps)] * scenes:
            raise AssertionError(f"eval_pose: each refinement's (fwd, bwd) launches "
                                 f"{[r['launches'] for r in refinements]}, expected {refine_steps} calls of each a scene")
        if (pose_launches["composite_fwd"], pose_launches["composite_bwd"]) != (scenes * refine_steps, 2 * scenes * refine_steps):
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


# The heads' routed 3x3 convs (ops/conv.py::conv3x3) in an encoder forward
# with float32 heads: 2 pts3d heads x 20, 2 gs heads x 19, the appearance
# head 19.
CONV3X3_PER_FORWARD = 97


def train_phase(model, batch, hw, render_kwargs, card, stage, reps=5, warm=2):
    """Drive make_train_step on the full-width model (float32 heads): `warm`
    + `reps` steps, each checked, the last `reps` timed with CUDA events."""
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
    trace.reset()
    times, losses, lives = [], [], []
    for i in range(warm + reps):
        fwd0, bwd0 = kernel_launches()
        conv0 = trace.counters()["conv3x3_f32"]
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
        launched = (kernel_launches()[0] - fwd0, kernel_launches()[1] - bwd0)
        if launched != (per_step, 2 * per_step):
            raise AssertionError(f"{where}: compositor launches (fwd, bwd) {launched}, expected {per_step} calls of each")
        convs = trace.counters()["conv3x3_f32"] - conv0
        if convs != CONV3X3_PER_FORWARD * per_step:
            raise AssertionError(f"{where}: {convs} launches of the heads' conv kernel, expected "
                                 f"{CONV3X3_PER_FORWARD * per_step} ({per_step} forwards)")
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
        f"of {slots} slots; launches fwd {kernel_launches()[0]} bwd {kernel_launches()[1]}, conv3x3 {convs} a step "
        f"[{card}]")
    return dict(ms=ms, examples_per_s=1e3 * b / ms, peak_gib=peak_gb, fwd=kernel_launches()[0],
                bwd=kernel_launches()[1], conv3x3=trace.counters()["conv3x3_f32"], conv3x3_per_step=convs,
                losses=losses, live_pairs=lives)


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
        self.datasets = []
        self._in_ortho = False

    def decoders(self):
        """Which decoder the run's datasets took, by the examples each
        gave: native, or PIL with the first fallback's reason."""
        native = sum(d.decoded["native"] for d in self.datasets)
        pil = sum(d.decoded["pil"] for d in self.datasets)
        reasons = sorted({d.fallback_reason for d in self.datasets if d.fallback_reason})
        return {"native": native, "pil": pil, "pil_reasons": reasons}

    @contextlib.contextmanager
    def attached(self):
        from styl3r_tpu_torch.ops.rasterizer import composite
        from styl3r_tpu_torch.train import trainer as trainer_mod

        probe = self
        saved = (trainer_mod.render_orthographic, composite.composite_tiles, composite.composite_backward,
                 trainer_mod.build_datasets)
        render_ortho, fwd, bwd, build_datasets = saved

        def recorded_datasets(*args, **kwargs):
            datasets = build_datasets(*args, **kwargs)
            probe.datasets.extend(datasets)
            return datasets

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

        trainer_mod.render_orthographic, trainer_mod.build_datasets = tagged_ortho, recorded_datasets
        composite.composite_tiles, composite.composite_backward = record_fwd, record_bwd
        try:
            yield self
        finally:
            (trainer_mod.render_orthographic, composite.composite_tiles, composite.composite_backward,
             trainer_mod.build_datasets) = saved


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


def checkpoint_moments(path):
    """A trainer checkpoint's AdamW moments, on the host, by parameter and
    moment."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)["optimizer"]["adamw"]["state"]
    return {f"{i}.{k}": v.clone() for i, moments in state.items() for k, v in moments.items() if k != "step"}


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
        trace.reset()
        state, probe, seconds, rec = run(whole, steps)
        launches = launch_record()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        train_rec, val_rec = rec["train"], rec["val"]
        losses = [r["loss"] for r in train_rec]
        if state.step != steps or [r["step"] for r in train_rec] != list(range(1, steps + 1)):
            raise AssertionError(f"fit: {state.step} steps, logged {[r['step'] for r in train_rec]}")
        if not all(math.isfinite(x) for x in losses) or len(val_rec) != steps // 2:
            raise AssertionError(f"fit: losses {losses}, {len(val_rec)} validations")
        # Each step renders twice (stylized and identity) and each validation
        # 4 times (targets, trajectory, projections, wobble).
        expected = (2 * steps + 4 * (steps // 2), 4 * steps)
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
        decoders = probe.decoders()
        if not decoders["native"] + decoders["pil"]:
            raise AssertionError("fit: its datasets decoded no example")
        log(f"fit: the dataset decoded {decoders['native']} examples natively (styl3r_tpu_torch/native) and "
            f"{decoders['pil']} with PIL" + (f" ({'; '.join(decoders['pil_reasons'])})" if decoders["pil_reasons"]
                                             else "") + f"; data wait above [{card}]")

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
        trace.reset()
        run(part, steps // 2)
        resume_ckpt = os.path.join(part, "checkpoints", f"step_{steps // 2}.pt")
        start_weights = checkpoint_weights(resume_ckpt)
        resumed, _, _, rec = run(part, steps, f"checkpointing.load={resume_ckpt}", "checkpointing.resume=true")
        resume_launches = launch_record()
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
        live_pairs=live, pair_slots=slots, val_psnr=[r["val_psnr"] for r in val_rec], decoders=decoders,
        fwd=fwd_res, bwd=bwd_res, ortho_fwd=ortho_res,
    )


DISTILL_CONFIG = "configs/experiment/re10k_style_distill.yaml"
DISTILL_STAGE1_CONFIG = "configs/experiment/re10k_2view_nvs.yaml"


class TeacherProbe:
    """Times each forward of the distillation teacher with CUDA events (read
    after the run) and keeps the first call's outputs."""

    def __init__(self):
        self.events, self.first = [], None

    @contextlib.contextmanager
    def attached(self):
        import torch

        from styl3r_tpu_torch.models.distiller import Dust3RTeacher

        probe, forward = self, Dust3RTeacher.forward

        def timed(module, images):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = forward(module, images)
            end.record()
            probe.events.append((start, end))
            probe.first = probe.first or {k: v.detach().clone() for k, v in out.items()}
            return out

        Dust3RTeacher.forward = timed
        try:
            yield self
        finally:
            Dust3RTeacher.forward = forward

    def ms(self):
        return [start.elapsed_time(end) for start, end in self.events]


def student_checkpoint(path, n_params):
    """A trainer checkpoint's contents, checked to hold the student alone:
    every weight under `encoder.`, the full-width model's parameter count,
    and AdamW moments for each of its weights (stage 0 and 1 train them all).
    Returns its bytes; the file is deleted after the check."""
    import torch

    size = os.path.getsize(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    model = ckpt["model"]
    strangers = [k for k in model if not k.startswith("encoder.")]
    count = sum(v.numel() for v in model.values())
    tensors, moments = len(model), len(ckpt["optimizer"]["adamw"]["state"])
    del ckpt, model
    os.remove(path)
    if strangers or count != n_params or moments != tensors:
        raise AssertionError(f"distill: {path} holds {strangers[:3]} outside the student, {count} weights "
                             f"(expected {n_params}), moments for {moments} tensors")
    return size


def distill_phase(card, batch_size=2, steps=4, stage1_steps=3, hw=(256, 256)):
    """The distillation stage through the training entry point,
    styl3r_tpu_torch.train.main.main, full width, on synthetic chunks:
    (a) stage 0 (re10k_style_distill.yaml: the frozen MASt3R teacher, at
    random weights drawn on the CPU since no MASt3R weights are in the repo;
    Regr3D on the student's point maps, encoder-only steps, the backbone at
    0.1x lr), `steps` steps at b = `batch_size` (the config's 32 cut) with a
    checkpoint every 2, keeping 1, and a validation due every 2 that stage 0
    skips; (b) stage 1 with the term (re10k_2view_nvs.yaml with
    losses.distill=0.1, the config's renderer caps: no pair cap),
    `stage1_steps` steps at b = `batch_size`. Each step runs the teacher
    once; stage 0 launches no compositor kernel, stage 1 each kernel once a
    step. Every checkpoint must hold the student alone. Both kernels are held
    against their plain versions on stage 1's first step's own inputs and
    cotangents (MSE + LPIPS + 0.1 x Regr3D)."""
    import shutil
    import tempfile

    import torch

    from styl3r_tpu_torch.models.distiller import Dust3RTeacher
    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.train import main as train_main

    n_params = 1_043_732_697
    with torch.device("meta"):
        n_teacher = sum(p.numel() for p in Dust3RTeacher().parameters())
    # f32 weights and two Adam moments a parameter; a run keeps up to two
    # checkpoints and a third being written.
    need = 3 * 12 * n_params + 2**30
    with tempfile.TemporaryDirectory(prefix="styl3r_distill_") as tmp:
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise AssertionError(f"distill: {free / 2**30:.1f} GiB free under {tmp}, the checkpoints need "
                                 f"{need / 2**30:.1f} GiB")
        root = os.path.join(tmp, "re10k")
        fit_chunks(root)

        def run(config, out, max_steps, *extra):
            args = ["--config", os.path.join(ROOT, config), "--max-steps", str(max_steps),
                    f"datasets.0.roots=[{root}]", f"datasets.0.style_root={os.path.join(root, 'styles')}",
                    f"datasets.0.input_image_shape=[{hw[0]},{hw[1]}]", f"train.batch_size={batch_size}",
                    "train.log_every_n_steps=1", "checkpointing.save_top_k=1", f"checkpointing.output_dir={out}",
                    *extra]
            teacher, kernels = TeacherProbe(), FitProbe()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            trace.reset()
            t0 = time.perf_counter()
            with teacher.attached(), kernels.attached():
                state = train_main.main(args)
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = launch_record()
            rec = fit_metrics(out)
            train_rec = rec["train"]
            if state.step != max_steps or [r["step"] for r in train_rec] != list(range(1, max_steps + 1)):
                raise AssertionError(f"distill: {state.step} steps, logged {[r['step'] for r in train_rec]}")
            if not all(math.isfinite(r["loss"]) and r["distill"] > 0 for r in train_rec):
                raise AssertionError(f"distill: losses {[(r['loss'], r['distill']) for r in train_rec]}")
            if len(teacher.events) != max_steps:
                raise AssertionError(f"distill: the teacher ran {len(teacher.events)} times in {max_steps} steps")
            return dict(state=state, seconds=seconds, launches=launches, rec=rec, teacher=teacher, kernels=kernels,
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30)

        def checkpoints(out):
            ckpt_dir = os.path.join(out, "checkpoints")
            return {name: student_checkpoint(os.path.join(ckpt_dir, name), n_params)
                    for name in sorted(os.listdir(ckpt_dir))}

        def summary(res):
            step_ms = [r["step_ms"] for r in res["rec"]["train"]]
            return dict(step_ms=step_ms, teacher_ms=res["teacher"].ms(), peak_gib=res["peak_gib"],
                        seconds=res["seconds"], launches=res["launches"],
                        losses=[r["loss"] for r in res["rec"]["train"]],
                        distill=[r["distill"] for r in res["rec"]["train"]])

        # -- (a) stage 0 ------------------------------------------------------------
        out0 = os.path.join(tmp, "stage0")
        res0 = run(DISTILL_CONFIG, out0, steps, "train.val_every_n_steps=2", "checkpointing.every_n_train_steps=2")
        stage0 = summary(res0)
        if res0["rec"]["val"] or res0["rec"]["validate"] or os.path.exists(os.path.join(out0, "val_comparison")):
            raise AssertionError("distill: stage 0 ran a validation")
        if any(compositor_launches(res0["launches"])):
            raise AssertionError(f"distill: stage 0 launched the compositor {res0['launches']}")
        if any(set(r) & {"mse", "live_pairs"} for r in res0["rec"]["train"]):
            raise AssertionError("distill: stage 0 rendered")
        if any(r["loss"] != r["distill"] for r in res0["rec"]["train"]):
            raise AssertionError("distill: stage 0's loss is not the distillation term alone")
        save = res0["rec"]["save"]
        stage0["checkpoint_seconds"] = [r["checkpoint_seconds"] for r in save]
        stage0["checkpoint_bytes"] = checkpoints(out0)
        # Every 2 steps, then the final one.
        if sorted(stage0["checkpoint_bytes"]) != ["final.pt", f"step_{steps}.pt"] or len(save) != steps // 2 + 1:
            raise AssertionError(f"distill: stage 0 checkpoints {stage0['checkpoint_bytes']}, {len(save)} saves")
        first = res0["teacher"].first
        conf_share = float((first["conf_1"] >= 3.0).float().mean())
        if not all(bool(torch.isfinite(v).all()) for v in first.values()) or first["pts3d_1"].shape != (
                batch_size, *hw, 3):
            raise AssertionError("distill: the teacher's first output is non-finite or misshapen")
        shutil.rmtree(out0)
        ckpt_bytes = stage0["checkpoint_bytes"]["final.pt"]
        log(f"distill stage 0: {steps} steps of re10k_style_distill.yaml at b = {batch_size} (2 context views at "
            f"{hw[0]}x{hw[1]}; student {n_params:,} parameters with f32 weights, a bf16 backbone at 0.1x lr; teacher "
            f"{n_teacher:,} parameters in f32, drawn at random) in {stage0['seconds']:.1f} s with the models' builds "
            f"and {len(save)} checkpoints: {statistics.median(stage0['step_ms'][1:]):.2f} ms/step (median of steps "
            f"2-{steps}; the trainer's CUDA events), the first {stage0['step_ms'][0]:.2f} ms; the teacher's forward "
            f"{statistics.median(stage0['teacher_ms'][1:]):.2f} ms (median of calls 2-{steps}; the first "
            f"{stage0['teacher_ms'][0]:.2f}); peak memory {stage0['peak_gib']:.2f} GiB; loss "
            f"{stage0['losses'][0]:.5f} -> {stage0['losses'][-1]:.5f}; {conf_share:.3f} of the teacher's first "
            f"view-1 points at conf >= 3; no validation; launches fwd 0 bwd 0 [{card}]")
        log(f"distill stage 0: checkpoint {ckpt_bytes} bytes ({ckpt_bytes / 2**30:.2f} GiB: f32 weights and AdamW "
            f"moments of every student parameter, no teacher key), saved in "
            f"{', '.join(f'{t:.2f}' for t in stage0['checkpoint_seconds'])} s [{card}]")

        # -- (b) stage 1 with the term ------------------------------------------------
        out1 = os.path.join(tmp, "stage1")
        res1 = run(DISTILL_STAGE1_CONFIG, out1, stage1_steps, "losses.distill=0.1", "train.val_every_n_steps=100",
                   "checkpointing.every_n_train_steps=100")
        stage1 = summary(res1)
        train_rec = res1["rec"]["train"]
        if (res1["launches"]["composite_fwd"], res1["launches"]["composite_bwd"]) != (stage1_steps, 2 * stage1_steps):
            raise AssertionError(f"distill: stage 1 launches {res1['launches']}, expected {stage1_steps} calls of each")
        for r in train_rec:
            if not r["loss"] >= r["mse"] + r["distill"] - 1e-6 * abs(r["loss"]):
                raise AssertionError(f"distill: stage 1's loss {r['loss']} lacks mse {r['mse']} + distill "
                                     f"{r['distill']}")
        stage1["checkpoint_bytes"] = checkpoints(out1)
        stage1["live_pairs"], stage1["pair_slots"] = int(train_rec[0]["live_pairs"]), int(train_rec[0]["pair_slots"])
        stage1["mse"] = [r["mse"] for r in train_rec]

        # -- the kernels on stage 1's first step's own inputs ----------------------
        probe = res1["kernels"]
        bwd_args, bwd_max = probe.bwd
        inputs, max_per_tile = compositor_inputs(probe.train_fwd[0])
        n_views = inputs.n_views
        with torch.no_grad():
            fwd_res = check_composite(inputs, max_per_tile)
            own, = [c for c in probe.train_fwd if c[0].data_ptr() == bwd_args[0].data_ptr()]
            bwd_inputs, _ = compositor_inputs(own)
            bwd_res = check_composite_bwd(bwd_inputs, bwd_max, *bwd_args[5:8])
        del res1, probe, bwd_args, own, inputs, bwd_inputs
        log(f"distill stage 1: {stage1_steps} steps of re10k_2view_nvs.yaml with losses.distill=0.1 at b = "
            f"{batch_size} (2 context views + 4 targets at {hw[0]}x{hw[1]}, MSE + LPIPS at random weights + 0.1 x Regr3D, "
            f"the config's caps: max_per_tile {max_per_tile}, no pair cap) in {stage1['seconds']:.1f} s with the "
            f"models' builds and the final checkpoint: {statistics.median(stage1['step_ms'][1:]):.2f} ms/step "
            f"(median of steps 2-{stage1_steps}), the first {stage1['step_ms'][0]:.2f} ms; the teacher's forward "
            f"{statistics.median(stage1['teacher_ms'][1:]):.2f} ms; peak memory {stage1['peak_gib']:.2f} GiB; "
            f"distill {stage1['distill'][0]:.5f}, mse {stage1['mse'][0]:.5f} at the first step; live pairs "
            f"{stage1['live_pairs']} of {stage1['pair_slots']} slots; launches fwd "
            f"{stage1['launches']['composite_fwd']} bwd {stage1['launches']['composite_bwd']}; final checkpoint "
            f"{stage1['checkpoint_bytes']['final.pt']} bytes, no teacher key [{card}]")
        log(f"kernel composite_fwd, stage 1 + distill's first step's own inputs ({n_views} fused "
            f"views): agrees with the plain version, max err {fwd_res['max_abs_err']:.3g}; {fwd_windows_line(fwd_res)}")
        log(f"kernel composite_bwd, stage 1 + distill's first step's own inputs and cotangents: agrees with the "
            f"plain version, max err {bwd_res['max_abs_err']:.3g} ({bwd_res['max_rel_err']:.3g} of its column's "
            f"largest gradient), {bwd_res['pairs_with_grad']} pairs with a gradient of {bwd_res['walked']} walked, "
            f"up to {bwd_res['n_done_max']} windows; {bwd_res['zero_mismatch']} values 0 in one version only, at "
            f"most {bwd_res['zero_mismatch_max']:.3g}; two calls bitwise equal")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(stage0=stage0, stage1=stage1, teacher_params=n_teacher, conf_share=conf_share,
                batch_size=batch_size, fwd=fwd_res, bwd=bwd_res)


# Module on the card against the same module and weights on the CPU: 1e-4 of
# the CPU output's largest magnitude (f32 convolutions, matmuls and attention
# summed in another order, TF32 off). The 3-D stylizers add the CPU output's
# own distance from the module run in float64: AdaAttN3D's standard
# deviation, sqrt(E[s^2] - E[s]^2) under the attention, cancels where a
# point's attention is nearly one-hot (tests/test_torch_stylizers3d.py).
SECONDARY_TOL = 1e-4
# Geometry on the card against the CPU, values of order 1: rounding only;
# lift_to_3d and get_depth times each point's least-squares system's
# condition number (tests/test_torch_camera_geometry.py).
GEOMETRY_TOL = 1e-5


def hold_on_cpu(what, module, cpu_args, anchored=False):
    """`module` (on the card) against a copy on the CPU, the same inputs
    (CPU tensors, moved for the card): the largest difference over the CPU
    output's largest magnitude, checked. Lists of outputs (NormalizedVGG's
    slices) are held output by output."""
    import copy

    import torch

    dev = next(module.parameters()).device
    cpu = copy.deepcopy(module).cpu()
    with torch.no_grad():
        ours = module(*(a.to(dev) for a in cpu_args))
        ref = cpu(*cpu_args)
        exact = copy.deepcopy(cpu).double()(*(a.double() for a in cpu_args)) if anchored else None
    if not isinstance(ours, (list, tuple)):
        ours, ref, exact = [ours], [ref], [exact]
    worst = 0.0
    for i, (a, b) in enumerate(zip(ours, ref)):
        a = a.cpu()
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: output {i} on the card is non-finite or misshapen: {tuple(a.shape)}")
        scale = float(b.abs().max())
        own = float((b.double() - exact[i]).abs().max()) if anchored else 0.0
        err = float((a - b).abs().max())
        if not scale > 0 or err > SECONDARY_TOL * scale + own:
            raise AssertionError(f"{what}: output {i} differs from the CPU's by {err} > {SECONDARY_TOL} * {scale} + {own}")
        worst = max(worst, err / scale)
    return worst


def timed_forward(fn, reps):
    """Median ms of `reps` warm calls (CUDA events) and the peak device
    memory, GiB, that one call allocates beyond what is resident."""
    import torch

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        return cuda_ms(fn, reps), peak


def geometry_condition(directions, xy, extrinsics, intrinsics):
    """Condition number of each point's 3x3 least-squares system in
    lift_to_3d (the sum over its two rays of d d^T - I), in float64."""
    import numpy as np

    from styl3r_tpu_torch.geometry.projection import get_world_rays

    _, xy_dirs = get_world_rays(*(x.cpu().double() for x in (xy, extrinsics, intrinsics)))
    lhs = sum(np.einsum("ni,nj->nij", d, d) - np.eye(3) for d in (directions.cpu().double().numpy(), xy_dirs.numpy()))
    return np.linalg.cond(lhs)


def secondary_phase(card, device="cuda", hw=256, resnet="resnet50", dino="dino_vitb8", n_points=131072,
                    check_points=8192, g=131072, reps=10):
    """The rest of the model surface at full width, random weights from
    fixed seeds, each module held against the same module on the CPU:
    (a) get_backbone("resnet" / "dino") on b = 1, 2 views at hw^2; (b)
    NormalizedVGG (all five slices) on an hw^2 style image, then the
    Linear3D, AdaIN3D and AdaAttN3D stylizers at vgg_layer 3 on `n_points`
    points (one per pixel of 2 views: the Gaussian cloud Styl3R predicts),
    held on `check_points` of them; (c) get_intrinsic_embedding at degree 4
    on 2 views, project_rays of view 0's hw^2 rays into view 1, lift_to_3d
    and get_depth; (d) a render route for both kernels: the pose-recovery
    cloud through render_gaussians on 2 views, the AdaAttN loss
    (norm="adaattn", the training phases' random VGG19) plus the
    depth-smoothness loss of the rendered depth weighted by the rendered
    image, backpropagated to the Gaussians; both kernels held against their
    plain versions on the route's inputs and cotangents, whose depth part is
    not zero."""
    import numpy as np
    import torch

    from styl3r_tpu_torch.geometry import camera_emb, epipolar_lines
    from styl3r_tpu_torch.geometry.projection import get_world_rays, sample_image_grid
    from styl3r_tpu_torch.geometry.se3 import se3_exp
    from styl3r_tpu_torch.losses.adaattn import adaattn_loss
    from styl3r_tpu_torch.losses.depth import depth_smoothness_loss
    from styl3r_tpu_torch.losses.vgg import VGG19Features
    from styl3r_tpu_torch.models.decoder import render_gaussians
    from styl3r_tpu_torch.models.registry import get_backbone
    from styl3r_tpu_torch.models.stylizers import (
        AdaAttN3DStylizer,
        AdaIN3DStylizer,
        Linear3DStylizer,
        NormalizedVGG,
    )
    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.utils.convert import init_like_flax_

    dev = torch.device(device)
    rng = np.random.default_rng(20)
    res = {}

    def card_module(module, seed):
        init_like_flax_(module, torch.Generator().manual_seed(seed))
        return module.to(dev).eval()

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32))

    # -- (a) backbones ------------------------------------------------------------
    images = tensor(rng.uniform(-1, 1, (1, 2, hw, hw, 3)))
    for name, kw, seed in (("resnet", dict(model=resnet, d_out=128), 30),
                           ("dino", dict(model=dino, d_out=128, image_size=(hw, hw)), 31)):
        module = card_module(get_backbone(name, **kw), seed)
        err = hold_on_cpu(f"backbone {name}", module, (images,))
        x = images.to(dev)
        ms, peak = timed_forward(lambda: module(x), reps)
        n_params = sum(p.numel() for p in module.parameters())
        res[f"backbone_{name}"] = dict(model=kw["model"], params=n_params, ms=ms, peak_gib=peak, rel_err=err)
        log(f"secondary: get_backbone({name!r}, model={kw['model']!r}, d_out=128), {n_params:,} parameters, on b = 1, "
            f"2 views at {hw}x{hw}: within {err:.3g} of its largest output of the CPU's; forward {ms:.3f} ms (median "
            f"of {reps}, CUDA events), peak {peak:.2f} GiB beyond what is resident [{card}]")
        del module
    torch.cuda.empty_cache()

    # -- (b) NormalizedVGG and the 3-D stylizers ------------------------------------
    style = tensor(rng.uniform(0, 1, (1, hw, hw, 3)))
    vgg = card_module(NormalizedVGG(), 32)
    err = hold_on_cpu("NormalizedVGG", vgg, (style,))
    s = style.to(dev)
    ms, peak = timed_forward(lambda: vgg(s), reps)
    res["normalized_vgg"] = dict(ms=ms, peak_gib=peak, rel_err=err)
    log(f"secondary: NormalizedVGG, all five slices of a {hw}x{hw} style image: within {err:.3g} of the CPU's; "
        f"{ms:.3f} ms, peak {peak:.2f} GiB [{card}]")
    del vgg
    feats = tensor(rng.normal(0.0, 1.0, (1, n_points, 256)))
    pick = torch.from_numpy(rng.choice(n_points, check_points, replace=False))
    for name, module, seed in (("linear3d", Linear3DStylizer(vgg_layer=3), 33),
                               ("adain3d", AdaIN3DStylizer(vgg_layer=3), 34),
                               ("adaattn3d", AdaAttN3DStylizer(feats_in_dim=256, vgg_layer=3), 35)):
        module = card_module(module, seed)
        err = hold_on_cpu(f"stylizer {name}", module, (style, feats[:, pick]), anchored=True)
        f = feats.to(dev)
        with torch.no_grad():
            out = module(s, f)
        if out.shape != (1, n_points, 256) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"stylizer {name}: non-finite or misshapen output at {n_points} points")
        ms, peak = timed_forward(lambda: module(s, f), reps)
        res[name] = dict(ms=ms, peak_gib=peak, rel_err=err, points=n_points, held_points=check_points)
        log(f"secondary: {name} at vgg_layer 3 (256 channels over {(hw // 4) ** 2} style positions): within {err:.3g} "
            f"of the CPU's on {check_points} points; {ms:.3f} ms at {n_points} points, peak {peak:.2f} GiB [{card}]")
        del module, out, f
    torch.cuda.empty_cache()

    # -- (c) geometry -------------------------------------------------------------
    k = torch.tensor([[0.9, 0, 0.5], [0, 0.95, 0.5], [0, 0, 1.0]]).expand(1, 2, 3, 3).contiguous()
    ext = torch.stack([torch.eye(4), se3_exp(torch.tensor([0.3, -0.05, 0.1, 0.05, -0.2, 0.03]))])[None]
    emb = camera_emb.get_intrinsic_embedding(k.to(dev), (hw, hw), 4)
    emb_ref = camera_emb.get_intrinsic_embedding(k, (hw, hw), 4)
    emb_err = float((emb.cpu() - emb_ref).abs().max())
    if emb.shape != (1, 2, hw, hw, 25) or emb_err > GEOMETRY_TOL:
        raise AssertionError(f"get_intrinsic_embedding: {tuple(emb.shape)}, {emb_err} from the CPU's")
    emb_ms = cuda_ms(lambda: camera_emb.get_intrinsic_embedding(k.to(dev), (hw, hw), 4), reps)

    coords, _ = sample_image_grid((hw, hw))
    origins, directions = get_world_rays(coords.reshape(-1, 2), ext[0, 0], k[0, 0])

    def segments(*args):
        return epipolar_lines.project_rays(*args, ext[0, 1].to(args[0].device), k[0, 1].to(args[0].device))

    seg, seg_ref = segments(origins.to(dev), directions.to(dev)), segments(origins, directions)
    overlaps = seg_ref.overlaps_image
    flips = int((seg.overlaps_image.cpu() != overlaps).sum())
    if flips or not 0 < int(overlaps.sum()) < overlaps.numel():
        raise AssertionError(f"project_rays: overlaps_image differs from the CPU's on {flips} rays, "
                             f"{int(overlaps.sum())} of {overlaps.numel()} overlap")
    seg_err = 0.0
    for name in ("t_min", "t_max", "xy_min", "xy_max"):
        a, b = getattr(seg, name).cpu()[overlaps], getattr(seg_ref, name)[overlaps]
        diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs() / b.abs().clamp(min=1.0))
        seg_err = max(seg_err, float(diff.max()))
    if seg_err > GEOMETRY_TOL:
        raise AssertionError(f"project_rays: segments differ from the CPU's by {seg_err}")
    seg_ms = cuda_ms(lambda: segments(origins.to(dev), directions.to(dev)), reps)
    xy = 0.5 * (seg_ref.xy_min + seg_ref.xy_max)[overlaps]
    lift_args = (origins[overlaps], directions[overlaps], xy, ext[0, 1], k[0, 1])
    cond = geometry_condition(directions[overlaps], xy, ext[0, 1], k[0, 1])
    lift_err = 0.0
    for fn in (epipolar_lines.lift_to_3d, epipolar_lines.get_depth):
        a, b = fn(*(x.to(dev) for x in lift_args)).cpu(), fn(*lift_args)
        err = ((a - b).abs().reshape(len(cond), -1).amax(1) / b.abs().reshape(len(cond), -1).amax(1).clamp(min=1.0))
        if not bool((err.double().numpy() <= GEOMETRY_TOL * cond).all()):
            raise AssertionError(f"{fn.__name__}: differs from the CPU's beyond {GEOMETRY_TOL} x the condition number")
        lift_err = max(lift_err, float((err.double().numpy() / cond).max()))
    res["geometry"] = dict(embedding_ms=emb_ms, embedding_err=emb_err, project_rays_ms=seg_ms, segment_err=seg_err,
                           rays=overlaps.numel(), overlapping=int(overlaps.sum()), lift_err_over_cond=lift_err,
                           max_cond=float(cond.max()))
    log(f"secondary: get_intrinsic_embedding, degree 4, 2 views at {hw}x{hw}: within {emb_err:.3g} of the CPU's, "
        f"{emb_ms:.3f} ms; project_rays of {overlaps.numel()} rays of view 0 into view 1: overlaps_image equal on every "
        f"ray ({int(overlaps.sum())} overlap), segments within {seg_err:.3g}, {seg_ms:.3f} ms; lift_to_3d and "
        f"get_depth within {lift_err:.3g} x each point's condition number (up to {float(cond.max()):.3g}) [{card}]")

    # -- (d) the AdaAttN + depth-smoothness render route ----------------------------
    gaussians = recovery_cloud(dev, g)
    leaves = [x.detach().requires_grad_() if x is not None else None for x in gaussians]
    cloud = type(gaussians)(*leaves)
    ext_d, k_d = ext.to(dev), k.to(dev)
    near, far = torch.full((1, 2), 0.1, device=dev), torch.full((1, 2), 100.0, device=dev)
    render_kwargs = dict(max_per_tile=2048, max_tiles_per_gaussian=8)
    vgg19 = VGG19Features().to(dev)
    init_like_flax_(vgg19, torch.Generator(dev).manual_seed(3))
    vgg19.requires_grad_(False)
    target = tensor(rng.uniform(0, 1, (1, 2, hw, hw, 3))).to(dev)
    style_d = tensor(rng.uniform(0, 1, (1, hw, hw, 3))).to(dev)

    def route_loss(color, depth):  # (1, 2, h, w, 3), (1, 2, h, w)
        style_term, _ = adaattn_loss(vgg19, color, target, style_d, norm="adaattn")
        return style_term + depth_smoothness_loss(depth, image=color)

    def step():
        out = render_gaussians(cloud, ext_d, k_d, near, far, (hw, hw), **render_kwargs)
        loss = route_loss(out.color, out.depth)
        return loss, torch.autograd.grad(loss, [x for x in leaves if x is not None]), out

    steps = 3
    trace.reset()
    with torch.enable_grad():
        loss, grads, out = step()
        route_ms = cuda_ms(lambda: step(), steps - 1)
    launches = launch_record()
    if (launches["composite_fwd"], launches["composite_bwd"]) != (steps, 2 * steps):
        raise AssertionError(f"adaattn + depth route: launches {launches}, expected {steps} calls of each")
    if not math.isfinite(float(loss.detach())) or not all(bool(torch.isfinite(x).all()) and bool((x != 0).any()) for x in grads):
        raise AssertionError("adaattn + depth route: non-finite loss or a zero or non-finite gradient")
    live = int(out.live_pairs.max())
    with torch.no_grad():
        inputs = main_path_inputs(gaussians, ext_d, k_d, near, far, (hw, hw), render_kwargs)
        fwd = check_composite(inputs, 2048)
        cot = render_cotangents(inputs, 2048, lambda color, depth: route_loss(color[None], depth[None]))
        if not bool((cot[1] != 0).any()):
            raise AssertionError("adaattn + depth route: the loss's depth cotangent is 0")
        bwd = check_composite_bwd(inputs, 2048, *cot)
    if not bwd["nonzero_by_column"][composite.A_D]:
        raise AssertionError("adaattn + depth route: the backward's depth column is 0")
    res["route"] = dict(ms_per_step=route_ms, loss=float(loss.detach()), live_pairs=live, launches=launches,
                        depth_cotangent_nonzero=int((cot[1] != 0).sum()),
                        depth_grad_nonzero=bwd["nonzero_by_column"][composite.A_D])
    log(f"secondary: render route, {g} Gaussians on 2 views at {hw}x{hw} ({live} live pairs), AdaAttN loss "
        f"(norm adaattn, random VGG19) + depth smoothness of the rendered depth weighted by the rendered image, "
        f"backpropagated to the Gaussians: {route_ms:.2f} ms a step (median of {steps - 1}), loss {res['route']['loss']:.5f}; "
        f"launches fwd {launches['composite_fwd']} bwd {launches['composite_bwd']} [{card}]")
    log(f"kernel composite_fwd, the adaattn + depth route's inputs: agrees with the plain version, max err "
        f"{fwd['max_abs_err']:.3g}; {fwd_windows_line(fwd)}")
    log(f"kernel composite_bwd, the adaattn + depth route's inputs and cotangents ({res['route']['depth_cotangent_nonzero']} "
        f"non-zero depth cotangents): agrees with the plain version, max err {bwd['max_abs_err']:.3g} "
        f"({bwd['max_rel_err']:.3g} of its column's largest gradient), {bwd['nonzero_by_column'][composite.A_D]} non-zero "
        f"depth gradients, {bwd['pairs_with_grad']} pairs with a gradient of {bwd['walked']} walked; "
        f"{windows_line(bwd)}")
    del cloud, leaves, grads, out, inputs, vgg19, gaussians
    gc.collect()
    torch.cuda.empty_cache()
    return dict(res, fwd=fwd, bwd=bwd)


# The posed adapter on the card against the same call on the CPU, each
# output over its largest magnitude: f32 elementwise math and a 2x2 inverse,
# rounded otherwise by the card's exp and rsqrt (tests/test_torch_cuda.py).
POSED_TOL = 1e-5
# The posed route's context cameras (c2w): view 0 at the target's camera,
# view 1 one baseline of 0.1 along x from it.
POSED_BASELINE = 0.1


def adapt_inputs(model, batch):
    """The raw (b, v, h, w, 1 + channels) Gaussian channels and (b, v, h,
    w, 3) points that models/encoder.py::_adapt receives in one predict of
    `model` on `batch`, as f32 tensors outside any graph."""
    import torch

    from styl3r_tpu_torch.models import encoder as encoder_mod

    seen = []
    adapt = encoder_mod._adapt

    def record(raw, pts, *args, **kwargs):
        seen.append((raw.detach().float().clone(), pts.detach().float().clone()))
        return adapt(raw, pts, *args, **kwargs)

    encoder_mod._adapt = record
    try:
        with torch.no_grad():
            model.predict_gaussians(batch)
    finally:
        encoder_mod._adapt = adapt
    if len(seen) != 1:
        raise AssertionError(f"posed route: _adapt was called {len(seen)} times in one predict")
    return seen[0]


def posed_phase(model, card, hw, render_kwargs, seed=0, reps=5, warm=2):
    """The posed adapter's route at full width: the serving model's raw
    Gaussian channels and densities for the example batch (2 context views
    + a style image at hw, 1 target, from `seed`), as models/encoder.py::
    _adapt receives them, go through posed_gaussian_adapter with each view's
    own context camera (POSED_BASELINE), the pixel-centre grid and depths
    that are each pixel's pts3d norm, its distance along its own unit ray:
    one Gaussian a pixel. The target view is rendered with `render_kwargs`
    and the MSE against the target image backpropagated to the raw channels
    and the depths; each step launches each compositor kernel once (`warm`
    warm-up and `reps` timed steps, median, CUDA events). Both kernels are
    held against their plain versions on the route's inputs and MSE
    cotangents, and the adapter on the card against the same call on the
    CPU (POSED_TOL)."""
    import torch

    from styl3r_tpu_torch.geometry.gaussians import Gaussians
    from styl3r_tpu_torch.geometry.projection import sample_image_grid
    from styl3r_tpu_torch.models.adapter import map_pdf_to_opacity, posed_gaussian_adapter
    from styl3r_tpu_torch.models.decoder import render_gaussians
    from styl3r_tpu_torch.ops.rasterizer import composite

    dev = next(model.parameters()).device
    enc = model.encoder
    batch = example_batch(seed, dev, hw=hw[0], targets=True)
    raw, pts = adapt_inputs(model, batch)
    b, v, h, w, c = raw.shape
    n = h * w
    ext = torch.eye(4, device=dev).repeat(b, v, 1, 1)
    ext[:, :, 0, 3] = POSED_BASELINE * torch.arange(v, device=dev)
    args = dict(
        extrinsics=ext[:, :, None], intrinsics=batch.context_intrinsics[:, :, None],
        coordinates=sample_image_grid((h, w))[0].reshape(1, 1, n, 2).to(dev),
        depths=torch.linalg.norm(pts, dim=-1).reshape(b, v, n), raw=raw.reshape(b, v, n, c),
    )
    for k in ("depths", "raw"):
        args[k].requires_grad_()

    def adapter(t):
        opacities = map_pdf_to_opacity(torch.sigmoid(t["raw"][..., 0]), 0, enc.opacity_initial, enc.opacity_final,
                                       enc.opacity_warm_up)
        g = posed_gaussian_adapter(t["extrinsics"], t["intrinsics"], t["coordinates"], t["depths"], opacities,
                                   t["raw"][..., 1:], (h, w), enc.sh_degree)
        return Gaussians(*(x.reshape(b, v * n, *x.shape[3:]) for x in g))

    def step():
        out = render_gaussians(adapter(args), batch.target_extrinsics, batch.target_intrinsics, batch.target_near,
                               batch.target_far, hw, **render_kwargs)
        loss = ((out.color - batch.target_images) ** 2).mean()
        return loss, torch.autograd.grad(loss, (args["raw"], args["depths"])), out

    trace.reset()
    with torch.enable_grad():
        for _ in range(warm):
            loss, grads, out = step()
        step_ms = cuda_ms(step, reps)
        adapter_ms = cuda_ms(lambda: adapter(args), reps)
    launches = launch_record()
    if (launches["composite_fwd"], launches["composite_bwd"]) != (warm + reps, 2 * (warm + reps)):
        raise AssertionError(f"posed route: launches {launches}, expected {warm + reps} calls of each")
    loss = float(loss.detach())
    if not math.isfinite(loss) or not all(bool(torch.isfinite(x).all()) and bool((x != 0).any()) for x in grads):
        raise AssertionError("posed route: non-finite loss or a zero or non-finite gradient")
    # The serving cap of 2 pair slots a Gaussian may truncate here (its
    # telemetry: lossless iff live <= slots); the kernels are held on the
    # capped inputs the route renders.
    live, slots = int(out.live_pairs.max()), int(out.pair_slots.min())
    if not live > 0:
        raise AssertionError(f"posed route: live pairs {live}")

    with torch.no_grad():
        gaussians = adapter(args)
        cpu = adapter({k: x.detach().cpu() for k, x in args.items()})
        held = {}
        for name in Gaussians._fields:
            a, ref = getattr(gaussians, name).cpu(), getattr(cpu, name)
            scale = float(ref.abs().max())
            held[name] = float((a - ref).abs().max()) / scale
            if not (bool(torch.isfinite(a).all()) and held[name] <= POSED_TOL):
                raise AssertionError(f"posed route: adapter output {name} on the card is {held[name]} of its largest "
                                     f"magnitude from the CPU's (bound {POSED_TOL})")
        inputs = main_path_inputs(gaussians, *batch[2:6], hw, render_kwargs)
        fwd = check_composite(inputs, render_kwargs["max_per_tile"])
        bwd = check_composite_bwd(inputs, render_kwargs["max_per_tile"],
                                  *mse_cotangents(inputs, render_kwargs["max_per_tile"], batch.target_images))
    res = dict(gaussians=b * v * n, live_pairs=live, pair_slots=slots, step_ms=step_ms, adapter_ms=adapter_ms,
               loss=loss, launches=launches, adapter_rel_err=max(held.values()))
    log(f"posed route: {b * v * n} Gaussians from the full-width model's raw channels and pts3d norms through "
        f"posed_gaussian_adapter (2 context cameras {POSED_BASELINE} apart), the target at {hw[0]}x{hw[1]} "
        f"({live} live pairs, {slots} pair slots), MSE backpropagated to the raw channels and depths: {step_ms:.3f} ms a "
        f"step (median of {reps} after {warm} warm-up steps, CUDA events), the adapter {adapter_ms:.3f} ms; launches "
        f"fwd {launches['composite_fwd']} bwd {launches['composite_bwd']}; gradients finite [{card}]")
    log(f"posed route: the adapter on the card within {res['adapter_rel_err']:.3g} of each output's largest magnitude "
        f"of the CPU's (bound {POSED_TOL}; " + ", ".join(f"{k} {e:.3g}" for k, e in held.items()) + ")")
    log(f"kernel composite_fwd, the posed route's inputs: agrees with the plain version, max err "
        f"{fwd['max_abs_err']:.3g}; {fwd_windows_line(fwd)}")
    log(f"kernel composite_bwd, the posed route's inputs and MSE cotangents: agrees with the plain version, max err "
        f"{bwd['max_abs_err']:.3g} ({bwd['max_rel_err']:.3g} of its column's largest gradient), "
        f"{bwd['pairs_with_grad']} pairs with a gradient of {bwd['walked']} walked; {windows_line(bwd)}")
    del args, grads, out, gaussians, cpu, inputs, raw, pts
    gc.collect()
    torch.cuda.empty_cache()
    return dict(res, fwd=fwd, bwd=bwd)


DIST_FIT_CONFIG = "configs/experiment/re10k_2view_nvs.yaml"
# A data-parallel step on the card against the same work in one process
# (bf16 compute, TF32 off), from the same weights on the same global batch.
# (b)'s 2 ranks against the mean of two 1-process steps on the halves (the
# same shapes, so only the card's nondeterministic convolution backward
# differs: the 1-process step's own rerun moves its gradients by ~0.3%,
# relative L2, on an H100 80GB HBM3 at 700 W), and (c)'s (1, 1) tensor-parallel step against the unsharded
# step: the loss and the gradient's norm within SAME_TOL of theirs, the
# gradients (after the all-reduce, before the clip) within DIST_GRAD_TOL. A
# step that missed the other rank's gradients, or summed them, would miss by
# about the whole gradient. (b) against the 1-process step on the whole
# batch: each rank's half goes through other cuBLAS/cuDNN shapes, so bf16's
# 8 mantissa bits round otherwise: the loss and the gradient's norm within
# DIST_LOSS_TOL and DIST_NORM_TOL, the gradients reported. The weights after
# the step are reported against the step's change beside the 1-process
# step's rerun, not bounded: AdamW's first update, lr * g / (|g| + eps),
# moves every weight by about lr whatever its gradient's size, so rounding
# flips the small gradients' updates.
SAME_TOL = 1e-3
DIST_GRAD_TOL = 0.02
DIST_LOSS_TOL = 1e-2
DIST_NORM_TOL = 5e-2
# (a): train.main at world size 1 over NCCL against the same fit without a
# process group. Steps 1-2 are well conditioned: both are taken at the
# initial weights (the config's warm-up gives step 1 learning rate 0), so
# their losses within RESUME_TOL of the reference's; the step-2 checkpoint's
# weights within DIST_CKPT_TOL of the reference's change over those steps,
# and its Adam moments within DIST_CKPT_TOL (relative L2; measured
# 0.0031-0.0143 apart on an H100 80GB HBM3 at 700 W: the card's
# nondeterministic backward through the random-weight render; an update
# that scaled the gradient by a wrong world size, or dropped it, misses by
# 0.5 or more).
# From step 3 on, this fit jumps between runs of the same fit, its loss by
# up to ~1e-3 and its weights by most of a step's change (the renderer's
# 1/255 alpha cutoff and tile culling are discrete;
# scripts/fit_repeatability.py measures two runs apart), so steps 3-4 are
# reported, not bounded.
DIST_CKPT_TOL = 5e-2


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(role, world, args, tmp, timeout=900):
    """`world` processes of `chip_smoke.py --distributed-child role`, each
    with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK 0: one card,
    MASTER_ADDR and a free MASTER_PORT), started together; their logs go to
    this process's output. Returns each rank's result; fails if a rank exits
    non-zero (the others are then stopped)."""
    port = free_port()
    outs, procs = [], []
    try:
        for rank in range(world):
            out = os.path.join(tmp, f"{role}_rank{rank}.json")
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--distributed-child", role,
                 json.dumps(dict(args, out=out))], env=env))
            outs.append(out)
        deadline = time.monotonic() + timeout
        codes = []
        for proc in procs:
            codes.append(proc.wait(timeout=max(1.0, deadline - time.monotonic())))
            if codes[-1] != 0:
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if codes != [0] * world:
        raise AssertionError(f"distributed {role}: ranks exited {[p.returncode for p in procs]}")
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def dist_fit_args(root, out, batch_size, max_steps, *extra):
    return ["--config", os.path.join(ROOT, DIST_FIT_CONFIG), "--max-steps", str(max_steps),
            f"datasets.0.roots=[{root}]", f"datasets.0.style_root={os.path.join(root, 'styles')}",
            f"train.batch_size={batch_size}", "train.log_every_n_steps=1", "train.val_every_n_steps=100",
            "checkpointing.every_n_train_steps=100", f"checkpointing.output_dir={out}", *extra]


def host_state(model):
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def stage_step(model, stage, batch, hw, render_kwargs, data=None):
    """One train step of `stage` (1: MSE; 2: style 10 + identity with VGG19 at
    random weights, stylizer-only; train_phase's) from the model's weights,
    the first update at the optimizer's full learning rate (no warm-up), with
    step 0's dropout generator; with `data`, on the rank's rows. Returns the
    metrics as floats, the step's milliseconds (CUDA events) and its
    gradients before the clip (after the all-reduce), on the host."""
    import torch

    from styl3r_tpu_torch.losses.vgg import VGG19Features
    from styl3r_tpu_torch.train.losses import LossBundle
    from styl3r_tpu_torch.train.step import TrainState, make_optimizer, make_stage2_optimizer, make_train_step
    from styl3r_tpu_torch.train.trainer import step_generator
    from styl3r_tpu_torch.utils.convert import init_like_flax_

    dev = batch.context_images.device
    if stage == 1:
        optimizer = make_optimizer(model, warmup_steps=0)
        step = make_train_step(model, optimizer, hw, stylized=False, data=data, **render_kwargs)
    else:
        vgg = VGG19Features().to(dev)
        init_like_flax_(vgg, torch.Generator(dev).manual_seed(3))
        loss_fn = LossBundle(mse_weight=None, style_weight=10.0, identity=True, vgg19=vgg.requires_grad_(False))
        optimizer = make_stage2_optimizer(model, warmup_steps=0)
        step = make_train_step(model, optimizer, hw, loss_fn=loss_fn, stylized=True, identity_branch=True,
                               data=data, **render_kwargs)
    model.zero_grad(set_to_none=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = step(TrainState(), batch, step_generator(1, 0, dev))
    end.record()
    torch.cuda.synchronize()
    metrics = {k: float(v) for k, v in metrics.items()}
    if not (math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"]) and metrics["grad_norm"] > 0):
        raise AssertionError(f"stage {stage} step: loss {metrics['loss']}, grad norm {metrics['grad_norm']}")
    unclip = max(1.0, metrics["grad_norm"] / optimizer.grad_clip)  # the clip scaled them in place
    # A tensor-parallel gradient whole (at a (1, 1) mesh no row is permuted).
    grads = {n: (getattr(p.grad, "full_tensor", p.grad.detach)().detach() * unclip).to("cpu")
             for n, p in model.named_parameters() if p.grad is not None}
    del optimizer, step
    model.zero_grad(set_to_none=True)
    gc.collect()  # the optimizer's moments, before the next step's
    torch.cuda.empty_cache()
    return metrics, start.elapsed_time(end), grads


def tensors_norm(a):
    """The Euclidean norm of a dict of tensors (taken on the card, in f64)."""
    return math.sqrt(sum(float(x.cuda().double().square().sum()) for x in a.values() if x.is_floating_point()))


def step_shares(a, b, start=None):
    """How far step a's (metrics, gradients[, weights after]) are from step
    b's: the loss's and the gradient norm's shares of b's, the gradients'
    relative L2 distance, and with `start` (the weights both steps started
    from) the weights' distance as a share of b's change."""
    apart, norm = distance_and_norm(a[1], b[1])
    out = dict(loss=abs(a[0]["loss"] - b[0]["loss"]) / abs(b[0]["loss"]),
               grad_norm=abs(a[0]["grad_norm"] - b[0]["grad_norm"]) / b[0]["grad_norm"], grads=apart / norm)
    if start is not None:
        apart, out["moved"] = distance_and_norm(a[2], b[2], start)
        out["params"] = apart / out["moved"]
    return out


def distance_and_norm(a, b, base=None):
    """|a - b| and |b - base| (|b| without a base) of dicts of host tensors,
    in one pass over them on the card, in f64."""
    apart = norm = 0.0
    for k, x in b.items():
        if x.is_floating_point():
            y = x.cuda().double()
            apart += float((a[k].cuda().double() - y).square().sum())
            norm += float((y if base is None else y - base[k].cuda().double()).square().sum())
    return math.sqrt(apart), math.sqrt(norm)


def bounded(what, shares, loss_tol, norm_tol, grad_tol=None):
    """`shares` (step_shares), failing unless within the bounds."""
    if not (shares["loss"] <= loss_tol and shares["grad_norm"] <= norm_tol
            and (grad_tol is None or shares["grads"] <= grad_tol)):
        raise AssertionError(f"{what}: {shares} (bounds: loss {loss_tol}, grad norm {norm_tol}, gradients {grad_tol})")
    return shares


def shares_text(a, bounds=None):
    loss, norm, grads = bounds or (None, None, None)
    text = (f"loss {a['loss']:.3g}{f' (bound {loss})' if loss else ''}, grad norm {a['grad_norm']:.3g}"
            f"{f' (bound {norm})' if norm else ''}, gradients {a['grads']:.3g}{f' (bound {grads})' if grads else ''}")
    if "params" in a:
        text += f", weights {a['params']:.3g} of the step's change {a['moved']:.4g}"
    return text


def reference_steps(model, stage, batch, hw, scratch, rerun=True, halves=False):
    """The 1-process step from `scratch` on the whole batch: (metrics,
    gradients, weights after) and its ms; with `rerun` also the same step's
    rerun (the card's run-to-run noise); with `halves` also the mean of two
    1-process steps on the batch's halves, as 2 ranks split it (dropout as
    rank r draws it): (its loss and gradient norm, gradients)."""
    from styl3r_tpu_torch.models.dpt import shard_dropout_
    from styl3r_tpu_torch.parallel import shard_batch

    runs = []
    for _ in range(2 if rerun else 1):
        model.load_state_dict(scratch)
        shard_dropout_(model, 0, 1)
        metrics, ms, grads = stage_step(model, stage, batch, hw, TRAIN_RENDER)
        runs.append(((metrics, grads, host_state(model)), ms))
    out = (runs[0][0], runs[0][1]) + ((runs[1][0],) if rerun else ())
    if not halves:
        return out
    losses, mean = [], None
    for r in range(2):
        model.load_state_dict(scratch)
        shard_dropout_(model, r, 2)
        metrics, _, grads = stage_step(model, stage, shard_batch(batch, r, 2), hw, TRAIN_RENDER)
        losses.append(metrics["loss"])
        mean = grads if mean is None else {k: (v + grads[k]) / 2 for k, v in mean.items()}
    return out + (({"loss": sum(losses) / 2, "grad_norm": tensors_norm(mean)}, mean),)


def full_width_training_model(dev, f32_heads=False):
    """The training phases' model: full width, f32 weights, bf16 compute in
    the backbone and, without `f32_heads`, in the heads' trunks (with it the
    heads compute in float32, as the Trainer builds them),
    scratch_init_heads."""
    import torch

    from styl3r_tpu_torch.models.styl3r import Styl3rModel
    from styl3r_tpu_torch.train.scratch_init import scratch_init_heads

    model = Styl3rModel(sh_degree=0, backbone_dtype=torch.bfloat16,
                        head_trunk_dtype=None if f32_heads else torch.bfloat16, device=dev, seed=0)
    scratch_init_heads(model)
    return model


TRAIN_RENDER = dict(max_tiles_per_gaussian=8, max_per_tile=2048, pair_cap_per_gaussian=4)


def nccl_fit_child(args):
    """(a) train.main under torchrun's environment at world size 1 (NCCL):
    `steps` // 2 steps with the final checkpoint, then a resume from it to
    `steps`."""
    import torch

    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.train import main as train_main

    out, steps = args["out_dir"], args["steps"]
    ckpt = os.path.join(out, "checkpoints", "final.pt")
    start = os.path.join(out, "start.pt")
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    for port, max_steps, extra in ((args["ports"][0], steps // 2, ()),
                                   (args["ports"][1], steps, (f"checkpointing.load={start}",
                                                              "checkpointing.resume=true"))):
        os.environ["MASTER_PORT"] = str(port)
        state = train_main.main(dist_fit_args(args["root"], out, args["batch_size"], max_steps, *extra))
        if state.step != max_steps:
            raise AssertionError(f"nccl fit: {state.step} steps of {max_steps}")
        if max_steps < steps:
            os.replace(ckpt, start)
    torch.cuda.synchronize()
    rec = fit_metrics(out)["train"]
    if [r["step"] for r in rec] != list(range(1, steps + 1)):
        raise AssertionError(f"nccl fit: logged steps {[r['step'] for r in rec]}")
    return dict(start=start, final=ckpt, launches=launch_record(),
                step_ms=[r["step_ms"] for r in rec], allreduce_ms=[r["allreduce_ms"] for r in rec],
                allreduce_bytes=[r["allreduce_bytes"] for r in rec], losses=[r["loss"] for r in rec],
                live_pairs=[r["live_pairs"] for r in rec], peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def gloo_step_child(args):
    """(b) One rank of 2 over gloo on the shared card: a stage-1 and a
    stage-2 step of the full-width model on its row of a global batch of 2;
    rank 0 then runs the same step on the whole batch from the same weights,
    alone, twice, and on each half, and compares, and holds both kernels
    against their plain versions on its own render's inputs and
    cotangents."""
    import torch
    import torch.distributed as dist

    from styl3r_tpu_torch.models.dpt import shard_dropout_
    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.parallel import DataGroup, shard_batch

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", rank=rank, world_size=world)
    try:
        hw = (256, 256)
        model = full_width_training_model(dev)
        scratch = host_state(model)
        batch = example_batch(4, dev, b=2, targets=True)
        rows = shard_batch(batch, rank, world)
        result, probe = {}, FitProbe()
        for stage in (1, 2):
            model.load_state_dict(scratch)
            shard_dropout_(model, rank, world)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            trace.reset()
            with probe.attached() if stage == 1 else contextlib.nullcontext(), trace.enabled():
                metrics, ms, grads = stage_step(model, stage, rows, hw, TRAIN_RENDER, DataGroup(rank, world))
            allreduce_ms = trace.drain()["allreduce"][0]
            res = dict(metrics=metrics, ms=ms, allreduce_ms=allreduce_ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       launches=launch_record())
            # Every rank holds the same weights: the sums of each tensor, gathered.
            sums = torch.stack([p.detach().double().sum() for p in model.parameters()]).cpu()
            every = [torch.zeros_like(sums) for _ in range(world)]
            dist.all_gather(every, sums)
            res["ranks_equal"] = all(torch.equal(every[0], x) for x in every)
            if rank == 0:
                got = (metrics, grads, host_state(model))
                want, res["reference_ms"], rerun, halves = reference_steps(model, stage, batch, hw, scratch,
                                                                           halves=True)
                res["reference"] = want[0]
                res["agreement"] = dict(
                    halves=bounded(f"gloo stage {stage} against the halves' 1-process steps",
                                   step_shares(got, halves), SAME_TOL, SAME_TOL, DIST_GRAD_TOL),
                    whole=bounded(f"gloo stage {stage} against the whole batch's 1-process step",
                                  step_shares(got, want, scratch), DIST_LOSS_TOL, DIST_NORM_TOL),
                    halves_whole=step_shares(halves, want), rerun=step_shares(rerun, want, scratch))
                del got, want, rerun, halves
            del grads
            dist.barrier()
            result[f"stage{stage}"] = res
        if rank == 0:
            bwd_args, bwd_max = probe.bwd
            inputs, max_per_tile = compositor_inputs(probe.train_fwd[0])
            with torch.no_grad():
                fwd_res = composite_device_ms(check_composite(inputs, max_per_tile))
                bwd_res = composite_bwd_device_ms(check_composite_bwd(inputs, bwd_max, *bwd_args[5:8]))
            result.update(fwd={k: v for k, v in fwd_res.items() if k != "args"},
                          bwd={k: v for k, v in bwd_res.items() if k != "args"},
                          live_pairs=int(inputs.counts.long().sum()), n_views=inputs.n_views)
        dist.barrier()
        return result
    finally:
        dist.destroy_process_group()


def tp_step_child(args):
    """(c) Tensor parallelism on a (1, 1) mesh over NCCL: the stage-1 step of
    the full-width model sharded by shard_params_tp against the unsharded
    step from the same weights on the same global batch of 2."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.parallel import (
        batch_sharding_2d,
        data_group_2d,
        gathered_state_dict,
        init_distributed,
        make_mesh_2d,
        shard_params_tp,
    )

    _, _, dev = init_distributed("cuda")
    try:
        hw = (256, 256)
        mesh = make_mesh_2d(1, 1, "cuda")
        model = full_width_training_model(dev)
        scratch = host_state(model)
        batch = example_batch(4, dev, b=2, targets=True)
        want, ref_ms = reference_steps(model, 1, batch, hw, scratch, rerun=False)
        model.load_state_dict(scratch)
        shard_params_tp(model, mesh)
        sharded = sum(isinstance(p, DTensor) for p in model.parameters())
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trace.reset()
        metrics, ms, grads = stage_step(model, 1, batch_sharding_2d(batch, mesh), hw, TRAIN_RENDER, data_group_2d(mesh))
        launches = launch_record()
        peak = torch.cuda.max_memory_allocated() / 2**30
        after = {k: v.detach().to("cpu", copy=True) for k, v in gathered_state_dict(model).items()}
        agreement = dict(unsharded=bounded("tp (1, 1) against the unsharded step",
                                           step_shares((metrics, grads, after), want, scratch),
                                           SAME_TOL, SAME_TOL, DIST_GRAD_TOL))
        return dict(metrics=metrics, ms=ms, reference=want[0], reference_ms=ref_ms, launches=launches,
                    peak_gib=peak, agreement=agreement, dtensor_params=sharded,
                    params=sum(1 for _ in model.parameters()))
    finally:
        dist.destroy_process_group()


DISTRIBUTED_CHILDREN = {"nccl_fit": nccl_fit_child, "gloo_step": gloo_step_child, "tp_step": tp_step_child}


def distributed_child(argv):
    """A child process of the distributed phase: `--distributed-child ROLE
    JSON`; writes its result to the JSON's "out"."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    role, args = argv[0], json.loads(argv[1])
    result = DISTRIBUTED_CHILDREN[role](args)
    with open(args["out"], "w") as f:
        json.dump(result, f)
    return 0


def distributed_phase(card, batch_size=2, steps=4):
    """Multi-GPU training on one card, each part in child processes with
    torchrun's environment (this process never starts a process group, so
    data_shard() shards none of the other phases' datasets): (a) train.main
    on re10k_2view_nvs.yaml (stage 1, full width, the config's caps) at world
    size 1 over NCCL, `steps` // 2 steps and a resume from their checkpoint
    to `steps`, against the same fit run here without a group (the step-2
    checkpoint and the losses bounded, step 4 reported: DIST_CKPT_TOL);
    (b) 2 ranks over gloo sharing the card, a stage-1 and a stage-2 step on a
    global batch of 2 (1 a rank) against rank 0's 1-process step on the whole
    batch and the mean of the halves' (SAME_TOL), both kernels held on rank 0's
    render; (c) tensor
    parallelism on a (1, 1) mesh over NCCL, one stage-1 step against the
    unsharded one."""
    import shutil
    import tempfile

    import torch

    from styl3r_tpu_torch.models.styl3r import Styl3rModel
    from styl3r_tpu_torch.train import main as train_main
    from styl3r_tpu_torch.utils.config import load_config

    n_params = 1_043_732_697
    need = 3 * 12 * n_params + 2**30
    with tempfile.TemporaryDirectory(prefix="styl3r_dist_") as tmp:
        free = shutil.disk_usage(tmp).free
        if free < need:
            raise AssertionError(f"distributed: {free / 2**30:.1f} GiB free under {tmp}, the checkpoints need "
                                 f"{need / 2**30:.1f} GiB")
        root = os.path.join(tmp, "re10k")
        fit_chunks(root)

        # -- (a) world size 1 over NCCL, against the same fit without a group --
        t0 = time.perf_counter()
        ref_out = os.path.join(tmp, "reference")
        train_main.main(dist_fit_args(root, ref_out, batch_size, steps, f"checkpointing.every_n_train_steps={steps // 2}",
                                      "checkpointing.save_top_k=-1"))
        ref_dir = os.path.join(ref_out, "checkpoints")
        ref_rec = fit_metrics(ref_out)["train"]
        # On the host, so that the disk holds no more than the child's files.
        ref_ckpt = {"weights": checkpoint_weights(os.path.join(ref_dir, f"step_{steps // 2}.pt")),
                    "moments": checkpoint_moments(os.path.join(ref_dir, f"step_{steps // 2}.pt"))}
        ref_weights = checkpoint_weights(os.path.join(ref_dir, "final.pt"))
        shutil.rmtree(ref_out)
        # The initial weights, which the trainer draws from the config's seed.
        cfg = load_config(os.path.join(ROOT, DIST_FIT_CONFIG), [])
        init = host_state(Styl3rModel(sh_degree=cfg.model.encoder.sh_degree, device="cuda", seed=cfg.seed))
        ref_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fit, = run_ranks("nccl_fit", 1, dict(root=root, out_dir=os.path.join(tmp, "nccl"), steps=steps,
                                            batch_size=batch_size, ports=[free_port(), free_port()]), tmp)
        nccl_s = time.perf_counter() - t0
        # The resume's start, the step-`steps // 2` checkpoint: weights and Adam
        # moments against the reference's.
        apart, moved = distance_and_norm(checkpoint_weights(fit["start"]), ref_ckpt["weights"], init)
        ckpt = {"weights": apart / moved}
        apart, norm = distance_and_norm(checkpoint_moments(fit["start"]), ref_ckpt["moments"])
        ckpt["moments"] = apart / norm
        del init
        start, resumed = checkpoint_weights(fit["start"]), checkpoint_weights(fit["final"])
        apart, moved_late = distance_and_norm(resumed, ref_weights, start)
        fit["param_err"] = apart / moved_late
        del start, resumed, ref_weights, ref_ckpt
        shutil.rmtree(os.path.join(tmp, "nccl"))
        fit["checkpoint_err"] = ckpt
        fit["loss_rel_err"] = [abs(a - b["loss"]) / abs(b["loss"]) for a, b in zip(fit["losses"], ref_rec)]
        fit["reference_step_ms"] = [r["step_ms"] for r in ref_rec]
        if not (max(ckpt.values()) <= DIST_CKPT_TOL and max(fit["loss_rel_err"][:steps // 2]) <= RESUME_TOL):
            raise AssertionError(f"distributed nccl fit: the step-{steps // 2} checkpoint {ckpt} from the "
                                 f"non-distributed fit's (bound {DIST_CKPT_TOL}), losses {fit['loss_rel_err']} from "
                                 f"its (bound {RESUME_TOL} to step {steps // 2})")
        if compositor_launches(fit["launches"]) != (steps, 2 * steps) or not fit["launches"]["rope2d"]:
            raise AssertionError(f"distributed nccl fit: launches {fit['launches']}, expected {steps} calls of each")
        log(f"distributed nccl fit: train.main on re10k_2view_nvs.yaml under torchrun's environment at world size 1 "
            f"(NCCL), b = {batch_size}, {steps // 2} steps and a resume to step {steps} in {nccl_s:.1f} s (the "
            f"non-distributed fit {ref_s:.1f} s): {statistics.median(fit['step_ms'][1:]):.2f} ms/step (median of "
            f"steps 2-{steps}; the first {fit['step_ms'][0]:.2f}; without a group "
            f"{statistics.median(fit['reference_step_ms'][1:]):.2f}), gradient all-reduce "
            f"{statistics.median(fit['allreduce_ms']):.2f} ms for {int(fit['allreduce_bytes'][0])} bytes (median); "
            f"peak {fit['peak_gib']:.2f} GiB; the step-{steps // 2} checkpoint's weights {ckpt['weights']:.3g} of the "
            f"change over steps 1-{steps // 2} ({moved:.4g}) and its Adam moments {ckpt['moments']:.3g} (relative L2) "
            f"from the non-distributed fit's (bound {DIST_CKPT_TOL}); losses of steps 1-{steps} "
            f"{', '.join(f'{e:.3g}' for e in fit['loss_rel_err'])} from its (bound {RESUME_TOL} to step "
            f"{steps // 2}); step-{steps} weights {fit['param_err']:.3g} of the change over steps "
            f"{steps // 2 + 1}-{steps} ({moved_late:.4g}) from its (not bounded); launches fwd "
            f"{fit['launches']['composite_fwd']} bwd {fit['launches']['composite_bwd']} [{card}]")

        # -- (b) 2 ranks over gloo on the card ------------------------------------
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gloo = run_ranks("gloo_step", 2, {}, tmp)
        gloo_s = time.perf_counter() - t0
        for stage in ("stage1", "stage2"):
            per_step = 1 if stage == "stage1" else 2
            for r, rank in enumerate(gloo):
                res = rank[stage]
                if not res["ranks_equal"]:
                    raise AssertionError(f"distributed gloo {stage}: the ranks' weights differ after the step")
                if compositor_launches(res["launches"]) != (per_step, 2 * per_step) or not res["launches"]["rope2d"]:
                    raise AssertionError(f"distributed gloo {stage} rank {r}: launches {res['launches']}")
            res, other = gloo[0][stage], gloo[1][stage]
            log(f"distributed gloo {stage}: 2 ranks sharing the card, b = 1 a rank of a global 2: "
                f"{res['ms']:.2f} / {other['ms']:.2f} ms a step (ranks 0 / 1, CUDA events), of it the gradient "
                f"all-reduce {res['allreduce_ms']:.2f} / {other['allreduce_ms']:.2f} ms for "
                f"{int(res['metrics']['allreduce_bytes'])} bytes; the 1-process step on b = 2 {res['reference_ms']:.2f} "
                f"ms; peak {res['peak_gib']:.2f} / {other['peak_gib']:.2f} GiB; the ranks' weights equal; launches fwd "
                f"{res['launches']['composite_fwd']} bwd {res['launches']['composite_bwd']} a rank [{card}]")
            a = res["agreement"]
            log(f"distributed gloo {stage}: against the mean of the halves' 1-process steps: "
                f"{shares_text(a['halves'], (SAME_TOL, SAME_TOL, DIST_GRAD_TOL))}; against the whole batch's "
                f"1-process step: {shares_text(a['whole'], (DIST_LOSS_TOL, DIST_NORM_TOL, None))}; the halves' mean "
                f"against the whole batch's: {shares_text(a['halves_whole'])}; the whole batch's step against its "
                f"rerun: {shares_text(a['rerun'])}")
        fwd_res, bwd_res = gloo[0]["fwd"], gloo[0]["bwd"]
        log(f"kernel composite_fwd, rank 0's render of the 2-rank stage-1 step ({gloo[0]['n_views']} view, "
            f"{gloo[0]['live_pairs']} pairs in range): agrees with the plain version, max err "
            f"{fwd_res['max_abs_err']:.3g}; {fwd_windows_line(fwd_res)}")
        log(f"kernel composite_bwd, rank 0's render of the 2-rank stage-1 step and its MSE cotangents: agrees with "
            f"the plain version, max err {bwd_res['max_abs_err']:.3g} ({bwd_res['max_rel_err']:.3g} of its column's "
            f"largest gradient), {bwd_res['pairs_with_grad']} pairs with a gradient of {bwd_res['walked']} walked; "
            f"two calls bitwise equal")

        # -- (c) tensor parallelism on a (1, 1) mesh over NCCL ---------------------
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tp, = run_ranks("tp_step", 1, {}, tmp)
        tp_s = time.perf_counter() - t0
        if compositor_launches(tp["launches"]) != (1, 2) or not tp["launches"]["rope2d"] or not tp["dtensor_params"]:
            raise AssertionError(f"distributed tp: launches {tp['launches']}, {tp['dtensor_params']} DTensor params")
        log(f"distributed tp: stage-1 step of the full-width model on a (1, 1) (data, model) mesh over NCCL, "
            f"{tp['dtensor_params']} of {tp['params']} parameters DTensors, b = 2: {tp['ms']:.2f} ms (unsharded "
            f"{tp['reference_ms']:.2f}); peak {tp['peak_gib']:.2f} GiB; against the unsharded step: "
            f"{shares_text(tp['agreement']['unsharded'], (SAME_TOL, SAME_TOL, DIST_GRAD_TOL))} (the same step's rerun "
            f"in (b): {shares_text(gloo[0]['stage1']['agreement']['rerun'])}); launches fwd 1 bwd 1 [{card}]")
        log(f"distributed: (a) {nccl_s:.1f} s, (b) {gloo_s:.1f} s, (c) {tp_s:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(nccl_fit=fit, gloo=[{k: v for k, v in r.items() if k not in ("fwd", "bwd")} for r in gloo], tp=tp,
                seconds=dict(nccl_fit=nccl_s, reference_fit=ref_s, gloo=gloo_s, tp=tp_s),
                fwd=fwd_res, bwd=bwd_res)


BENCH_REL_TOL = 1e-4  # the 128^2 step through the plain compositor against the kernels


def bench_phase(card, dev):
    """The measurement entry points through their main(), at full width:
    bench/serve.py at its defaults and bench/stages.py at 10 iterations on
    one serving model, then bench/train_step.py's default cases on a
    training model, each launch counted; then both kernels held against
    their plain versions on the 128^2 case's own inputs and MSE cotangents,
    and that case's step computing in f32 through each route. Each entry
    point prints its record on a line of its own."""
    import torch

    from styl3r_tpu_torch.bench import serve, stages, train_step
    from styl3r_tpu_torch.bench.common import route, serving_model
    from styl3r_tpu_torch.models.styl3r import Styl3rModel
    from styl3r_tpu_torch.ops.rasterizer import composite

    t0 = time.perf_counter()
    launches = {}

    def counted(path, run):
        trace.reset()
        out = run()
        launches[path] = launch_record()
        return out

    model = serving_model(dev, {})
    served = counted("bench_serve", lambda: serve.main([], model=model))
    staged = counted("bench_stages", lambda: stages.main(["--iters", "10"], model=model))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = train_step.training_model(dev, {})
    trained = counted("bench_train", lambda: train_step.main([], model=model))

    if not (served["value"] > 0 and 0 < served["live_pairs_max"] <= served["pair_slots"]
            and served["mfu"] > 0 and served["latency_ms"] > 0):
        raise AssertionError(f"bench serve: record {served}")
    for case in train_step.DEFAULT_CASES.split(","):
        if not trained.get(case, 0) > 0:
            raise AssertionError(f"bench train_step: no time for case {case}")
    a, b = trained["128:jnp:loss"], trained["128:pallas:loss"]
    if not abs(a - b) <= BENCH_REL_TOL * abs(a):
        raise AssertionError(f"bench train_step: 128:jnp loss {a} against 128:pallas {b}")
    missing = [name for name in stages.ABSENT if name in staged["per_scene_ms"]]
    if missing or any(not v > 0 for v in staged["per_scene_ms"].values()):
        raise AssertionError(f"bench stages: {staged['per_scene_ms']}")
    for path, kernels in (("bench_serve", ("composite_fwd",)), ("bench_stages", ("composite_fwd", "composite_bwd")),
                          ("bench_train", ("composite_fwd", "composite_bwd"))):
        for kernel in kernels:
            if not launches[path][kernel]:
                raise AssertionError(f"kernel {kernel} was not launched by {path}")

    # Both kernels on the 128:pallas case's own inputs and MSE cotangents.
    hw = (128, 128)
    batch = train_step.case_batch(train_step.parse_case("128:pallas"), hw, dev)
    with torch.no_grad():
        inputs = main_path_inputs(model.predict_gaussians(batch), *batch[2:6], hw, TRAIN_RENDER)
        fwd = check_composite(inputs, 2048)
        bwd = check_composite_bwd(inputs, 2048, *mse_cotangents(inputs, 2048, batch.target_images))
    # The 128^2 step's squared gradient norm through each route, computing
    # in f32: in bf16 the card's backward differs between two runs of one
    # route by up to 8e-4 of it (PERF.md §6), more than the kernels do.
    del model
    model = Styl3rModel(sh_degree=0, device=dev, seed=0)  # seed 0's weights, f32 compute
    step = train_step.gradient_step(model, batch, hw, train_step.loss_of("stage1", None), TRAIN_RENDER)
    f32_step = {}
    for impl in ("jnp", "pallas"):
        with route(impl):
            loss, sq_norm, _ = step(torch.zeros((), device=dev))
        f32_step[impl] = {"loss": float(loss), "grad_sq_norm": float(sq_norm)}
    for key in ("loss", "grad_sq_norm"):
        a, b = f32_step["jnp"][key], f32_step["pallas"][key]
        if not abs(a - b) <= BENCH_REL_TOL * abs(a):
            raise AssertionError(f"bench: the f32 128^2 step's {key}, plain {a} against kernels {b}")
    log(f"bench: the 128^2 stage-1 step computing in f32, plain compositor against kernels: loss "
        f"{f32_step['jnp']['loss']:.9g} / {f32_step['pallas']['loss']:.9g}, squared gradient norm "
        f"{f32_step['jnp']['grad_sq_norm']:.9g} / {f32_step['pallas']['grad_sq_norm']:.9g}; in bf16 (train_step) "
        f"{trained['128:jnp:grad_sq_norm']:.9g} / {trained['128:pallas:grad_sq_norm']:.9g}")
    log(f"kernel composite_fwd, the 128^2 train-step case's inputs ({int(inputs.live_pairs)} live pairs): agrees "
        f"with the plain version, max err {fwd['max_abs_err']:.3g}; {fwd_windows_line(fwd)}")
    log(f"kernel composite_bwd, the 128^2 train-step case's inputs and MSE cotangents: agrees with the plain "
        f"version, max err {bwd['max_abs_err']:.3g} ({bwd['max_rel_err']:.3g} of its column's largest gradient); "
        f"{windows_line(bwd)}")
    del model, inputs
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"bench: serve {served['value']} scenes/s back to back, latency {served['latency_ms']:.2f} ms; train "
        f"{', '.join(f'{c} {trained[c]} ms' for c in train_step.DEFAULT_CASES.split(','))}; stages' full forward "
        f"{staged['per_scene_ms']['full forward']:.2f} ms; launches {launches}; phase in {seconds:.1f} s [{card}]")
    return dict(serve=served, train_step=trained, stages_per_scene_ms=staged["per_scene_ms"], launches=launches,
                f32_step=f32_step, fwd=fwd, bwd=bwd, seconds=seconds)


def _texture(plane, a, b):
    """A plane's colour at in-plane coordinates (a, b): a checkerboard of
    its palette's colours, shaded by a low-frequency wave."""
    import numpy as np

    cells = np.floor(a / plane["cell"]).astype(np.int64) * 7 + np.floor(b / plane["cell"]).astype(np.int64) * 13
    shade = 0.75 + 0.25 * np.sin(3.0 * a) * np.cos(2.0 * b)
    return plane["palette"][cells % len(plane["palette"])] * shade[..., None]


def overfit_scene(directory, n_frames=48, size=256, n_points=4096, seed=0):
    """A COLMAP scene that holds together, in `directory`: a back wall, a
    floor and a slanted panel, each textured, ray-cast in numpy from
    n_frames pinhole cameras on an arc (w2c rotations about the y axis, all
    looking at the panel), saved as numbered size^2 PNGs with a text model
    (cameras.txt, images.txt) and points3D.bin: n_points sampled on the
    planes with their colours. Returns the directory."""
    import struct
    from pathlib import Path

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    directory = Path(directory)
    sparse = directory / "sparse" / "0"
    (directory / "images").mkdir(parents=True, exist_ok=True)
    sparse.mkdir(parents=True, exist_ok=True)
    slant = np.array([1.0, 0.0, -0.6]) / np.linalg.norm([1.0, 0.0, -0.6])
    planes = [dict(origin=np.array(o), u=np.array(u), v=np.array(v), half=half, cell=cell,
                   palette=rng.uniform(0.1, 0.95, (16, 3)))
              for o, u, v, half, cell in (([0.0, 0.0, 4.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], (4.0, 2.0), 0.5),
                                          ([0.0, 1.0, 2.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0], (4.0, 3.0), 0.4),
                                          ([0.3, 0.0, 2.2], slant, [0.0, 1.0, 0.0], (0.6, 0.6), 0.15))]
    f = 0.9 * size
    (sparse / "cameras.txt").write_text(f"1 PINHOLE {size} {size} {f!r} {f!r} {size / 2!r} {size / 2!r}\n")
    pix = np.arange(size) + 0.5
    d_cam = np.stack([*np.meshgrid((pix - size / 2) / f, (pix - size / 2) / f), np.ones((size, size))], -1)
    target = np.array([0.0, 0.0, 2.2])
    lines = []
    for i, theta in enumerate(np.linspace(-0.35, 0.35, n_frames)):
        rot = np.array([[np.cos(theta), 0.0, np.sin(theta)], [0.0, 1.0, 0.0], [-np.sin(theta), 0.0, np.cos(theta)]])
        center = target - 2.5 * rot[2]  # rot[2]: the camera's forward axis in the world
        dirs = d_cam @ rot
        depth = np.full((size, size), np.inf)
        # Sky where no plane is hit: a vertical gradient.
        image = np.broadcast_to(np.stack([0.55 + 0.2 * dirs[..., 1], 0.65 + 0.1 * dirs[..., 1],
                                          np.full((size, size), 0.9)], -1), (size, size, 3)).copy()
        for plane in planes:
            normal = np.cross(plane["u"], plane["v"])
            t = ((plane["origin"] - center) @ normal) / (dirs @ normal)
            rel = center + t[..., None] * dirs - plane["origin"]
            a, b = rel @ plane["u"], rel @ plane["v"]
            hit = (t > 1e-3) & (t < depth) & (np.abs(a) <= plane["half"][0]) & (np.abs(b) <= plane["half"][1])
            depth = np.where(hit, t, depth)
            image[hit] = _texture(plane, a[hit], b[hit])
        Image.fromarray((np.clip(image, 0, 1) * 255).round().astype(np.uint8)).save(
            directory / "images" / f"{i:04d}.png")
        q = (np.cos(theta / 2), 0.0, np.sin(theta / 2), 0.0)  # the rotation about y, COLMAP's (w, x, y, z)
        tvec = -rot @ center
        lines.append(f"{i + 1} {' '.join(map(repr, map(float, q)))} {' '.join(map(repr, tvec.tolist()))} 1 "
                     f"{i:04d}.png\n0.0 0.0 -1\n")
    (sparse / "images.txt").write_text("".join(lines))
    with open(sparse / "points3D.bin", "wb") as fh:
        per_plane = n_points // len(planes)
        fh.write(struct.pack("<Q", per_plane * len(planes)))
        for k, plane in enumerate(planes):
            ab = rng.uniform(-1, 1, (per_plane, 2)) * np.asarray(plane["half"])
            xyz = plane["origin"] + ab[:, :1] * plane["u"] + ab[:, 1:] * plane["v"]
            rgb = (np.clip(_texture(plane, ab[:, 0], ab[:, 1]), 0, 1) * 255).round().astype(np.uint8)
            for j in range(per_plane):
                fh.write(struct.pack("<Q3d3Bd", k * per_plane + j, *xyz[j], *rgb[j], 0.5) + struct.pack("<Q", 0))
    return directory


def overfit_phase(card, dev, frames=48, size=256, steps=20, eval_every=10, stage2_steps=4, model_name="full"):
    """The scene-overfit entry point, python -m
    styl3r_tpu_torch.train.overfit_colmap, through its main() on a synthetic
    COLMAP scene (overfit_scene): the model at `model_name` width in f32
    (the script's default) with pts3d_bound 20 and scratch_init_heads,
    `steps` stage-1 steps with a held-out evaluation every `eval_every`,
    then `stage2_steps` stage-2 steps, the script's other flags at their
    defaults (lr 2e-4 after 100 warm-up steps). Each step and evaluation is
    timed with CUDA events and its launches counted (a stage-1 step
    launches each kernel once, a stage-2 step twice, a held-out view the
    forward once).
    Then the scene's sparse anchor is built, and both kernels are held
    against their plain versions on the trained model's render of a
    training sample and its MSE cotangents."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.train import overfit_colmap as oc

    t0 = time.perf_counter()
    seen = {1: [], 2: [], "eval": []}
    make_train_step, eval_psnr = oc.make_train_step, oc.eval_psnr

    def timed(fn, on_done):
        def call(*args, **kwargs):
            fwd0, bwd0 = kernel_launches()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            on_done(out, args, dict(ms=start.elapsed_time(end), fwd=kernel_launches()[0] - fwd0,
                                    bwd=kernel_launches()[1] - bwd0))
            return out
        return call

    def timed_make_train_step(*args, **kwargs):
        stage = 2 if kwargs.get("identity_branch") else 1

        def done(metrics, _, rec):
            seen[stage].append(dict(rec, live=int(metrics["live_pairs"]), slots=int(metrics["pair_slots"]),
                                    loss=float(metrics["loss"])))
        return timed(make_train_step(*args, **kwargs), done)

    def eval_done(psnr, args, rec):
        seen["eval"].append(dict(rec, views=len(args[4]), psnr=psnr[0]))

    with tempfile.TemporaryDirectory(prefix="styl3r_overfit_") as tmp:
        t_scene = time.perf_counter()
        scene = overfit_scene(Path(tmp) / "scene", n_frames=frames, size=size)
        t_scene = time.perf_counter() - t_scene
        torch.cuda.synchronize()
        # Earlier phases keep their compositor inputs on the card for the
        # kernel times at the end; the phase's peak is read beside them.
        resident_gib = torch.cuda.memory_allocated() / 2**30
        model = oc.build_model(model_name, dev)
        n_params = sum(p.numel() for p in model.parameters())
        output = Path(tmp) / "overfit.json"
        argv = ["--scene-dir", str(scene), "--size", str(size), "--model", model_name, "--steps", str(steps),
                "--eval-every", str(eval_every), "--stage2-steps", str(stage2_steps), "--output", str(output)]
        torch.cuda.reset_peak_memory_stats()
        oc.make_train_step, oc.eval_psnr = timed_make_train_step, timed(eval_psnr, eval_done)
        trace.reset()
        try:
            record = oc.main(argv, model=model)
        finally:
            oc.make_train_step, oc.eval_psnr = make_train_step, eval_psnr
        launches = launch_record()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if json.loads(output.read_text()) != record:
            raise AssertionError("overfit colmap: the record written differs from the one returned")

        # The record, the steps and the evaluations.
        s1, s2, evals = seen[1], seen[2], seen["eval"]
        losses = [r["loss"] for r in s1 + s2] + [r["loss"] for r in record["series"] + record["stage2"]["series"]]
        if not all(math.isfinite(x) for x in losses) or not math.isfinite(record["final_psnr"] or math.nan):
            raise AssertionError(f"overfit colmap: non-finite loss or PSNR in {record}")
        if (len(s1), len(s2), len(evals)) != (steps, stage2_steps, steps // eval_every):
            raise AssertionError(f"overfit colmap: {len(s1)} stage-1 steps, {len(s2)} stage-2 steps, {len(evals)} "
                                 f"evaluations")
        for stage, recs, per_step in ((1, s1, 1), (2, s2, 2)):
            for i, r in enumerate(recs):
                if (r["fwd"], r["bwd"]) != (per_step, 2 * per_step):
                    raise AssertionError(f"overfit colmap: stage {stage} step {i} launched (fwd, bwd) "
                                         f"({r['fwd']}, {r['bwd']}), expected {per_step} calls of each")
        for r in evals:
            if (r["fwd"], r["bwd"]) != (r["views"], 0):
                raise AssertionError(f"overfit colmap: an evaluation of {r['views']} views launched {r}")
        if (record["backend"] != dev.type or record.get("card") != (card if dev.type == "cuda" else None)
                or len(record["evals"]) != len(evals)):
            raise AssertionError(f"overfit colmap: record {record}")
        overflow = [r for r in s1 + s2 if r["live"] > r["slots"]]
        if overflow:
            log(f"overfit colmap: WARNING the pair cap dropped pairs in {len(overflow)} steps "
                f"({max(r['live'] for r in overflow)} live > {overflow[0]['slots']} slots)")

        # The scene's sparse anchor, and both kernels on the trained model's
        # render of a training sample.
        images, intrinsics, poses, points = oc.load_scene(scene, size, return_points=True)
        held, _, train_set = oc.split_frames(len(images), 10)
        sample = oc.sample_train(np.random.default_rng(1), len(images), train_set, 3, 12, 2)
        batch = oc.make_batch(images, intrinsics, poses, [sample], 2, dev, points=points)
        anchored = batch.sparse_anchor["mask"].reshape(2, -1).sum(1)
        if not bool((anchored > 0).all()):
            raise AssertionError(f"overfit colmap: anchor points in the two contexts {anchored.tolist()}")
        hw, render = (size, size), oc.render_settings(size)
        model.eval()
        with torch.no_grad():
            g = model.predict_gaussians(batch._replace(style_image=batch.context_images[:, 0]))
            inputs = main_path_inputs(g, *batch[2:6], hw, render)
            fwd = check_composite(inputs, render["max_per_tile"])
            bwd = check_composite_bwd(inputs, render["max_per_tile"],
                                      *mse_cotangents(inputs, render["max_per_tile"], batch.target_images))
    del model, g
    gc.collect()
    torch.cuda.empty_cache()

    ms1 = statistics.median(r["ms"] for r in s1[2:])
    ms2 = statistics.median(r["ms"] for r in s2[1:])
    view_ms = [r["ms"] / r["views"] for r in evals]
    lives = [r["live"] for r in s1 + s2]
    seconds = time.perf_counter() - t0
    log(f"kernel composite_fwd, the overfit route's inputs ({int(inputs.live_pairs)} live pairs, the trained model "
        f"on frames {sample}): agrees with the plain version, max err {fwd['max_abs_err']:.3g}; "
        f"{fwd_windows_line(fwd)}")
    log(f"kernel composite_bwd, the overfit route's inputs and MSE cotangents: agrees with the plain version, max "
        f"err {bwd['max_abs_err']:.3g} ({bwd['max_rel_err']:.3g} of its column's largest gradient); "
        f"{windows_line(bwd)}")
    psnrs = ", ".join("%.3f dB at step %d" % (e["psnr"], e["step"]) for e in record["evals"])
    log(f"overfit colmap: {frames} frames at {size}^2 built in {t_scene:.1f} s ({len(held)} held out, "
        f"{record['held_out']} scored, anchor points {anchored.tolist()}); {model_name} width, f32, "
        f"{n_params:,} parameters, pts3d bound 20, scratch init; stage 1: {ms1:.2f} ms a step (median of "
        f"{len(s1) - 2} after 2), loss {s1[0]['loss']:.5f} -> {s1[-1]['loss']:.5f}, held-out PSNR {psnrs}; a "
        f"held-out view {', '.join('%.2f' % ms for ms in view_ms)} ms (each evaluation); stage 2: {ms2:.2f} ms a step "
        f"(median of {len(s2) - 1} after 1), loss {s2[0]['loss']:.5f} -> {s2[-1]['loss']:.5f}, style "
        f"{record['stage2']['style_first']:.5f} -> {record['stage2']['style_last']:.5f}; live pairs "
        f"{min(lives)}-{max(lives)} of {s1[0]['slots']} slots; peak {peak_gib:.2f} GiB ({resident_gib:.2f} of it "
        f"resident before the phase); launches {launches}; "
        f"phase in {seconds:.1f} s [{card}]")
    return dict(stage1_ms=ms1, stage2_ms=ms2, view_ms=view_ms, losses=[r["loss"] for r in s1 + s2],
                psnr=[e["psnr"] for e in record["evals"]], style=[record["stage2"]["style_first"],
                                                                  record["stage2"]["style_last"]],
                live_pairs=lives, pair_slots=s1[0]["slots"], peak_gib=peak_gib, resident_gib=resident_gib,
                launches=launches, fwd=fwd,
                bwd=bwd, n_params=n_params, seconds=seconds)


def fwd_time_line(what, res, card):
    log(f"kernel composite_fwd, {what}: {res['ms']:.4f} ms on the device, {res['call_ms']:.4f} ms a call "
        f"(CUDA events, median of 20), plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.5f} ms "
        f"({res['bound_by']}, {res['evals']} pixel-pair evaluations) [{card}]")
    log(f"kernel composite_fwd, {what}: launched as {shape_text(res['launch'])} (profiler trace): "
        f"{res['launch']['blocks_per_tile']:g} blocks a tile, {res['launch']['threads_per_pixel']:g} threads a pixel")


def bwd_time_line(what, res, card):
    log(f"kernel composite_bwd, {what}: {res['ms']:.4f} ms on the device (window sums "
        f"{res['phase_ms']['sums']:.4f} + gradients {res['phase_ms']['grad']:.4f}), {res['call_ms']:.4f} ms a "
        f"call (CUDA events, median of 20), plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.5f} ms "
        f"({res['bound_by']}, {res['evals']} pixel-pair evaluations) [{card}]")
    log(f"kernel composite_bwd, {what}: window sums launched as {shape_text(res['launch']['sums'])}, gradients "
        f"as {shape_text(res['launch']['grad'])} (profiler trace); {res['walked_blocks']} of the blocks of both "
        f"phases are on walked windows")


def ulp_gap(a, b):
    """Elementwise distance of two same-typed float tensors in units in the
    last place of their type (0 where bitwise equal, +0 and -0 alike)."""
    import torch

    bits = {torch.float32: (torch.int32, 0x7FFFFFFF), torch.bfloat16: (torch.int16, 0x7FFF)}[a.dtype]

    def ordered(x):
        i = x.contiguous().view(bits[0]).long()
        return torch.where(i < 0, -(i & bits[1]), i)

    return (ordered(a) - ordered(b)).abs()


def rope_attentions(model):
    """The model's attentions that rotate q and k: one RoPE kernel launch
    each a forward."""
    from styl3r_tpu_torch.models.vit import Attention, CrossAttention

    return [m for m in model.modules() if isinstance(m, (Attention, CrossAttention)) and m.rope_base is not None]


def rope_shapes(dev):
    """(name, q, qpos, k, kpos) at the main path's RoPE shapes, 256^2 (16 x
    16 tokens and the intrinsics token, 257 a view): q and k of an
    Attention are views of its qkv output, as the model makes them."""
    import torch

    from styl3r_tpu_torch.models.vit import token_grid_positions

    gen = torch.Generator(dev).manual_seed(0)

    def pos(b, views=1, extra=True):
        p = token_grid_positions(16, 16, dev)
        if extra:
            p = torch.cat([p, torch.tensor([[16, 0]], dtype=torch.int32, device=dev)])
        return p.repeat(views, 1)[None].expand(b, -1, -1)

    def self_attn(b, n, heads, dtype, p):
        qkv = torch.randn(b, n, 3 * heads * 64, generator=gen, device=dev).to(dtype)
        q, k, _ = qkv.reshape(b, n, 3, heads, 64).unbind(2)
        return q, p, k, p

    def cross(b, nq, nk, heads, dtype, qp, kp):
        return (torch.randn(b, nq, heads, 64, generator=gen, device=dev).to(dtype), qp,
                torch.randn(b, nk, heads, 64, generator=gen, device=dev).to(dtype), kp)

    bf16, f32 = torch.bfloat16, torch.float32
    return [
        ("serve encoder self-attention (2 views, 16x64, bf16)", *self_attn(2, 257, 16, bf16, pos(2))),
        ("serve decoder self-attention (1 view, 12x64, bf16)", *self_attn(1, 257, 12, bf16, pos(1))),
        ("serve decoder cross-attention (257 x 257, 12x64, bf16)", *cross(1, 257, 257, 12, bf16, pos(1), pos(1))),
        ("serve stylizer cross-attention (514 x 256, 12x64, bf16)",
         *cross(1, 514, 256, 12, bf16, pos(1, views=2), pos(1, extra=False))),
        ("stage-0 student encoder self-attention (b = 8, 16 views, 16x64, bf16)", *self_attn(16, 257, 16, bf16, pos(16))),
        ("stage-0 teacher encoder self-attention (16 views, 16x64, f32)",
         *self_attn(16, 256, 16, f32, pos(16, extra=False))),
    ]


def rope_phase(model, batch, hw, render_kwargs, card, calls=2000):
    """RoPE2D on the serving path: over one forward the kernel launches once
    for each RoPE attention the model holds (each runs once), and on each
    call's own q/k the kernel equals apply_rope2d run on the card bitwise;
    then, at rope_shapes(), the kernel's device time against its byte bound
    (q and k read and written once, positions read once), the call's time,
    the plain version's, the host's time a call and the gradient against
    autograd through apply_rope2d."""
    import torch

    from styl3r_tpu_torch.models import vit
    from styl3r_tpu_torch.ops import rope

    attns = rope_attentions(model)
    ran, seen = [], []
    hooks = [m.register_forward_hook(lambda m, a, o: ran.append(m)) for m in attns]
    kernel_qk = vit.rope2d_qk

    def record(*args):
        seen.append(args)
        return kernel_qk(*args)

    vit.rope2d_qk = record
    try:
        before = trace.counters()["rope2d"]
        # no_grad, where the serving forwards before ran in inference mode:
        # the encoder's first call of a signature runs eagerly, so the hooks
        # and the recorder see each attention (a replayed graph runs no
        # Python).
        with torch.no_grad():
            model(batch, hw, **render_kwargs)
        torch.cuda.synchronize()
        launched = trace.counters()["rope2d"] - before
    finally:
        vit.rope2d_qk = kernel_qk
        for h in hooks:
            h.remove()
    if not launched == len(ran) == len(attns) == len(seen) or len(set(map(id, ran))) != len(attns):
        raise AssertionError(f"rope: {launched} kernel launches over one serving forward, {len(ran)} RoPE attention "
                             f"calls of the model's {len(attns)}")
    gaps, values, unequal = [], 0, 0
    with torch.inference_mode():
        for q, qpos, k, kpos, base in seen:
            for ours, (x, p) in zip(kernel_qk(q, qpos, k, kpos, base), ((q, qpos), (k, kpos))):
                gap = ulp_gap(ours, rope.apply_rope2d(x, p, base))
                gaps.append(int(gap.max()))
                values += gap.numel()
                unequal += int((gap > 0).sum())
    log(f"rope: one serving forward launched the kernel {launched} times, once for each of the model's "
        f"{len(attns)} RoPE attentions; on their own q/k the kernel against apply_rope2d on the card: "
        f"{unequal} of {values} values differ, by at most {max(gaps)} ulp")
    res = dict(launches_per_forward=launched, rope_attentions=len(attns), values=values, unequal=unequal,
               max_ulp=max(gaps), shapes=[])

    def host_us(fn, n):
        """Host microseconds a call of fn, n calls back to back (the device
        keeps up: a kernel lasts a few microseconds)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    for name, q, qpos, k, kpos in rope_shapes(next(model.parameters()).device):
        n_bytes = sum(2 * x.numel() * x.element_size() + p.numel() * 4 for x, p in ((q, qpos), (k, kpos)))
        bound_ms = n_bytes / 3.35e12 * 1e3
        with torch.inference_mode():
            ms, _, shapes = kernel_device_ms(lambda: rope.rope2d_qk(q, qpos, k, kpos), 50, ("rope2d_kernel",))
            call_ms = cuda_ms(lambda: rope.rope2d_qk(q, qpos, k, kpos), 20)
            plain_ms = cuda_ms(lambda: (rope.apply_rope2d(q, qpos), rope.apply_rope2d(k, kpos)), 20)
            host = dict(kernel=host_us(lambda: rope.rope2d_qk(q, qpos, k, kpos), calls),
                        plain=host_us(lambda: (rope.apply_rope2d(q, qpos), rope.apply_rope2d(k, kpos)), calls // 10))
        # With grad: the autograd Function's forward, then its backward (the
        # kernel run as the inverse rotation) against autograd through the
        # plain version, for a seeded cotangent.
        qg, kg = q.detach().clone().requires_grad_(), k.detach().clone().requires_grad_()
        host["kernel_with_grad"] = host_us(lambda: rope.rope2d_qk(qg, qpos, kg, kpos), calls // 4)
        gen = torch.Generator(q.device).manual_seed(1)
        cot = [torch.randn(x.shape, generator=gen, device=q.device).to(x.dtype) for x in (q, k)]
        before = trace.counters()["rope2d"]
        ours = torch.autograd.grad(rope.rope2d_qk(qg, qpos, kg, kpos), (qg, kg), cot)
        if trace.counters()["rope2d"] - before != 2:
            raise AssertionError("rope: a forward and backward with grad did not launch the kernel twice")
        plain = torch.autograd.grad((rope.apply_rope2d(qg, qpos), rope.apply_rope2d(kg, kpos)), (qg, kg), cot)
        grad_ulp = max(int(ulp_gap(a, b).max()) for a, b in zip(ours, plain))
        res["shapes"].append(dict(name=name, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by="bytes", roofline=bound_ms / ms, bytes=n_bytes, host_us=host,
                                  grad_ulp=grad_ulp, launch=shapes["rope2d_kernel"]))
        log(f"kernel rope2d, {name}: {ms * 1e3:.2f} us on the device against its byte bound {bound_ms * 1e3:.2f} us "
            f"({100 * bound_ms / ms:.1f}%, {n_bytes} bytes), a call {call_ms * 1e3:.1f} us, the plain version "
            f"{plain_ms * 1e3:.1f} us; host a call back to back {host['kernel']:.1f} us (with grad "
            f"{host['kernel_with_grad']:.1f}, plain {host['plain']:.1f}); gradient against autograd through the "
            f"plain version at most {grad_ulp} ulp; launch {shapes['rope2d_kernel']} [{card}]")
    if res["max_ulp"] or any(s["grad_ulp"] for s in res["shapes"]):
        raise AssertionError(f"rope: kernel not bitwise equal to the plain version: {res}")
    return res


# The DPT heads' routed 3x3 convs (ops/conv.py::conv3x3) as (images, cin,
# cout, h, w): stage 2's at b = 6 over 3 views (the heads take 6, 12 and 18
# images), the serving points heads' f32 head["2"] at b = 1 and 8, and
# ragged sizes the heads never make.
CONV_SHAPES = (
    (6, 96, 256, 64, 64), (12, 192, 256, 32, 32), (18, 384, 256, 16, 16), (6, 768, 256, 8, 8),
    (18, 256, 256, 8, 8), (6, 256, 256, 16, 16), (12, 256, 256, 32, 32), (18, 256, 256, 64, 64),
    (6, 256, 128, 128, 128), (12, 128, 128, 256, 256), (1, 128, 128, 256, 256),
    (3, 32, 96, 17, 23), (1, 256, 96, 17, 23), (2, 5, 7, 9, 11), (2, 16, 24, 1, 3),
)
# Timed against cuDNN: stage 2's Gaussian tower (head["0"], 256 -> 256 at
# 256^2, 18 images), serving's head["2"] (128 -> 128 at 256^2) at
# serve-2v256's b = 1 and batch-b8-2v256's 8 images a points head, and the
# small levels that split K.
CONV_TIMED = (
    ("stage-2 Gaussian tower head[0]", (18, 256, 256, 256, 256)),
    ("serve-2v256 head[2]", (1, 128, 128, 256, 256)),
    ("batch-b8-2v256 head[2]", (8, 128, 128, 256, 256)),
    ("stage-2 layer4_rn (split K)", (6, 768, 256, 8, 8)),
    ("stage-2 refinenet3 unit (split K)", (6, 256, 256, 16, 16)),
    ("stage-2 refinenet1 unit", (18, 256, 256, 64, 64)),
)
FP32_PEAK = 67e12  # H100 SXM f32 FFMA, FLOP/s (NVIDIA's data sheet, 700 W)
CONV_REL_L2 = 1e-5


def conv_flops(n, cin, cout, h, w):
    return 2 * n * h * w * cout * 9 * cin


def conv_case(shape, bias, dev, seed=0):
    """A seeded (x, nn.Conv2d) pair of `shape` on dev."""
    import torch

    n, cin, cout, h, w = shape
    gen = torch.Generator(dev).manual_seed(seed)
    conv = torch.nn.Conv2d(cin, cout, 3, padding=1, bias=bias).to(dev)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen, device=dev) / math.sqrt(9 * cin))
        if bias:
            conv.bias.copy_(torch.randn(cout, generator=gen, device=dev))
    return torch.randn(n, cin, h, w, generator=gen, device=dev), conv


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def back_to_back_ms(fn, calls, reps=5):
    """Median over reps of the milliseconds a call of fn takes in a run of
    `calls` calls back to back between two CUDA events: the host's time to
    issue a call hides behind the device's work, for the kernel's wrapper
    and the library call alike."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def conv_phase(card, dev):
    """The heads' 3x3 conv kernel (csrc/conv3x3_f32.cu) with TF32 off: at
    every CONV_SHAPES shape, with and without bias and ReLU, against F.conv2d
    (relative L2 at most CONV_REL_L2), one launch a call, two calls bitwise
    equal; its gradient through the autograd Function against F.conv2d's;
    no launch in bfloat16 or with TF32 allowed; then at CONV_TIMED the
    kernel's device time (profiler) against its FFMA bound, and a call of
    the route (conv3x3) against cuDNN's f32 F.conv2d (library_ms), both
    timed back to back. The training paths' launches are checked where
    they run (train_phase, main)."""
    import torch
    import torch.nn.functional as F

    from styl3r_tpu_torch.ops import conv as tconv

    res = {"shapes": [], "timed": []}
    worst = 0.0
    for i, shape in enumerate(CONV_SHAPES):
        bias, relu = (True, False) if i % 3 == 0 else (False, True) if i % 3 == 1 else (True, True)
        x, conv = conv_case(shape, bias, dev, seed=i)
        with torch.no_grad():
            before = trace.counters()["conv3x3_f32"]
            a = tconv.conv3x3(x, conv, relu=relu)
            b = tconv.conv3x3(x, conv, relu=relu)
            launched = trace.counters()["conv3x3_f32"] - before
            want = F.conv2d(x, conv.weight, conv.bias, padding=1)
            if relu:
                want = F.relu(want)
        torch.cuda.synchronize()
        gap = rel_l2(a, want)
        worst = max(worst, gap)
        res["shapes"].append(dict(shape=list(shape), bias=bias, relu=relu, rel_l2=gap,
                                  plan=tconv.plan(shape[0] * shape[3] * shape[4], shape[2], shape[1],
                                                   torch.cuda.get_device_properties(dev).multi_processor_count)))
        if launched != 2 or not torch.equal(a, b) or not gap <= CONV_REL_L2:
            raise AssertionError(f"conv3x3 at {shape} (bias {bias}, relu {relu}): {launched} launches for 2 calls, "
                                 f"bitwise equal {torch.equal(a, b)}, relative L2 {gap:.3g} from F.conv2d")
        del x, conv, a, b, want
    log(f"conv3x3: {len(CONV_SHAPES)} shapes against F.conv2d with TF32 off: relative L2 at most {worst:.3g}, "
        f"one launch a call, two calls bitwise equal [{card}]")
    res["max_rel_l2"] = worst

    # The gradient: convolution_backward on the saved input and weight, as
    # F.conv2d's autograd; cuDNN deterministic, so equal bits where no ReLU
    # mask can differ.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for relu in (False, True):
            x, conv = conv_case((2, 64, 96, 33, 20), True, dev, seed=5)
            x.requires_grad_()
            g = torch.randn(2, 96, 33, 20, generator=torch.Generator(dev).manual_seed(6), device=dev)
            ours = torch.autograd.grad(tconv.conv3x3(x, conv, relu=relu), (x, conv.weight, conv.bias), g)
            y = F.conv2d(x, conv.weight, conv.bias, padding=1)
            theirs = torch.autograd.grad(F.relu(y) if relu else y, (x, conv.weight, conv.bias), g)
            gaps = [rel_l2(a, b) for a, b in zip(ours, theirs)]
            equal = all(torch.equal(a, b) for a, b in zip(ours, theirs))
            log(f"conv3x3: gradient (relu {relu}) against F.conv2d's: bitwise equal {equal}, relative L2 {gaps}")
            if (not relu and not equal) or max(gaps) > CONV_REL_L2:
                raise AssertionError(f"conv3x3: gradient off F.conv2d's (relu {relu}): {gaps}")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    x, conv = conv_case((2, 32, 32, 16, 16), True, dev)
    before = trace.counters()["conv3x3_f32"]
    with torch.no_grad():
        tconv.conv3x3(x.bfloat16(), conv.bfloat16())
        torch.backends.cudnn.allow_tf32 = True
        try:
            tconv.conv3x3(x, conv.float())
        finally:
            torch.backends.cudnn.allow_tf32 = False
        with torch.autocast("cuda", dtype=torch.bfloat16):
            tconv.conv3x3(x, conv)
    if trace.counters()["conv3x3_f32"] != before:
        raise AssertionError("conv3x3 launched the kernel in bfloat16, under TF32 or under autocast")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, shape in CONV_TIMED:
        x, conv = conv_case(shape, True, dev)
        n_flops = conv_flops(*shape)
        bound_ms = n_flops / FP32_PEAK * 1e3
        calls = max(3, min(50, int(2e11 / n_flops) + 1))
        with torch.no_grad():
            ms, _, launch = kernel_device_ms(lambda: tconv.conv3x3(x, conv), 10, ("conv3x3_f32_kernel",))
            call_ms = back_to_back_ms(lambda: tconv.conv3x3(x, conv), calls)
            library_ms = back_to_back_ms(lambda: F.conv2d(x, conv.weight, conv.bias, padding=1), calls)
        tflops = n_flops / ms / 1e9
        plan = tconv.plan(shape[0] * shape[3] * shape[4], shape[2], shape[1], sms)
        res["timed"].append(dict(name=name, shape=list(shape), ms=ms, call_ms=call_ms, library_ms=library_ms,
                                 bound_ms=bound_ms, bound_by="f32 FFMA", tflops=tflops, peak_share=tflops / 67,
                                 plan=plan, launch=launch["conv3x3_f32_kernel"]))
        log(f"kernel conv3x3_f32, {name} {shape}: {ms:.4f} ms on the device; back to back a call {call_ms:.4f} ms, "
            f"cuDNN's f32 F.conv2d (TF32 off) {library_ms:.4f} ms; {tflops:.1f} TFLOP/s = {100 * tflops / 67:.1f}% of 67 TFLOP/s, bound "
            f"{bound_ms:.4f} ms; (tile pixels, splits, chunks a split) {plan}; launched as {shape_text(launch['conv3x3_f32_kernel'])} [{card}]")
        del x, conv
    torch.cuda.empty_cache()
    return res


def sdpa_backend(kernel_names):
    """The SDPA backend a forward's attention kernels name: cudnn, flash or
    efficient; "math" where none of theirs ran."""
    names = " ".join(kernel_names).lower()
    if "cudnn" in names and "sdpa" in names:
        return "cudnn"
    if "flash" in names:
        return "flash"
    return "efficient" if "fmha" in names else "math"


def vggt_phase(card, dev, frame_counts=(32, 2), hw=(392, 518), seed=0, widths=None):
    """VGGT-1B on the card (phase 18): for each frame count, a warm-up
    forward in which every RoPE call's kernel output is compared bitwise
    with apply_rope2d on its own float32 q/k (the frame and global blocks'
    shapes, the special tokens at (0, 0)); a forward profiled (kernel
    launches, the SDPA backend) and timed (CUDA events, 3 forwards), with
    its RoPE launches and peak memory; then the outputs against the plain
    float32 reference on the same weights and images, each relative L2 held
    to the vggt.serve-32f518 cell's limit. `widths` replaces VGGT-1B's (a
    tiny model for a CPU rehearsal)."""
    import importlib.util

    import torch
    from torch.profiler import ProfilerActivity, profile

    from styl3r_tpu_torch.models import vit
    from styl3r_tpu_torch.models.registry import get_model
    from styl3r_tpu_torch.models.vggt import VGGT_1B
    from styl3r_tpu_torch.ops import rope

    spec = importlib.util.spec_from_file_location("vggt_reference", os.path.join(ROOT, "tests", "vggt_reference.py"))
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    w = dict(VGGT_1B, **(widths or {}))
    cuda = dev.type == "cuda"
    ref = reference.draw(seed, dev, **w)
    model = get_model("vggt", **w, compute_dtype=torch.bfloat16 if cuda else None, device=dev, seed=seed + 1)
    model.load_state_dict(ref.state_dict())
    model.eval()
    with open(os.path.join(ROOT, "portbench", "workloads", "vggt.serve-32f518.json")) as f:
        limits = json.load(f)["check"]["limits"]
    kernel_qk = vit.rope2d_qk

    def checked_qk(q, qpos, k, kpos, base):
        """The kernel's call, and its outputs against apply_rope2d in float32
        on the same q/k (autocast off), bitwise."""
        out = kernel_qk(q, qpos, k, kpos, base)
        with torch.autocast(dev.type, enabled=False):
            for ours, (x, p) in zip(out, ((q, qpos), (k, kpos))):
                gap = ulp_gap(ours, rope.apply_rope2d(x, p, base))
                rope_seen.append((tuple(x.shape), str(x.dtype).replace("torch.", ""), int((p == 0).all(-1).sum()),
                                  x.numel(), int((gap > 0).sum()), int(gap.max())))
        return out

    res = {}
    for s in frame_counts:
        x = torch.rand(1, s, 3, *hw, generator=torch.Generator().manual_seed(s)).to(dev)
        rope_seen = []
        with torch.inference_mode():
            vit.rope2d_qk = checked_qk
            try:
                model(x)
            finally:
                vit.rope2d_qk = kernel_qk
            shapes = sorted({(shape, dtype, at_origin) for shape, dtype, at_origin, *_ in rope_seen})
            unequal, max_ulp = sum(r[4] for r in rope_seen), max(r[5] for r in rope_seen)
            log(f"vggt: {s} frames, RoPE kernel against apply_rope2d on the forward's own q/k: {len(rope_seen) // 2} "
                f"calls at (shape, dtype, tokens at (0, 0)) {shapes}; {unequal} of {sum(r[3] for r in rope_seen)} "
                f"values differ, by at most {max_ulp} ulp [{card}]")
            if unequal or {dtype for _, dtype, _ in shapes} != {"float32"} or len(rope_seen) != 4 * w["depth"]:
                raise AssertionError(f"vggt: RoPE kernel not bitwise equal to apply_rope2d on float32 q/k: {shapes}, "
                                     f"{unequal} values differ, {len(rope_seen) // 2} calls")
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
            before = trace.counters()["rope2d"]
            conv_before = trace.counters()["conv3x3_f32"]
            with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
                out = model(x)
                if cuda:
                    torch.cuda.synchronize()
            rope_launches = trace.counters()["rope2d"] - before
            conv_launches = trace.counters()["conv3x3_f32"] - conv_before
            names = [e.name for e in prof.events() if cuda and e.device_type.name == "CUDA"]
            peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            ms = cuda_ms(lambda: model(x), 3) if cuda else None
        backend = sdpa_backend(names) if cuda else "cpu"
        with torch.no_grad():
            want = ref(x)
        gaps = {k: float((out[k] - want[k]).double().norm() / want[k].double().norm())
                for k in ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf")}
        checked = {"pose_rel_l2": gaps["pose_enc"], "depth_rel_l2": gaps["depth"],
                   "points_rel_l2": gaps["world_points"],
                   "conf_rel_l2": max(gaps["depth_conf"], gaps["world_points_conf"])}
        res[f"{s}f"] = dict(frames=s, hw=list(hw), launches=len(names), rope_launches=rope_launches,
                            conv3x3_launches=conv_launches,
                            sdpa_backend=backend, peak_gib=peak / 2**30, forward_ms=ms, rel_l2=gaps,
                            rope_shapes=[list(x) for x in shapes])
        log(f"vggt: {s} frames of {hw[1]}x{hw[0]}: {len(names)} kernel launches, {rope_launches} RoPE launches, "
            f"SDPA backend {backend}, peak {peak / 2**30:.2f} GiB, a forward {ms} ms; relative L2 from the f32 "
            f"reference {gaps}, against the cell's limits {limits} [{card}]")
        if cuda and (rope_launches != 2 * w["depth"] or backend == "math"):
            raise AssertionError(f"vggt: {rope_launches} RoPE launches (want {2 * w['depth']}), backend {backend}")
        over = {k: v for k, v in checked.items() if not v <= limits[k]}
        if over:
            raise AssertionError(f"vggt: {s} frames: outputs off the f32 reference beyond the cell's limits: {over}, "
                                 f"limits {limits}")
        del out, want
    # The cell's setting (vggt.json's cudnn_tf32): cuDNN may use TF32, so
    # the heads' refinenet convs take F.conv2d and the conv kernel no launch.
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        before = trace.counters()["conv3x3_f32"]
        with torch.inference_mode():
            model(x)
        res["tf32_conv3x3_launches"] = trace.counters()["conv3x3_f32"] - before
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    log(f"vggt: a request with cuDNN's TF32 allowed launched the conv kernel {res['tf32_conv3x3_launches']} times "
        f"(with TF32 off: {conv_launches})")
    if res["tf32_conv3x3_launches"]:
        raise AssertionError("vggt: the conv kernel was launched with TF32 allowed")
    del model, ref
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from styl3r_tpu_torch import native
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
    t0 = time.perf_counter()
    if native.native_available():
        log(f"build: the native host loader ({native.library_path().name}, g++ and libjpeg) in "
            f"{time.perf_counter() - t0:.1f} s")
    else:
        log(f"build: the native host loader is unavailable ({native.unavailable_reason()}): the datasets decode "
            f"with PIL")

    # -- multi-GPU training first, while this process holds nothing on the
    # card: data parallelism over NCCL and gloo, tensor parallelism, each in
    # child processes ---------------------------------------------------------
    distributed = distributed_phase(card)

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

    trace.reset()
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
            if kernel_launches()[0] != i + 1:
                raise AssertionError(f"scene {seed}: compositor launches {kernel_launches()[0]}, expected {i + 1}")
            log(f"scene {seed}: color mean {float(out.color.mean()):.4f}, alpha max {float(out.alpha.max()):.4f}, "
                f"live pairs {live} of {slots} slots, compositor launches {kernel_launches()[0]}")
    launches = {"serve": launch_record()}
    if launches["serve"]["composite_fwd"] == 0:
        raise AssertionError("kernel composite_fwd was not launched on the serving path")
    # Serving's bf16 trunks bypass the conv kernel; the points heads' f32
    # head["2"] takes it: 2 launches a forward.
    if launches["serve"]["conv3x3_f32"] != 2 * 3:
        raise AssertionError(f"kernel conv3x3_f32: {launches['serve']['conv3x3_f32']} launches over 3 serving forwards, "
                             f"want 6")
    rope_res = rope_phase(model, batch, hw, render_kwargs, card)
    conv_res = conv_phase(card, dev)

    with torch.inference_mode():
        # batch[2:6]: the target cameras (extrinsics, intrinsics, near, far).
        res_main = check_composite(main_path_inputs(gaussians, *batch[2:6], hw, render_kwargs), 2048)
    log(f"kernel composite_fwd, serving path's own inputs: agrees with the plain version, "
        f"max err {res_main['max_abs_err']:.3g}; {fwd_windows_line(res_main)}")

    # -- serving timing: forwards back to back (throughput) and each
    # synchronised (latency), bench/serve.py's measurement ----------------
    from styl3r_tpu_torch.bench import serve

    timing = serve.measure(model, batch, hw, render_kwargs, iters=10)
    fwd_flops = flops.styl3r_forward_flops(b=1, v=2, h=256, w=256, style_hw=256, n_targets=1,
                                           pair_cap_per_gaussian=2)["total"]
    util = flops.mfu(fwd_flops, timing["ms"] / 1e3)
    log(f"main path: {timing['scenes_per_sec']:.3f} scenes/s back to back ({timing['ms']:.2f} ms a scene, 10 "
        f"forwards, one synchronise), {util['tflops']:.1f} TFLOP/s = MFU {util['mfu']:.4f} of 989 TFLOP/s bf16; "
        f"latency {timing['latency_ms']:.2f} ms (encoder {timing['encoder_ms']:.2f} ms, render "
        f"{timing['render_ms']:.2f} ms; median of {serve.LATENCY_REPS} synchronised); "
        f"{timing['host_syncs']['count']} host syncs a forward, at {timing['host_syncs']['where']} [{card}]")
    del gaussians, out

    # -- the posed adapter's route: the model's raw channels through
    # posed_gaussian_adapter, rendered and differentiated ------------------
    posed = posed_phase(model, card, hw, render_kwargs)
    launches["posed"] = posed.pop("launches")

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

    # -- training: full width, f32 master weights, a bf16 backbone, f32 heads
    # (the Trainer's and the stage-2 cells' model) ----------------------------
    train_kwargs = TRAIN_RENDER
    model = full_width_training_model(dev, f32_heads=True)
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
    launches["train_stage1"] = {"composite_fwd": stage1["fwd"], "composite_bwd": stage1["bwd"],
                              "conv3x3_f32": stage1["conv3x3"]}
    model.load_state_dict(scratch_state)
    del scratch_state
    gc.collect()  # stage 1's optimizer state
    torch.cuda.empty_cache()
    stage2 = train_phase(model, train_batch, hw, train_kwargs, card, stage=2)
    launches["train_stage2"] = {"composite_fwd": stage2["fwd"], "composite_bwd": stage2["bwd"],
                              "conv3x3_f32": stage2["conv3x3"]}
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

    # -- the distillation stage: stage 0, then stage 1 with the term ---------
    distill = distill_phase(card)
    launches["distill_stage0"] = distill["stage0"]["launches"]
    launches["distill_stage1"] = distill["stage1"]["launches"]
    for kernel in ("composite_fwd", "composite_bwd"):
        if not launches["distill_stage1"][kernel]:
            raise AssertionError(f"kernel {kernel} was not launched by stage 1 with the distillation term")

    # -- secondary modules: backbones, 3-D stylizers, geometry, and the
    # AdaAttN + depth-smoothness render route ------------------------------
    t0 = time.perf_counter()
    secondary = secondary_phase(card)
    secondary["seconds"] = time.perf_counter() - t0
    log(f"secondary: phase in {secondary['seconds']:.1f} s")
    launches["adaattn_depth"] = secondary["route"].pop("launches")
    launches["dist_nccl_fit"] = distributed["nccl_fit"]["launches"]
    launches["dist_gloo"] = {k: sum(r[s]["launches"][k] for r in distributed["gloo"] for s in ("stage1", "stage2"))
                             for k in ("composite_fwd", "composite_bwd")}
    launches["dist_tp"] = distributed["tp"]["launches"]
    for path in ("dist_nccl_fit", "dist_gloo", "dist_tp"):
        for kernel in ("composite_fwd", "composite_bwd"):
            if not launches[path][kernel]:
                raise AssertionError(f"kernel {kernel} was not launched by {path}")

    # -- the measurement entry points: bench.{serve,stages,train_step} ------
    bench = bench_phase(card, dev)
    launches.update(bench.pop("launches"))

    # -- the scene-overfit entry point: stage 1 from scratch, held-out
    # evaluations and stage 2 on a synthetic COLMAP scene ------------------
    overfit = overfit_phase(card, dev)
    launches["overfit_colmap"] = overfit.pop("launches")
    for kernel in ("composite_fwd", "composite_bwd"):
        if not launches["overfit_colmap"][kernel]:
            raise AssertionError(f"kernel {kernel} was not launched by overfit_colmap")

    # -- kernel times: device time from the profiler, after the paths'
    # timing, which the profiler's attached tracing would slow down ---------
    for what, res in (("dense cloud", res_dense), ("serving path's own inputs", res_main),
                      ("stage-1 training path's own inputs", res_train), ("alignment's own inputs", infer["fwd"]),
                      ("the video's first chunk", infer["video_fwd"]), ("the fit's first step's inputs", fit["fwd"]),
                      ("the fit's orthographic projection", fit["ortho_fwd"]),
                      ("pose recovery's first step", recovery_fwd),
                      ("eval_pose's refinement, first step", evaluation["fwd"]),
                      ("the refinement recovery's first step", evaluation["recovery_fwd"]),
                      ("stage 1 + distill's first step", distill["fwd"]),
                      ("the adaattn + depth route's inputs", secondary["fwd"]),
                      ("the posed route's inputs", posed["fwd"]),
                      ("the 128^2 train-step case's inputs", bench["fwd"]),
                      ("the overfit route's inputs", overfit["fwd"])):
        fwd_time_line(what, composite_device_ms(res), card)
    for what, res in (("dense cloud", bwd_dense), ("training path's own inputs", bwd_main),
                      ("alignment's own inputs", infer["bwd"]), ("the fit's first step's inputs", fit["bwd"]),
                      ("pose recovery's first step", recovery_bwd),
                      ("eval_pose's refinement, first step", evaluation["bwd"]),
                      ("the refinement recovery's first step", evaluation["recovery_bwd"]),
                      ("stage 1 + distill's first step", distill["bwd"]),
                      ("the adaattn + depth route's inputs and cotangents", secondary["bwd"]),
                      ("the posed route's inputs and MSE cotangents", posed["bwd"]),
                      ("the 128^2 train-step case's inputs and MSE cotangents", bench["bwd"]),
                      ("the overfit route's inputs and MSE cotangents", overfit["bwd"])):
        bwd_time_line(what, composite_bwd_device_ms(res), card)
    # The 2-rank route's kernels were timed in its rank 0's process.
    fwd_time_line("rank 0's render of the 2-rank gloo step", distributed["fwd"], card)
    bwd_time_line("rank 0's render of the 2-rank gloo step and its cotangents", distributed["bwd"], card)

    reference_phase(card)

    # -- VGGT-1B: 32 and 2 frames at 518x392 -----------------------------------
    vggt = vggt_phase(card, dev)

    # Every path with float32 heads and TF32 off takes the heads' conv kernel.
    conv_launches = {path: v["conv3x3_f32"] for path, v in launches.items() if "conv3x3_f32" in v}
    for path in ("train_stage1", "train_stage2", "fit", "distill_stage0", "bench_train"):
        if not conv_launches[path]:
            raise AssertionError(f"kernel conv3x3_f32 was not launched by {path}")
    conv_per_unit = {"serve_forward": launches["serve"]["conv3x3_f32"] // 3,
                     "train_stage1_step": stage1["conv3x3_per_step"], "train_stage2_step": stage2["conv3x3_per_step"],
                     "vggt_request_tf32": vggt["tf32_conv3x3_launches"]}

    # Every path that runs a model on the card rotates q and k in the kernel.
    rope_launches = {path: v["rope2d"] for path, v in launches.items() if "rope2d" in v}
    for path in ("serve", "fit", "distill_stage0", "distill_stage1", "bench_serve", "bench_train"):
        if not rope_launches[path]:
            raise AssertionError(f"kernel rope2d was not launched by {path}")

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
               evaluation["recovery_bwd"], distill["bwd"], secondary["bwd"], distributed["bwd"], posed["bwd"],
               bench["bwd"], overfit["bwd"])

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
                                                               evaluation["recovery_fwd"], distill["fwd"],
                                                               secondary["fwd"], distributed["fwd"], posed["fwd"],
                                                               bench["fwd"], overfit["fwd"])),
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
            "distill_inputs": {**fwd_numbers(distill["fwd"]), "max_abs_err": distill["fwd"]["max_abs_err"]},
            "adaattn_depth_inputs": {**fwd_numbers(secondary["fwd"]), "max_abs_err": secondary["fwd"]["max_abs_err"]},
            "dist_gloo_inputs": {**fwd_numbers(distributed["fwd"]), "max_abs_err": distributed["fwd"]["max_abs_err"]},
            "posed_inputs": {**fwd_numbers(posed["fwd"]), "max_abs_err": posed["fwd"]["max_abs_err"]},
            "bench_train_128_inputs": {**fwd_numbers(bench["fwd"]), "max_abs_err": bench["fwd"]["max_abs_err"]},
            "overfit_colmap_inputs": {**fwd_numbers(overfit["fwd"]), "max_abs_err": overfit["fwd"]["max_abs_err"]},
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
            "distill_inputs": bwd_numbers(distill["bwd"]),
            "adaattn_depth_inputs": {**bwd_numbers(secondary["bwd"]),
                                     "nonzero_by_column": secondary["bwd"]["nonzero_by_column"]},
            "dist_gloo_inputs": bwd_numbers(distributed["bwd"]),
            "posed_inputs": bwd_numbers(posed["bwd"]),
            "bench_train_128_inputs": bwd_numbers(bench["bwd"]),
            "overfit_colmap_inputs": bwd_numbers(overfit["bwd"]),
        },
        {
            "name": "rope2d",
            "route": "cuda",
            "source": "styl3r_tpu_torch/csrc/rope2d.cu",
            "replaces": None,  # the JAX package leaves RoPE2D to XLA (styl3r_tpu/ops/rope.py)
            "launches": sum(rope_launches.values()),
            "launches_by_path": rope_launches,
            **{k: rope_res["shapes"][0][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            **rope_res,
        },
        {
            "name": "conv3x3_f32",
            "route": "cuda",
            "source": "styl3r_tpu_torch/csrc/conv3x3_f32.cu",
            "replaces": None,  # the JAX package leaves the heads' convs to XLA (styl3r_tpu/models/dpt.py)
            "launches": sum(conv_launches.values()),
            "launches_by_path": conv_launches,
            "launches_per_unit": conv_per_unit,
            **{k: conv_res["timed"][0][k] for k in ("ms", "call_ms", "bound_ms", "bound_by", "library_ms")},
            "plain_ms": conv_res["timed"][0]["library_ms"],  # the plain version is F.conv2d
            **conv_res,
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
    distill_summary = {k: v for k, v in distill.items() if k not in ("fwd", "bwd")}
    secondary_summary = {k: v for k, v in secondary.items() if k not in ("fwd", "bwd")}
    distributed_summary = {k: v for k, v in distributed.items() if k not in ("fwd", "bwd")}
    posed_summary = {k: v for k, v in posed.items() if k not in ("fwd", "bwd")}
    bench_summary = {k: v for k, v in bench.items() if k not in ("fwd", "bwd")}
    overfit_summary = {k: v for k, v in overfit.items() if k not in ("fwd", "bwd")}
    print(json.dumps({"kernels": kernels, "training": training, "inference": inference,
                      "evaluation": evaluation_summary, "fit": fit_summary, "distill": distill_summary,
                      "secondary": secondary_summary, "distributed": distributed_summary, "posed": posed_summary,
                      "bench": bench_summary, "overfit_colmap": overfit_summary, "vggt": vggt,
                      "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(distributed_child(sys.argv[2:]) if sys.argv[1:2] == ["--distributed-child"] else main())
