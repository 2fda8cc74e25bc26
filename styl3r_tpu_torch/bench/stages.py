"""Per-stage time of the serving predict + render, and of the render's
backward (counterpart of scripts/profile_stages.py):

    python -m styl3r_tpu_torch.bench.stages [--iters 10] [--views 2] [--batch 1] [--size 256]
        [--impl auto|jnp|pallas] [--pair-cap 0] [--max-per-tile N] [--output FILE]
    python -m styl3r_tpu_torch.bench.stages --cpu --tiny --iters 1   # a quick run on the CPU

The serving model (serve.py's: random weights from seed 0, bf16 trunks
stored in bf16) on bench.py's scene. Each stage runs --iters times back to
back, its input perturbed by the previous output (timing.back_to_back_ms),
under the names profile_stages.py gives them: the encoder's slices
(`backbone`, `backbone+stylizer`, `predict (enc+sty+heads+adapter)`), the
render's on the predicted Gaussians' first scene and target view (`project
only`, `project+bin (no sort)`, `project+bin+sort`, `pack_attrs (gather)`,
`composite kernel only`), `render (proj+sort+composite)` and `full
forward`, and the backward's (`bwd:render fwd+bwd`, `bwd:composite kernel
fwd+bwd`, `bwd:pack_attrs fwd+bwd (gather+scatter)`). Stages the port has
no counterpart of are listed under `absent` with the reason.

Prints one JSON line: ms a scene of each stage (`per_scene_ms`),
`derived_ms` (stylizer, heads+adapter, composite), `scenes_per_sec` and
`mfu` of the full forward (None on the CPU), and on the card the full
forward's `device_breakdown` (device time and busy share, the top kernels,
the longest gaps between kernels and the host op and utils/trace.py span
in each) and `host_syncs`.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import Tensor

from ..device import resolve_device
from ..models.decoder import render_gaussians
from ..models.precision import compute_in
from ..models.styl3r import Styl3rModel, normalize_images
from ..ops.rasterizer import composite
from ..ops.rasterizer.camera import make_raster_camera
from ..ops.rasterizer.project import eval_sh, project_gaussians
from ..ops.rasterizer.render import TILE, _build_pairs, _sort_pairs
from ..utils import flops
from .batch import example_batch
from .common import TINY, device_names, flops_dims, no_tf32, resolve_impl, route, route_name, serving_model
from .timing import back_to_back_ms, device_breakdown, host_syncs

BREAKDOWN_REPS = 3
CHAIN_REASON = (
    "predict and the render cut at this step in one jit, where XLA may fuse across the predict|render boundary; "
    "eager PyTorch launches the same kernels as predict followed by the isolated render stages"
)
ABSENT = {
    "render unbatched (no vmap)": (
        "the port renders every view through one render_many call (render() is its one-view case): there is no "
        "vmapped route to set an unbatched one against"),
    "bwd:scatter_window_grads only": (
        "csrc/composite_bwd.cu writes each pair's gradient row itself: there are no window gradients to scatter"),
    "bwd:gather_window_grads only": (
        "csrc/composite_bwd.cu writes each pair's gradient row itself: there are no window gradients to gather"),
    "bwd:pack_attrs fwd+bwd (grouped)": (
        "the port has no take_rows_grouped: pack_attrs' backward is index_select's, an index_add_"),
    **{f"chain:{st}": CHAIN_REASON for st in ("project", "binsort", "pack", "composite", "images")},
}


def first_float(out) -> Tensor:
    """One element of the first floating-point tensor in `out` (a tensor
    or nested tuples and lists of them), as f32."""
    if torch.is_tensor(out):
        return out.reshape(-1)[0].float() if out.is_floating_point() else None
    for x in out:
        found = first_float(x)
        if found is not None:
            return found
    return None


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--tiny", action="store_true", help="tiny trunk widths at 64^2 (a quick run)")
    parser.add_argument("--views", type=int, default=2)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--iters", type=int, default=10, help="calls back to back a stage")
    parser.add_argument("--impl", default="auto", choices=["auto", "jnp", "pallas"],
                        help="jnp: the plain compositor; pallas: the compositor kernels (the card)")
    parser.add_argument("--pair-cap", type=int, default=0, help="pair_cap_per_gaussian of the render (0 = exact)")
    parser.add_argument("--max-per-tile", type=int, default=0, help="override max_per_tile of the render")
    parser.add_argument("--output", default="", help="also write the report to this JSON file")
    return parser.parse_args(argv)


def main(argv=None, model: Optional[Styl3rModel] = None) -> Dict[str, object]:
    """Times every stage, prints the report as the last line and returns
    it. `model`, if given, is profiled in place of the one the flags build
    (its widths must be the flags')."""
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    impl = resolve_impl(args.impl, dev)
    no_tf32()
    dims = TINY if args.tiny else {}
    h = w = 64 if args.tiny else args.size
    b, v = args.batch, args.views
    if model is None:
        model = serving_model(dev, dims)
    batch = example_batch(np.random.default_rng(0), b=b, v=v, h=h, w=w, t=1, style_hw=h, device=dev)
    render_kwargs = dict(max_per_tile=args.max_per_tile or (512 if args.tiny else 2048), max_tiles_per_gaussian=8)
    if args.pair_cap:
        render_kwargs["pair_cap_per_gaussian"] = args.pair_cap
    mpt, m = render_kwargs["max_per_tile"], render_kwargs["max_tiles_per_gaussian"]
    enc = model.encoder
    imgs = normalize_images(batch.context_images)
    style = normalize_images(batch.style_image)
    k = batch.context_intrinsics
    results: Dict[str, float] = {}

    def record(name: str, fn: Callable[[Tensor], object], x0: Tensor, grad: bool = False):
        """fn(x) on x = x0 + the previous call's output, --iters times back
        to back; with `grad` x is a leaf that requires a gradient."""
        def step(carry):
            x = x0 + carry
            if grad:
                x = x.detach().requires_grad_()
            return carry * 0.5 + first_float(fn(x)).detach() * 1e-12

        with torch.set_grad_enabled(grad):
            results[name] = back_to_back_ms(step, args.iters, dev)
        print(f"{name}: {results[name] / b:.3f} ms/scene", flush=True)

    def backbone(x):
        with compute_in(enc.backbone_dtype, enc.backbone.dtype, dev.type):
            return enc.backbone(x, k)

    def backbone_stylizer(x):
        with compute_in(enc.backbone_dtype, enc.backbone.dtype, dev.type):
            enc_feat, enc_pos, _ = enc.backbone(x, k)
            return enc.token_stylizer(style, enc_feat, enc_pos)

    with torch.inference_mode(), route(impl):
        # -- encoder slices ------------------------------------------------
        record("backbone", backbone, imgs)
        record("backbone+stylizer", backbone_stylizer, imgs)
        record("predict (enc+sty+heads+adapter)", lambda x: enc(x, k, style), imgs)
    with torch.no_grad():  # not inference tensors: the backward slices save them
        gaussians = model.predict_gaussians(batch)

    # -- render slices: the first scene's Gaussians into its first target --
    gy, gx = h // TILE, w // TILE
    n_tiles = gy * gx
    cam = make_raster_camera(batch.target_extrinsics[0, :1], batch.target_intrinsics[0, :1],
                             batch.target_near[0, :1], batch.target_far[0, :1], (h, w))
    means, shs = gaussians.means[:1].float(), gaussians.harmonics[:1].float()
    scales, rots, opas = gaussians.scales[:1].float(), gaussians.rotations[:1].float(), gaussians.opacities[:1].float()

    def project(mns):
        return project_gaussians(cam, mns, scales=scales, rotations=rots)

    def project_bin_sort(mns):
        proj = project(mns)
        pair_tiles, pair_depths, pair_gidx = _build_pairs(proj.mean_x, proj.mean_y, proj.radii, proj.depths,
                                                          proj.mask, (gy, gx), m, opacities=opas)
        _, sorted_gidx, starts, _ = _sort_pairs(pair_tiles.reshape(-1), pair_depths.reshape(-1),
                                                pair_gidx.reshape(-1), n_tiles)
        return starts.float().sum() + sorted_gidx.float().sum()

    def bin_pairs(proj, op):
        return _build_pairs(proj.mean_x, proj.mean_y, proj.radii, proj.depths, proj.mask, (gy, gx), m,
                            opacities=op, con_a=proj.con_a, con_b=proj.con_b, con_c=proj.con_c)

    with torch.no_grad():  # the kernel slices' inputs, one bin and sort for all
        proj0 = project(means)
        pairs = bin_pairs(proj0, opas)
        _, sgidx, starts0, ends0 = _sort_pairs(*(x.reshape(-1) for x in pairs), n_tiles)
        counts0 = torch.clamp(ends0 - starts0, max=mpt)
        live0 = int(ends0[-1])  # the invalid slots sort last
        dirs0 = means - cam.cam_pos[:, None, :]
        dirs0 = dirs0 / torch.clamp(torch.linalg.norm(dirs0, dim=-1, keepdim=True), min=1e-8)
        rest0 = (proj0.mean_y[0], proj0.con_a[0], proj0.con_b[0], proj0.con_c[0], opas[0],
                 eval_sh(shs, dirs0)[0], proj0.depths[0], sgidx)
        attrs0 = composite.pack_attrs(proj0.mean_x[0], *rest0)
        bg0 = torch.zeros(1, 3, device=dev)
    print(f"[kernel slices] pairs in tiles: {live0} / {pairs[0].numel()}; counts: "
          f"mean {float(counts0.float().mean()):.0f} max {int(counts0.max())}", flush=True)

    with torch.inference_mode(), route(impl):
        record("project+bin+sort", project_bin_sort, means)
        record("project only", project, means)
        record("project+bin (no sort)", lambda mns: bin_pairs(project(mns), opas)[1], means)
        record("pack_attrs (gather)", lambda mx: composite.pack_attrs(mx, *rest0), proj0.mean_x[0])
        record("composite kernel only",
               lambda a: composite.composite_tiles(a, starts0, counts0, bg0, (gy, gx), mpt, 1).color, attrs0)

        def render(mns):
            return render_gaussians(gaussians._replace(means=mns), batch.target_extrinsics,
                                    batch.target_intrinsics, batch.target_near, batch.target_far, (h, w),
                                    **render_kwargs).color

        record("render (proj+sort+composite)", render, gaussians.means)
        record("full forward", lambda x: model(batch._replace(context_images=x), (h, w), **render_kwargs)[1].color,
               batch.context_images)

    # -- backward slices ---------------------------------------------------
    fields = {f: getattr(gaussians, f).detach().clone().requires_grad_()
              for f in ("covariances", "harmonics", "opacities", "scales", "rotations")}

    def render_grad(mns):
        out = render_gaussians(gaussians._replace(means=mns, **fields), batch.target_extrinsics,
                               batch.target_intrinsics, batch.target_near, batch.target_far, (h, w),
                               **render_kwargs)
        loss = (out.color**2).sum()
        return loss, torch.autograd.grad(loss, (mns, *fields.values()), allow_unused=True)

    def composite_grad(a):
        out = composite.composite_tiles_diff(a, starts0, counts0, bg0, (gy, gx), mpt, 1)
        loss = (out.color**2).sum() + (out.depth**2).sum()
        return loss, torch.autograd.grad(loss, a)

    def pack_grad(mx):
        # Over the live rows: the slots past them may gather culled
        # Gaussians' unbounded conics. The gather and its index_add_ still
        # run over every slot.
        loss = (composite.pack_attrs(mx, *rest0)[:live0] ** 2).sum()
        return loss, torch.autograd.grad(loss, mx)

    with route(impl):
        record("bwd:render fwd+bwd", render_grad, gaussians.means.detach(), grad=True)
        record("bwd:composite kernel fwd+bwd", composite_grad, attrs0, grad=True)
        record("bwd:pack_attrs fwd+bwd (gather+scatter)", pack_grad, proj0.mean_x[0], grad=True)
    # Last: the profiler's tracing would slow the timings after it.
    with torch.inference_mode(), route(impl):
        breakdown = device_breakdown(lambda: model(batch, (h, w), **render_kwargs), BREAKDOWN_REPS)
        syncs = host_syncs(lambda: model(batch, (h, w), **render_kwargs))

    derived = {
        "stylizer": results["backbone+stylizer"] - results["backbone"],
        "heads+adapter": results["predict (enc+sty+heads+adapter)"] - results["backbone+stylizer"],
        "composite": results["render (proj+sort+composite)"] - results["project+bin+sort"],
    }
    fwd_flops = flops.styl3r_forward_flops(
        b=b, v=v, h=h, w=w, style_hw=h, n_targets=1, **flops_dims(dims),
        pair_cap_per_gaussian=render_kwargs.get("pair_cap_per_gaussian", m),
    )
    util = flops.mfu(fwd_flops["total"], results["full forward"] / 1e3)
    on_card = dev.type == "cuda"
    report = {
        "config": {"views": v, "batch": b, "size": h, "impl": impl, "route": route_name(impl), "tiny": args.tiny,
                   "iters": args.iters, **render_kwargs},
        "per_scene_ms": {name: t / b for name, t in results.items()},
        "derived_ms": {name: t / b for name, t in derived.items()},
        "scenes_per_sec": b / (results["full forward"] / 1e3),
        "mfu": {
            "tflops": util["tflops"],
            "peak_tflops": util["peak_tflops"] if on_card else None,
            "mfu": util["mfu"] if on_card else None,
            "model_gflops": round(fwd_flops["total"] / 1e9, 1),
            "breakdown_gflops": {name: round(x / 1e9, 1) for name, x in fwd_flops.items()},
        },
        "absent": [{"name": name, "reason": reason} for name, reason in ABSENT.items()],
        "device_breakdown": breakdown,
        "host_syncs": syncs,
        **device_names(dev),
    }
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps(report, indent=2))
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
