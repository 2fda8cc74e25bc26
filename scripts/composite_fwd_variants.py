#!/usr/bin/env python3
"""Time builds of the forward compositor kernel on one NVIDIA GPU.

    python3 scripts/composite_fwd_variants.py [--baseline DIR]

Builds styl3r_tpu_torch/csrc/composite_fwd.cu as the repo builds it and
with other values of its build-time constants (-D COMPOSITE_FWD_CHUNKS,
threads a pixel, and COMPOSITE_FWD_SPLIT, blocks a tile) and of its
register cap (-maxrregcount in cuda_build.KERNELS). With
--baseline, also the composite_fwd.cu of another checkout of the repo (an
earlier commit, say), built with that checkout's own nvcc flags. Every
build runs through composite.composite_tiles, the wrapper the port calls,
with its library bound in place of the repo's (cuda_build.bind).

Each build is held against composite_tiles_plain (n_done equal, values
within chip_smoke.TOL, two calls bitwise equal) and timed on chip_smoke.py's
three forward inputs (the dense cloud, the serving path's own inputs and
the stage-1 training path's own inputs) and on each input's heaviest tile
alone (every other count set to 0), which says whether that tile's chain
sets the time. Call times (CUDA events, median of 20) come first, in the
order A B ... B A; device times (bench/timing.py's kernel_device_ms: torch.profiler,
mean of 20, with the launch shape from its trace) after them, in the same
order, because the profiler stays attached and slows later launches. The
last line is a JSON object with every number.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, -D defines, whether the repo's register cap stays) of each build of
# this checkout's source, the repo's own first.
VARIANTS = (
    ("kept", (), True),
    ("K=4, 8 blocks a tile", ("COMPOSITE_FWD_CHUNKS=4",), True),
    ("K=4, 1 block a tile", ("COMPOSITE_FWD_CHUNKS=4", "COMPOSITE_FWD_SPLIT=1"), True),
    ("K=2, 1 block a tile", ("COMPOSITE_FWD_CHUNKS=2", "COMPOSITE_FWD_SPLIT=1"), True),
    ("K=8, 4 blocks a tile", ("COMPOSITE_FWD_SPLIT=4",), True),
    ("K=8, 2 blocks a tile", ("COMPOSITE_FWD_SPLIT=2",), True),
    ("no register cap", (), False),
)


def sources(baseline):
    """{name: (source path, nvcc flags)} of every build."""
    from styl3r_tpu_torch.utils import cuda_build

    src = str(cuda_build.CSRC / "composite_fwd.cu")
    builds = {}
    for name, defines, capped in VARIANTS:
        flags = [f for f in cuda_build.nvcc_flags("composite_fwd") if capped or not f.startswith("-maxrregcount")]
        builds[name] = (src, (*flags, *(f"-D{d}" for d in defines)))
    if baseline:
        spec = importlib.util.spec_from_file_location(
            "baseline_cuda_build", os.path.join(baseline, "styl3r_tpu_torch", "utils", "cuda_build.py"))
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
        builds["baseline"] = (str(other.CSRC / "composite_fwd.cu"), other.nvcc_flags("composite_fwd"))
    return builds


def build(builds, out_dir):
    """Compiles every build at once; returns {name: library path}."""
    from styl3r_tpu_torch.utils import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, (src, flags)) in enumerate(builds.items()):
        so = os.path.join(out_dir, f"libcomposite_fwd_variant{i}.so")
        cmd = [cuda_build.nvcc_path(), *flags, "-o", so, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        built[name] = so
    return built


def use(so):
    """Makes composite.composite_tiles launch the library `so`'s kernel."""
    from styl3r_tpu_torch.utils import cuda_build

    cuda_build.bind("composite_fwd", so)


def check(args):
    """composite_tiles as now bound against the plain version: the largest
    error (depth over its scale); raises where they disagree."""
    import torch

    import chip_smoke as cs
    from styl3r_tpu_torch.ops.rasterizer import composite

    out, again = composite.composite_tiles(*args), composite.composite_tiles(*args)
    plain = composite.composite_tiles_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(out.n_done, plain.n_done):
        raise AssertionError("n_done differs from the plain version")
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError("two calls differ")
    scale = max(1.0, float(plain.depth.abs().max()))
    err = 0.0
    for name in ("color", "alpha", "t_final", "depth"):
        e = float((getattr(out, name) - getattr(plain, name)).abs().max()) / (scale if name == "depth" else 1.0)
        if e > cs.TOL:
            raise AssertionError(f"{name} differs from the plain version by {e}")
        err = max(err, e)
    return err


def forward_inputs(dev):
    """chip_smoke.py's three forward inputs, by name."""
    import torch

    import chip_smoke as cs
    from styl3r_tpu_torch.models.styl3r import Styl3rModel
    from styl3r_tpu_torch.train.scratch_init import scratch_init_heads

    hw = (256, 256)
    inputs = {"dense cloud": cs.dense_cloud_inputs(dev)}
    with torch.inference_mode():
        model = Styl3rModel(sh_degree=0, backbone_dtype=torch.bfloat16, head_trunk_dtype=torch.bfloat16,
                            device=dev, seed=0).cast_dtypes()
        batch = cs.example_batch(2, dev)
        serve_kwargs = dict(max_tiles_per_gaussian=8, max_per_tile=2048, pair_cap_per_gaussian=2)
        inputs["serving"] = cs.main_path_inputs(model.predict_gaussians(batch), *batch[2:6], hw, serve_kwargs)
    del model
    torch.cuda.empty_cache()
    model = Styl3rModel(sh_degree=0, backbone_dtype=torch.bfloat16, head_trunk_dtype=torch.bfloat16,
                        device=dev, seed=0)
    scratch_init_heads(model)
    train_batch = cs.example_batch(4, dev, b=2, targets=True)
    with torch.no_grad():
        g = model.predict_gaussians(train_batch._replace(style_image=train_batch.context_images[:, 0]))
        train_kwargs = dict(max_tiles_per_gaussian=8, max_per_tile=2048, pair_cap_per_gaussian=4)
        inputs["stage-1"] = cs.main_path_inputs(g, *train_batch[2:6], hw, train_kwargs)
    del model, g
    torch.cuda.empty_cache()
    return inputs


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="another checkout of the repo whose composite_fwd.cu is timed too")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("composite_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from styl3r_tpu_torch.bench.timing import card_line, cuda_ms, kernel_device_ms, log
    from styl3r_tpu_torch.ops.rasterizer import composite
    from styl3r_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)

    builds = sources(opts.baseline)
    kernels = build(builds, os.path.join(cuda_build.BUILD_DIR, "variants"))
    inputs = forward_inputs(dev)
    args = {what: (x.attrs, x.starts, x.counts, x.backgrounds, x.grid, 2048, x.n_views) for what, x in inputs.items()}
    use(kernels["kept"])
    for what in list(args):
        a = args[what]
        n_done = composite.composite_tiles(*a).n_done
        heavy = int(torch.argmax(n_done))
        counts = torch.zeros_like(a[2])
        counts[heavy] = a[2][heavy]
        args[f"{what}, heaviest tile alone"] = (a[0], a[1], counts, *a[3:])
        log(f"{what}: {int(inputs[what].live_pairs)} live pairs; tile {heavy} walks {int(n_done[heavy])} windows; "
            f"{cs.fwd_windows_line(cs.check_composite(inputs[what], 2048, reps=3))}")

    order = list(kernels) + list(reversed(kernels))
    result = {"card": card, "variants": {name: {"flags": list(builds[name][1]), "max_err": {}, "call_ms": {},
                                                "ms": {}, "launch": {}} for name in kernels}}
    with torch.no_grad():
        for name, so in kernels.items():
            use(so)
            for what, a in args.items():
                result["variants"][name]["max_err"][what] = check(a)
        for what, a in args.items():
            for name in order:
                use(kernels[name])
                result["variants"][name]["call_ms"].setdefault(what, []).append(
                    cuda_ms(lambda: composite.composite_tiles(*a), 20))
        for what, a in args.items():
            for name in order:
                use(kernels[name])
                ms, _, shapes = kernel_device_ms(lambda: composite.composite_tiles(*a), 20, ("composite_fwd_kernel",))
                result["variants"][name]["ms"].setdefault(what, []).append(ms)
                result["variants"][name]["launch"][what] = shapes["composite_fwd_kernel"]
    for name, res in result["variants"].items():
        for what in res["ms"]:
            log(f"{name}, {what}: device {', '.join(f'{t:.4f}' for t in res['ms'][what])} ms; call "
                f"{', '.join(f'{t:.4f}' for t in res['call_ms'][what])} ms; launched as "
                f"{cs.shape_text(res['launch'][what])}; max err {res['max_err'][what]:.3g} [{card}]")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
