#!/usr/bin/env python3
"""Where the time of the distillation teacher's forward goes, on one NVIDIA
GPU.

    python3 scripts/profile_teacher.py [--batch 2] [--size 256] [--iters 5]

Builds the full-width Dust3RTeacher (f32 weights, random from a seed, drawn
on the card) and runs its forward on `--batch` pairs of views at size^2, as
the trainer does, then prints:
  * the time of its backbone and of each head (CUDA events recorded by
    module hooks) and of the whole call (CUDA events), median of `--iters`
    warm calls, in f32 with TF32 off (the trainer's f32 policy), the same
    with cudnn.benchmark (cuDNN times its algorithms and keeps the fastest),
    and with TF32 allowed in matmuls and convolutions;
  * the convolutions of one head that take the most time with TF32 off
    (CUDA events around each, median of `--iters` calls), with their shapes,
    and the slowest one alone in NCHW and channels-last layouts, TF32 off
    and on;
  * from torch.profiler over `--iters` more TF32-off calls: the device time
    per call, its share of the profiled window, and the kernels that take
    the most device time.
"""

import argparse
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def timed_calls(teacher, images, iters):
    """Median ms of the whole call and of each top-level module, from CUDA
    events, over `iters` calls after 2 warm ones."""
    events, hooks = {}, []
    for name, mod in teacher.named_children():
        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.setdefault(name, []).append([ev, None])

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev

        hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    calls = []
    try:
        with torch.no_grad():
            for i in range(iters + 2):
                events.clear()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                teacher(images)
                end.record()
                torch.cuda.synchronize()
                if i >= 2:
                    calls.append({"call": start.elapsed_time(end),
                                  **{k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()}})
    finally:
        for h in hooks:
            h.remove()
    return {k: statistics.median(c[k] for c in calls) for k in calls[0]}


def conv_times(head, teacher, images, iters):
    """Median ms of each convolution of `head` over `iters` teacher calls
    after 2 warm ones: [(ms, name, weight shape, input shape)]."""
    events, shapes, hooks = {}, {}, []
    for name, mod in head.named_modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            def pre(m, a, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.setdefault(name, []).append([ev, None])
                shapes[name] = (tuple(m.weight.shape), tuple(a[0].shape))

            def post(_m, _a, _o, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events[name][-1][1] = ev

            hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    samples = {}
    try:
        with torch.no_grad():
            for i in range(iters + 2):
                events.clear()
                teacher(images)
                torch.cuda.synchronize()
                if i >= 2:
                    for k, v in events.items():
                        samples.setdefault(k, []).append(sum(a.elapsed_time(b) for a, b in v))
    finally:
        for h in hooks:
            h.remove()
    return sorted(((statistics.median(v), k, *shapes[k]) for k, v in samples.items()), reverse=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_teacher: no CUDA device", file=sys.stderr)
        return 1
    from styl3r_tpu_torch.models.distiller import Dust3RTeacher
    from styl3r_tpu_torch.utils.convert import init_like_flax_

    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    with dev:
        teacher = Dust3RTeacher()
    init_like_flax_(teacher, torch.Generator(dev).manual_seed(2)).freeze()
    images = torch.rand(args.batch, 2, args.size, args.size, 3, generator=torch.Generator(dev).manual_seed(0),
                        device=dev) * 2 - 1
    n = sum(p.numel() for p in teacher.parameters())
    print(f"teacher: {n:,} parameters, f32; input {tuple(images.shape)} [{card}]", flush=True)

    for what, tf32, benchmark in (("TF32 off", False, False), ("TF32 off, cudnn.benchmark", False, True),
                                  ("TF32 on", True, False)):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cudnn.benchmark = benchmark
        times = timed_calls(teacher, images, args.iters)
        parts = ", ".join(f"{k} {v:.2f}" for k, v in times.items() if k != "call")
        print(f"forward, {what}: {times['call']:.2f} ms a call ({parts}; CUDA events, median of {args.iters}) "
              f"[{card}]", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    print("downstream_head1's slowest convolutions, TF32 off (ms a call; weight shape, input shape):")
    slowest = conv_times(teacher.downstream_head1, teacher, images, args.iters)
    for ms, name, weight, shape in slowest[:6]:
        print(f"  {ms:9.3f} ms  {name}  weight {weight}  input {shape}")
    _, name, _, shape = slowest[0]
    conv = teacher.downstream_head1.get_submodule(name)
    x = torch.randn(shape, device=dev)
    for layout in ("NCHW", "channels_last"):
        fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
        xl, cl = x.to(memory_format=fmt), conv.to(memory_format=fmt)
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.no_grad():
                ms = chip_smoke.cuda_ms(lambda: cl(xl), args.iters)
            print(f"{name} alone, {layout}, TF32 {'on' if tf32 else 'off'}: {ms:.3f} ms (CUDA events, median of "
                  f"{args.iters}) [{card}]", flush=True)
    conv.to(memory_format=torch.contiguous_format)
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            teacher(images)
        end.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(end)
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    print(f"profiler, TF32 off: {device_ms / args.iters:.2f} ms of device time a call over {launches // args.iters} "
          f"kernel launches, {device_ms / window:.3f} of the {window / args.iters:.2f} ms window a call "
          f"[{card}]", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3 / args.iters:9.3f} ms a call  {e.count // args.iters:5d} "
              f"launches  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
