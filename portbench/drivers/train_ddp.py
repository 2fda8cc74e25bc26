"""Data-parallel training steps on W cards: train_step's stage-2 step,
built as train/trainer.py builds it under torchrun, with
styl3r_tpu_torch/parallel/mesh.py's gradient all-reduce. Rank 0 runs in
the harness's process on cuda:0; this driver starts ranks 1..W-1 as
processes of their own (`python3 -m portbench.drivers.train_ddp JOB`) on
cuda:1..W-1, joined over NCCL (gloo on the CPU) at a free localhost port.
Each rank holds the whole model and `batch_size` scenes of a global batch
of W * batch_size, drawn on the host from the seed and the step's index;
each draws the global batch's dropout masks and keeps its rows
(models/dpt.py::shard_dropout_).

Set-up drives the step through its first `first_steps` steps on every rank
(the warm-up) and keeps rank 0's readings, as train_step does, then
compares every rank's trained weights element by element. In the window
rank 0 tells the ranks to take each step (a broadcast) and times them;
every step ends in a synchronise on every rank.

End to end: `train_examples_per_s`, the global batch's examples of the
window's completed steps over its seconds. Traced run: a profiled slice of
`trace_steps` steps on rank 0, in which the program's `allreduce` span
records.

Check, after the window, with every rank gone: the reference (float32,
TF32 off) follows the first steps over the whole global batch, one scene at
a time with each scene's rows of the dropout draws (train_step.Reference),
and the readings are compared; `rank_weights_mismatch` counts the trained
weights on which the ranks differed after the warm-up."""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..core import Context, Outcome, free, limits_checks, synchronize
from ..scenes import draw, step_generator
from . import train_step

ROOT = Path(__file__).resolve().parents[2]
TIMEOUT = datetime.timedelta(minutes=5)  # a collective that waits longer ends the rank


def _die_with_parent() -> None:
    """A rank's process ends when rank 0's does (Linux's PR_SET_PDEATHSIG),
    so no rank outlives a run that stopped."""
    try:
        import ctypes
        import signal

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except OSError:
        pass


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def global_traffic(cfg: dict, wl: dict) -> dict:
    return dict(wl["traffic_parameters"], batch=cfg["batch_size"] * wl["ranks"])


class Rank:
    """One rank's process group, program and step loop."""

    def __init__(self, cfg: dict, wl: dict, rank: int, port: int, device: torch.device):
        from styl3r_tpu_torch.models.dpt import shard_dropout_
        from styl3r_tpu_torch.models.styl3r import batch_to
        from styl3r_tpu_torch.parallel.mesh import DataGroup, broadcast_params_
        from styl3r_tpu_torch.train.step import make_train_step

        self.rank, self.world, self.device = rank, wl["ranks"], device
        if device.type == "cuda":
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank,
                                    world_size=self.world, timeout=TIMEOUT, device_id=device)
        else:
            dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                    world_size=self.world, timeout=TIMEOUT)
        self.tr = global_traffic(cfg, wl)
        local = dict(wl, traffic_parameters=dict(self.tr, batch=cfg["batch_size"]))
        prog = train_step.Program(cfg, local, device)
        if prog.stage != "style":
            raise ValueError("train_ddp runs the stage-2 (style) step")
        lw = cfg["losses"]
        hw = (self.tr["size"], self.tr["size"])
        prog.step = make_train_step(prog.model, prog.optimizer, hw, loss_fn=lambda *a, **kw: prog.loss_call(*a, **kw),
                                    stylized=True, identity_branch=lw["identity"],
                                    data=DataGroup(rank, self.world), **train_step.render_kwargs(wl, device))
        shard_dropout_(prog.model, rank, self.world)
        broadcast_params_(prog.model)
        n = cfg["batch_size"]

        def batch(seed, k, _tr):  # this rank's rows of the global batch
            return batch_to(tuple(None if x is None else x[rank * n:(rank + 1) * n]
                                  for x in draw(seed, k, self.tr)), device)

        prog.batch = batch
        self.prog = prog
        self.flag = torch.zeros((), dtype=torch.int32, device=device)

    def step(self, seed: int, k: int) -> bool:
        prog = self.prog
        metrics = prog.step(prog.state, prog.batch(seed, k, self.tr), step_generator(seed, k, self.device))
        synchronize(self.device)
        return bool(metrics["live_pairs"] > metrics["pair_slots"])

    def order(self, value: int = 0) -> int:
        """Rank 0's order to the ranks: 1 takes a step, 0 ends the loop."""
        self.flag.fill_(value)
        dist.broadcast(self.flag, src=0)
        return int(self.flag)

    def weights_mismatch(self) -> int:
        """Trained weights on which any two ranks differ: each element's
        maximum and minimum over the ranks, compared."""
        bad = 0
        for p in self.prog.optimizer.params:
            x = p.detach().reshape(-1).float()
            hi, lo = x.clone(), x.clone()
            dist.all_reduce(hi, op=dist.ReduceOp.MAX)
            dist.all_reduce(lo, op=dist.ReduceOp.MIN)
            bad += int((hi != lo).sum())
        return bad

    def follow(self, seed: int, k: int) -> None:
        """A rank other than 0: steps while rank 0 orders them."""
        while self.order() == 1:
            self.step(seed, k)
            k += 1

    def close(self) -> None:
        dist.destroy_process_group()


def child(job_path: str) -> int:
    """Ranks 1..W-1: the warm-up, the weights' comparison, then the steps
    rank 0 orders."""
    job = json.loads(Path(job_path).read_text())
    rank = job["rank"]
    device = torch.device("cuda", rank) if job["device"] == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        from ..reference import lowprec

        lowprec.no_tf32()
    r = Rank(job["config"], job["workload"], rank, job["port"], device)
    train_step.first_steps(r.prog, job["seed"], r.tr, job["workload"]["first_steps"])
    r.weights_mismatch()
    r.follow(job["seed"], job["workload"]["first_steps"])
    r.close()
    return 0


def start_ranks(cfg: dict, wl: dict, seed: int, port: int, device: torch.device, tmp: str):
    procs = []
    for rank in range(1, wl["ranks"]):
        path = Path(tmp) / f"rank{rank}.json"
        path.write_text(json.dumps({"config": cfg, "workload": wl, "seed": seed, "port": port, "rank": rank,
                                    "device": device.type}))
        procs.append(subprocess.Popen([sys.executable, "-m", "portbench.drivers.train_ddp", str(path)], cwd=ROOT,
                                      env=dict(os.environ), preexec_fn=_die_with_parent))
    return procs


def run(ctx: Context) -> Outcome:
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    from ..reference import lowprec

    lowprec.no_tf32()
    if dev.type == "cuda":
        from styl3r_tpu_torch.utils import cuda_build

        cuda_build.build(cuda_build.KERNELS)  # once, before the ranks start
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_ranks(cfg, wl, ctx.seed, port, dev, tmp)
        try:
            r = Rank(cfg, wl, 0, port, dev)
            n_first = wl["first_steps"]
            readings = train_step.first_steps(r.prog, ctx.seed, r.tr, n_first)
            mismatch = r.weights_mismatch()
            ctx.setup_done()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            k, failed = n_first, 0
            t0 = time.perf_counter()
            while True:
                r.order(1)
                failed += r.step(ctx.seed, k)
                k += 1
                if time.perf_counter() - t0 >= ctx.seconds:
                    break
            window_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
            steps = k - n_first
            record = {"calls": steps, "window_s": window_s, "window_peak_bytes": peak}
            if ctx.trace and dev.type == "cuda":
                from ..core import profiled

                ks = iter(range(k, 10**9))
                record["trace"] = profiled(lambda: (r.order(1), r.step(ctx.seed, next(ks))), wl["trace_steps"])
                record["trace_calls"] = wl["trace_steps"]
            r.order(0)
            r.close()
            for p in procs:
                if p.wait(timeout=TIMEOUT.total_seconds()) != 0:
                    raise RuntimeError(f"a rank exited with {p.returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    del r
    free(dev)
    ref = train_step.Reference(cfg, wl, dev)
    values = train_step.compare(readings, ref.steps(ctx.seed, global_traffic(cfg, wl), n_first))
    values["rank_weights_mismatch"] = float(mismatch)
    ctx.log("check: " + ", ".join(f"{k}={values[k]}" for k in values if k not in train_step.NUMBERS))
    del ref
    free(dev)
    return Outcome(attempted=steps, failed=failed,
                   end_to_end={"train_examples_per_s": steps * cfg["batch_size"] * wl["ranks"] / window_s},
                   record=record, memory_peak_bytes=peak, checks=limits_checks(values, wl["check"]["limits"]))


def readings(ctx: Context, seeds, control_seeds, faults=()):
    """The control's readings on `control_seeds` over the global batch, on
    one card (portbench/calibrate.py); the program's readings come from the
    cell's own runs, which need every rank."""
    if seeds or faults:
        raise ValueError("train_ddp calibrates the control alone: pass --control-seeds only")
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    from ..reference import lowprec

    lowprec.no_tf32()
    tr = global_traffic(cfg, wl)
    out = []
    for seed in control_seeds:
        ref = train_step.Reference(cfg, wl, dev)
        truth = ref.steps(seed, tr, wl["first_steps"])
        ref.reset()
        got = ref.steps(seed, tr, wl["first_steps"], control=True)
        del ref
        free(dev)
        out.append(dict(kind="control", seed=seed, **train_step.compare(got, truth)))
        ctx.log(str(out[-1]))
    return out


if __name__ == "__main__":
    from ..run import set_cache_dirs

    set_cache_dirs()
    sys.exit(child(sys.argv[1]))
