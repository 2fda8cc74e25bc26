"""Shared fixtures of the benchmark's tests: tiny widths on the CPU, and
the card check of the tests marked `cuda`."""

from __future__ import annotations

import copy
import os
import time

import pytest
import torch

from portbench import run
from portbench.core import Context

# Under pytest-xdist each worker gets its share of the cores: the tests'
# small CPU ops slow down many times over when the workers' thread pools
# oversubscribe the host.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TINY = dict(enc_depth=2, dec_depth=4, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2, head_feature_dim=16,
            head_last_dim=16, head_layer_dims=[8, 8, 16, 16], patch_size=16)


@pytest.fixture
def card():
    """Skips a test marked `cuda` where no CUDA device is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def bench():
    return run.load_json(run.ROOT / "BENCHMARK.json")


def tiny_cell(cell: str, dtype: str = "float32", **traffic):
    """A cell's workload and configuration at tiny widths and 32x32 images
    for the CPU, computing in `dtype`; the workload file's limits stand."""
    entry, wl, cfg = run.cell_files(cell, bench())
    wl, cfg = copy.deepcopy(wl), copy.deepcopy(cfg)
    cfg["widths"] = dict(TINY)
    if "teacher" in cfg:
        cfg["teacher"]["widths"] = dict(TINY)
    if "batch_size" in cfg:
        cfg["batch_size"] = 2
    if "serve" in cfg:
        cfg["serve"] = {"compute_dtype": dtype, "storage_dtype": dtype}
    cfg["train"]["backbone_dtype"] = dtype
    wl["traffic_parameters"].update(size=32, style_size=32, **traffic)
    if "pool" in wl["traffic_parameters"]:
        wl["traffic_parameters"]["pool"] = 2
    if "render" in wl:
        wl["render"]["max_per_tile"] = 256
    if "sample_among" in wl.get("check", {}):
        wl["check"]["sample_among"] = 2
    return entry, wl, cfg


def context(cell, wl, cfg, seed=2**31 + 77, seconds=0.5, trace=False):
    return Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"), config=cfg,
                   workload=wl, t_start=time.perf_counter(), log=lambda m: None)
