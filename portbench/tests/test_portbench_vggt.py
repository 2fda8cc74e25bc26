"""The VGGT cell's pieces on the CPU at tiny widths: the driver's run and
its calibration readings, the FLOP count against torch's counter, the
frozen reference against its source, and the cell's metric readers."""

from __future__ import annotations

import copy
from pathlib import Path

import torch

from portbench import run
from portbench.counts import vggt as counts
from portbench.drivers import serve_frames

from .conftest import bench, context

CELL = "vggt.serve-32f518"
TINY = dict(img_size=28, embed_dim=32, depth=2, num_heads=2, patch_embed_depth=2, camera_trunk_depth=2,
            head_features=16, head_out_channels=[8, 8, 16, 16], head_layers=[0, 1, 1, 1], frames_chunk_size=2)


def tiny_cell(frames=3):
    entry, wl, cfg = run.cell_files(CELL, bench())
    wl, cfg = copy.deepcopy(wl), copy.deepcopy(cfg)
    cfg["widths"].update(TINY)
    cfg["precision"]["aggregator_dtype"] = "float32"
    wl["traffic_parameters"].update(frames=frames, height=28, width=42, pool=2)
    wl["check"]["sample_among"] = 2
    wl["warmup"] = 1
    return entry, wl, cfg


def test_a_run_on_the_cpu_is_correct_and_reports_latency():
    _, wl, cfg = tiny_cell()
    out = serve_frames.run(context(CELL, wl, cfg, seconds=0.3))
    assert out.attempted >= 1 and out.failed == 0 and out.end_to_end["latency_p95_ms"] > 0
    assert set(out.checks) == {"pose_rel_l2", "depth_rel_l2", "points_rel_l2", "conf_rel_l2"}
    assert all(v < 1e-4 for v, _ in out.checks.values()), out.checks
    assert run.reader("latency_p50_ms.vggt")(out.record) > 0
    assert run.reader("mfu.vggt")(out.record) > 0
    for name in ("global_blocks_ms.vggt", "attention_roofline.vggt", "device_idle_share.vggt"):
        assert run.reader(name)(out.record) is None  # no profiled slice on the CPU


def test_the_control_reads_farther_from_the_reference_than_the_program():
    _, wl, cfg = tiny_cell(frames=2)
    rows = serve_frames.readings(context(CELL, wl, cfg), [5], [5], last_index=3)
    program, control = rows
    assert program["kind"] == "program" and control["kind"] == "control"
    for key in ("pose_rel_l2", "depth_rel_l2", "points_rel_l2"):
        assert control[key] > 100 * max(program[key], 1e-9), (key, program, control)


def test_the_flop_count_matches_torchs_counter_outside_attention():
    from torch.utils.flop_counter import FlopCounterMode

    from styl3r_tpu_torch.models.vggt import VGGT

    _, _, cfg = tiny_cell()
    w = serve_frames.widths(cfg)
    model = VGGT(**w).requires_grad_(False)
    for s, h, width in ((3, 28, 42), (2, 42, 56)):
        with torch.inference_mode(), FlopCounterMode(display=False) as fc:
            model(torch.rand(1, s, 3, h, width))
        want = counts.forward_flops(w, 1, s, h, width)
        # The counter leaves out SDPA's CPU kernel; everything else agrees.
        assert fc.get_total_flops() == want["total"] - want["attention"]
    full = counts.forward_flops(serve_frames.widths(run.cell_files(CELL, bench())[2]), 1, 32, 392, 518)
    assert 108e12 < full["global_blocks"] - 24 * 2 * 33312 * 12 * 1024**2 < 110e12  # 4 N^2 C over 24 layers


def test_the_frozen_reference_is_the_tests_reference():
    root = Path(__file__).resolve().parents[2]
    frozen = (root / "portbench" / "reference" / "vggt.py").read_text()
    source = (root / "tests" / "vggt_reference.py").read_text()
    assert frozen.split("\n\n", 1)[1] == source[3:]
