"""The tracer of styl3r_tpu_torch/utils/trace.py on the CPU, with tiny
widths: off it records nothing and the counters count; under torch.profiler
a forward enters each of the encoder's and renderer's spans, nested in the
profiler's trace; under enabled() a stage-2 step and a stage-0 step enter
the step's spans once each; tracing changes no number; every span has a
reader; and bench/timing.py's trace_breakdown names an idle gap by its
span."""

import contextlib
import copy
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from styl3r_tpu_torch.bench import timing
from styl3r_tpu_torch.bench.batch import example_batch
from styl3r_tpu_torch.models.distiller import Dust3RTeacher
from styl3r_tpu_torch.models.styl3r import Styl3rModel
from styl3r_tpu_torch.models.vit import Attention, CrossAttention
from styl3r_tpu_torch.train.step import DistillCfg, TrainState, make_optimizer, make_stage2_optimizer, make_train_step
from styl3r_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(
    enc_depth=1, dec_depth=2, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2,
    head_feature_dim=16, head_last_dim=16, head_layer_dims=(8, 8, 16, 16),
)
HW = (32, 32)
RENDER = dict(max_tiles_per_gaussian=4, max_per_tile=128)
STEP_SPANS = {"forward", "backward", "clip", "adamw"}
# Spans no benchmark reader reads: the Trainer logs each as `<span>_ms`
# (tests/test_torch_trainer.py, test_torch_distill.py, test_torch_parallel.py).
# `allreduce` is logged too, and read by portbench's allreduce_ms.dp4.
TRAINER_LOGGED = {"encoder", "render", "teacher", "loss", "step"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the steps' small CPU ops oversubscribe the host
    under the Tier-1 command's 6 workers otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def model():
    return Styl3rModel(sh_degree=0, device="cpu", seed=0, **TINY)


def _batch(seed=0, b=1):
    return example_batch(np.random.default_rng(seed), b=b, v=2, h=HW[0], w=HW[1], t=2, style_hw=HW[0], device="cpu")


def _rope_calls(model, fn):
    """fn() and the calls of the attentions that apply RoPE during it."""
    calls = [0]

    def hook(*_):
        calls[0] += 1

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Attention, CrossAttention)) and m.rope_base is not None]
    try:
        out = fn()
    finally:
        for h in hooks:
            h.remove()
    return out, calls[0]


def test_off_records_nothing_and_the_counters_count(model):
    assert not trace.active()
    with torch.no_grad():
        model(_batch(), HW, **RENDER)
    assert trace.totals() == {} and trace.drain() == {}
    trace.count("composite_fwd")
    trace.count("composite_bwd", 2)
    assert trace.counters() == {"composite_fwd": 1, "composite_bwd": 2, "rope2d": 0, "conv3x3_f32": 0,
                                "encoder_calls": 0, "encoder_captures": 0, "encoder_replays": 0}
    with trace.span("not_a_span"):  # off: the name is not looked at
        pass
    with pytest.raises(ValueError):
        trace.count("not_a_counter")
    with trace.enabled(), pytest.raises(ValueError):
        trace.span("not_a_span")
    trace.reset()
    assert set(trace.counters().values()) == {0}


def test_profiler_records_each_layer_of_a_forward_nested_in_the_encoder(model, tmp_path):
    batch = _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.active()
        with torch.no_grad():
            _, ropes = _rope_calls(model, lambda: model(batch, HW, **RENDER))
    assert not trace.active()
    entries = {name: n for name, (_, n) in trace.totals().items()}
    assert ropes > 0
    assert entries == {"encoder": 1, "backbone": 1, "stylizer": 1, "heads": 2, "adapter": 1, "rope": ropes,
                       "render": 1, "sort": 1, "pack": 1}
    ms = {name: t for name, (t, _) in trace.totals().items()}
    assert ms["encoder"] >= ms["backbone"] + ms["stylizer"] + ms["heads"] + ms["adapter"] > 0
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation" and e.get("name", "").startswith(trace.PREFIX)]
    encoder = [e for e in ranges if e["name"] == "styl3r/encoder"]
    assert len(encoder) == 1
    start, end = encoder[0]["ts"], encoder[0]["ts"] + encoder[0]["dur"]
    inside = {e["name"] for e in ranges if start <= e["ts"] and e["ts"] + e["dur"] <= end and e is not encoder[0]}
    assert inside == {f"styl3r/{n}" for n in ("backbone", "stylizer", "heads", "adapter", "rope")}
    assert {e["name"] for e in ranges} - inside - {"styl3r/encoder"} == {"styl3r/render", "styl3r/sort", "styl3r/pack"}


def _stage2_step(model):
    """A stage-2 step with the identity branch (the stylizer-only optimizer;
    MSE on both branches' renders in place of the VGG losses)."""
    def loss_fn(output, batch, gaussians, global_step=0, identity_output=None):
        loss = ((output.color - batch.target_images) ** 2).mean() + (identity_output.color ** 2).mean()
        return loss, {}

    optimizer = make_stage2_optimizer(model, warmup_steps=0)
    return make_train_step(model, optimizer, HW, loss_fn=loss_fn, stylized=True, identity_branch=True, **RENDER)


def _stage0_step(model, teacher):
    optimizer = make_optimizer(model, warmup_steps=0)
    return make_train_step(model, optimizer, HW, loss_fn=None, stylized=False,
                           distill=DistillCfg(teacher=teacher, distill_only=True), **RENDER)


def _take(step, n=1):
    state = TrainState()
    for k in range(n):
        step(state, _batch(seed=k), torch.Generator().manual_seed(k))


@pytest.mark.parametrize("stage", ["stage2", "stage0"])
def test_enabled_records_the_step_spans_once_a_step(model, stage):
    student = copy.deepcopy(model)
    if stage == "stage2":
        step, expected = _stage2_step(student), STEP_SPANS | {"loss"}
    else:
        step, expected = _stage0_step(student, Dust3RTeacher(**dict(TINY, head_last_dim=8))), STEP_SPANS | {"teacher"}
    with trace.enabled():
        assert trace.active()
        _take(step, 2)
    totals = trace.drain()
    assert {name: totals[name][1] for name in expected} == dict.fromkeys(expected, 2)
    assert not {"teacher", "loss"} - expected & totals.keys()
    assert all(ms >= 0 for ms, _ in totals.values())
    assert totals["forward"][0] >= totals["encoder"][0] > 0
    # Stage 2 renders twice a step (the identity branch), stage 0 not at all.
    assert totals.get("render", (0, 0))[1] == (4 if stage == "stage2" else 0)
    assert trace.totals() == {}
    _take(step)
    assert trace.totals() == {}  # off again


def test_tracing_changes_no_number(model):
    batch = _batch(seed=3)
    with torch.no_grad():
        off = model(batch, HW, **RENDER)
        with trace.enabled():
            on = model(batch, HW, **RENDER)
    for a, b in zip([*off[0], *off[1]], [*on[0], *on[1]]):
        assert (a is None and b is None) or torch.equal(a, b)
    trained = []
    for traced in (False, True):
        student = copy.deepcopy(model)
        with trace.enabled() if traced else contextlib.nullcontext():
            _take(_stage2_step(student))
        trained.append([p.detach().clone() for p in student.parameters()])
    assert trace.totals()  # the traced step recorded
    assert all(torch.equal(a, b) for a, b in zip(*trained))


def test_every_span_has_its_reader():
    read = set()
    for path in (ROOT / "portbench" / "metrics").glob("*.py"):
        read |= set(re.findall(r'span_ms\(record, "(\w+)"\)', path.read_text()))
    assert read <= set(trace.SPANS), read - set(trace.SPANS)
    assert set(trace.SPANS) - read == TRAINER_LOGGED
    assert len(set(trace.SPANS)) == len(trace.SPANS) and len(set(trace.COUNTERS)) == len(trace.COUNTERS)


@pytest.mark.parametrize("metric", ["encoder_replay_share.serve", "encoder_replay_share.batch"])
def test_the_replay_share_readers_read_the_encoder_counters(metric, monkeypatch):
    """None where the program keeps no encoder counters (a program before
    them) or ran no encoder forward on the card; else 100 x replays over
    calls."""
    from portbench import run

    read = run.reader(metric)
    kernels_only = {name: 0 for name in trace.COUNTERS if not name.startswith("encoder_")}
    for counts, want in ((kernels_only, None),
                         (dict(kernels_only, encoder_calls=0, encoder_captures=0, encoder_replays=0), None),
                         (dict(kernels_only, encoder_calls=8, encoder_captures=1, encoder_replays=6), 75.0)):
        monkeypatch.setattr(trace, "counters", lambda counts=counts: dict(counts))
        assert read({}) == want


def test_trace_breakdown_names_a_gap_by_its_span():
    """Kernels at [0, 10], [30, 40], [60, 70] and [200, 210] us; the
    encoder's range covers the first three, the backbone's the first gap,
    and nothing of ours the last."""
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        x("user_annotation", "styl3r/encoder", -5, 80), x("user_annotation", "styl3r/backbone", -2, 40),
        x("user_annotation", "ProfilerStep#1", -10, 300), x("cpu_op", "aten::add", 12, 15),
        x("kernel", "k", 0, 10), x("kernel", "k", 30, 10), x("kernel", "k", 60, 10), x("kernel", "k", 200, 10),
    ]
    gaps = timing.trace_breakdown(events, calls=1)["gaps"]
    assert gaps == [{"ms": 130 / 1e3, "host_op": None, "span": None},
                    {"ms": 20 / 1e3, "host_op": "aten::add", "span": "backbone"},
                    {"ms": 20 / 1e3, "host_op": None, "span": "encoder"}]
