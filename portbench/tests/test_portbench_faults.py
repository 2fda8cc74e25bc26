"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have, while a sound run comes out correct. The runs
skip the harness's look for a card and drive the rest of a run on the CPU
at tiny widths in float32, held to the workload files' own limits."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.drivers import serve_closed, train_step

from .conftest import bench, context, tiny_cell

SERVING = ["styl3r.serve-2v256", "styl3r.batch-b8-2v256"]


def serve_result(cell, program_request=None):
    entry, wl, cfg = tiny_cell(cell, batch=2) if "batch" in cell else tiny_cell(cell)
    ctx = context(cell, wl, cfg)
    return run.result_of(ctx, serve_closed.run(ctx, program_request=program_request), bench(), entry)


@pytest.mark.parametrize("cell", SERVING)
def test_a_sound_serving_run_is_correct(cell):
    result = serve_result(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


def altered_render(model, hw, render, device):
    """An answer altered where it is produced: the compositor's colors
    brightened by 1%."""
    from styl3r_tpu_torch.ops.rasterizer import composite

    sound = serve_closed.make_request(model, hw, render, device)
    plain = composite.composite_tiles

    def request(arrays):
        composite.composite_tiles = lambda *a: plain(*a)._replace(color=plain(*a).color * 1.01)
        try:
            return sound(arrays)
        finally:
            composite.composite_tiles = plain

    return request


def half_batch(model, hw, render, device):
    """Half of the batch left out: the forward serves the first half of the
    scenes and repeats its answers for the rest."""
    sound = serve_closed.make_request(model, hw, render, device)

    def request(arrays):
        b = arrays[0].shape[0]
        gaussians, rendered, dropped = sound(tuple(None if x is None else x[: b // 2] for x in arrays))
        return (type(gaussians)(*(None if x is None else x.repeat(2, *[1] * (x.dim() - 1)) for x in gaussians)),
                tuple(x.repeat(2, *[1] * (x.dim() - 1)) for x in rendered), dropped)

    return request


@pytest.mark.parametrize("cell", SERVING)
def test_an_answer_altered_where_it_is_produced_is_caught(cell):
    result = serve_result(cell, altered_render)
    assert not result["correct"]
    assert result["checks"]["render_rel_l2"]["value"] > result["checks"]["render_rel_l2"]["limit"]


def test_half_of_the_batch_left_out_is_caught():
    result = serve_result("styl3r.batch-b8-2v256", half_batch)
    assert not result["correct"], result["checks"]


TRAINING = ["mast3r-distill.stage0-2v256", "styl3r.train-style-3v256"]


def train_result(cell, fault=None):
    entry, wl, cfg = tiny_cell(cell)
    ctx = context(cell, wl, cfg)
    return run.result_of(ctx, train_step.run(ctx, fault=fault), bench(), entry)


@pytest.mark.parametrize("cell", TRAINING)
def test_a_sound_training_run_is_correct(cell):
    result = train_result(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAINING
                                        for f in train_step.STAGE_FAULTS[tiny_cell(c)[2]["stage"]]])
def test_a_training_fault_is_caught(cell, fault):
    result = train_result(cell, train_step.FAULTS[fault])
    assert not result["correct"], (fault, result["checks"])


@pytest.mark.parametrize("cell", TRAINING)
def test_a_step_that_leaves_its_state_unchanged_reads_one(cell):
    _, wl, cfg = tiny_cell(cell)
    ctx = context(cell, wl, cfg)
    tr = train_step.traffic(ctx)
    prog = train_step.Program(cfg, dict(wl, traffic_parameters=tr), torch.device("cpu"))
    train_step.FAULTS["unchanged"](prog)
    got = train_step.first_steps(prog, 4, tr, 3)
    want = train_step.Reference(cfg, wl, torch.device("cpu")).steps(4, tr, 3)
    assert train_step.compare(got, want)["delta_leaf_gap"] == pytest.approx(1.0)
