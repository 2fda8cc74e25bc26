"""The reference against the port at tiny widths on the CPU, both in
float32: the same weights and inputs give the same Gaussians, renders,
teacher outputs, losses, gradients and updates."""

from __future__ import annotations

import pytest
import torch

from portbench.drivers import serve_closed, train_step
from portbench.program import serving_model
from portbench.reference.model import batch_on
from portbench.reference.optim import PlainAdamW
from portbench.scenes import draw

from .conftest import context, tiny_cell


def test_the_reference_forward_equals_the_ports():
    _, wl, cfg = tiny_cell("styl3r.serve-2v256")
    dev = torch.device("cpu")
    tr, render = wl["traffic_parameters"], wl["render"]
    hw = (tr["size"], tr["size"])
    program = serve_closed.make_request(serving_model(cfg, dev), hw, render, dev)
    ref = serve_closed.reference_model(cfg, dev)
    arrays = draw(5, 0, tr)
    gaussians, rendered, dropped = program(arrays)
    values = serve_closed.compare({0: (serve_closed.host_gaussians(gaussians), rendered)}, [arrays], ref, hw,
                                  render, dev)
    assert not dropped
    assert values["gaussians_rel_l2"] < 1e-5 and values["render_rel_l2"] < 1e-5
    with torch.no_grad():
        _, out = ref(batch_on(arrays, dev), hw, **render)
    assert float(out.alpha.max()) > 0  # something was rendered
    assert torch.allclose(rendered[0], out.color, atol=1e-5)


def test_the_reference_teacher_equals_the_ports():
    from portbench.program import teacher
    from portbench.reference.init import drawn
    from portbench.reference.teacher import Dust3RTeacher

    _, _, cfg = tiny_cell("mast3r-distill.stage0-2v256")
    dev = torch.device("cpu")
    ref = drawn(lambda: Dust3RTeacher(**train_step.teacher_widths(cfg)), cfg["teacher"]["weight_seed"], dev).eval()
    images = torch.rand(2, 2, 32, 32, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    with torch.no_grad():
        a, b = teacher(cfg, dev)(images), ref(images)
    for key in train_step.TEACHER_KEYS:
        assert torch.allclose(a[key], b[key], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", ["mast3r-distill.stage0-2v256", "styl3r.train-style-3v256"])
def test_the_reference_step_follows_the_ports_training_steps(cell):
    """Stage 0 (Regr3D against the teacher) and stage 2 (style + identity
    through the renderer, one scene at a time with the batch's dropout
    masks): the same losses, first gradients and changes."""
    _, wl, cfg = tiny_cell(cell)
    ctx = context(cell, wl, cfg)
    tr = train_step.traffic(ctx)
    dev = torch.device("cpu")
    prog = train_step.Program(cfg, dict(wl, traffic_parameters=tr), dev)
    got = train_step.first_steps(prog, 9, tr, 3)
    want = train_step.Reference(cfg, wl, dev).steps(9, tr, 3)
    values = train_step.compare(got, want)
    assert min(want["losses"]) > 0
    assert values["loss_rel"] < 1e-4 and values.get("teacher_rel_l2", 0.0) < 1e-5
    assert values["grad_leaf_gap"] < 1e-3 and values["delta_leaf_gap"] < 1e-3
    assert values["leaves_compared"] > 100


def test_the_plain_adamw_equals_the_ports_grouped_adamw():
    from styl3r_tpu_torch.train.step import GroupedAdamW

    gen = torch.Generator().manual_seed(3)
    a = [torch.nn.Parameter(torch.randn(5, 4, generator=gen)) for _ in range(3)]
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    port = GroupedAdamW({"x": (a[:1], 0.1), "y": (a[1:], 1.0)}, 1e-2, 2, 10, 0.05, 0.5)
    plain = PlainAdamW([(b[:1], 0.1), (b[1:], 1.0)], 1e-2, 2, 10, 0.05, 0.5)
    for k in range(4):
        grads = [torch.randn(5, 4, generator=gen) * (k + 1) for _ in range(3)]
        for p, q, g in zip(a, b, grads):
            p.grad, q.grad = g.clone(), g.clone()
        port.step()
        plain.step()
        for p, q in zip(a, b):
            assert torch.allclose(p, q, rtol=1e-6, atol=1e-7)
