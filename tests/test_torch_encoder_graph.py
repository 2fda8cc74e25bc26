"""The Styl3r encoder's CUDA-graph rule on the CPU (models/encoder.py,
models/croco.py): the context-view index and the extra token's position
are built on the device without a host copy and equal the list-built
tensors they replace; the engage rule declines every forward but an
inference forward of CUDA inputs; the key follows what the forward's
Python decides on and not the training step; a CPU forward stays eager
and counts no encoder call; the tracer declares the encoder's counters.
The capture and replay themselves are card tests (test_torch_cuda.py)."""

import contextlib
import copy
import types

import pytest
import torch

from styl3r_tpu_torch.models import croco
from styl3r_tpu_torch.models.adapter import opacity_exponent
from styl3r_tpu_torch.models.encoder import graph_engages, graph_key
from styl3r_tpu_torch.models.styl3r import Styl3rModel
from styl3r_tpu_torch.utils import trace

TINY = dict(
    enc_depth=1, dec_depth=2, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2,
    head_feature_dim=16, head_last_dim=16, head_layer_dims=(8, 8, 16, 16),
)
ENCODER_COUNTERS = ("encoder_calls", "encoder_captures", "encoder_replays")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b=1, v=2, hw=32, dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(b, v, hw, hw, 3, generator=gen).to(dtype) * 2 - 1
    intrinsics = torch.eye(3).expand(b, v, 3, 3).contiguous()
    return images, intrinsics, torch.rand(b, hw, hw, 3, generator=gen) * 2 - 1


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("v", [2, 3, 4])
def test_context_views_and_the_extra_position_equal_the_list_built_ones(v, b):
    croco._constants.clear()
    x = torch.randn(b, v, 5, 4)
    idx = torch.tensor([[j for j in range(v) if j != i] for i in range(v)])
    want = x[:, idx].reshape(b, v, (v - 1) * 5, 4)
    assert croco.ctx_view_index(v, "cpu").dtype == idx.dtype
    for _ in range(2):  # built, then kept
        assert torch.equal(croco.generate_ctx_views(x), want)

    encoder = croco.CrocoVitEncoder(depth=1, dim=16, num_heads=2)
    n = b * v
    images = torch.rand(n, 32, 48, 3)
    with torch.no_grad():
        _, pos = encoder.encode(images, torch.zeros(n, 1, 16))
    old_extra = torch.tensor([[32 // 16, 0]], dtype=pos.dtype)
    assert pos.shape == (n, 2 * 3 + 1, 2)
    assert torch.equal(pos[:, -1:], old_extra[None].expand(n, 1, 2))
    assert torch.equal(croco.extra_token_pos(2, torch.int32, "cpu"), old_extra)


def test_an_index_first_built_in_inference_mode_serves_a_training_forward():
    croco._constants.clear()
    with torch.inference_mode():
        croco.generate_ctx_views(torch.randn(1, 3, 5, 4))
    x = torch.randn(1, 3, 5, 4, requires_grad=True)
    croco.generate_ctx_views(x).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 2.0))


CUDA_LIKE = types.SimpleNamespace(is_cuda=True)
ENGAGES = dict(training=False, grad_enabled=False, inputs=(CUDA_LIKE,) * 3, return_aux=False, generator=None,
               distill_only=False)


@pytest.mark.parametrize("change", [
    dict(inputs=(torch.zeros(1),) * 3),
    dict(inputs=(CUDA_LIKE, torch.zeros(1), CUDA_LIKE)),
    dict(grad_enabled=True),
    dict(training=True),
    dict(return_aux=True),
    dict(generator=torch.Generator()),
    dict(distill_only=True),
], ids=["cpu", "one_cpu_input", "grad", "train_mode", "return_aux", "generator", "distill_only"])
def test_the_graph_engages_on_an_inference_forward_of_cuda_inputs_alone(change):
    assert graph_engages(**ENGAGES)
    assert not graph_engages(**{**ENGAGES, **change})


@contextlib.contextmanager
def _set(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def _other_matmul_precision():
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium" if saved == "highest" else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


@pytest.mark.parametrize("case", [
    "shape", "views", "dtype", "strides", "transpose_maps", "inference_mode", "autocast", "cudnn_tf32",
    "matmul_tf32", "matmul_precision", "opacity_exponent",
])
def test_the_key_changes_with_what_the_forward_decides_on(case):
    inputs = _inputs()
    base = graph_key(inputs, False, 1.0)
    assert graph_key(_inputs(), False, 1.0) == base  # the values are not in it
    other_inputs, transpose, exponent, scope = inputs, False, 1.0, contextlib.nullcontext()
    if case == "shape":
        other_inputs = _inputs(b=2)
    elif case == "views":
        other_inputs = _inputs(v=3)
    elif case == "dtype":
        other_inputs = _inputs(dtype=torch.bfloat16)
    elif case == "strides":
        other_inputs = (inputs[0].transpose(2, 3), *inputs[1:])
    elif case == "transpose_maps":
        transpose = True
    elif case == "inference_mode":
        scope = torch.inference_mode()
    elif case == "autocast":
        scope = torch.autocast("cpu", dtype=torch.bfloat16)
    elif case == "cudnn_tf32":
        scope = _set(torch.backends.cudnn, "allow_tf32", not torch.backends.cudnn.allow_tf32)
    elif case == "matmul_tf32":
        scope = _set(torch.backends.cuda.matmul, "allow_tf32", not torch.backends.cuda.matmul.allow_tf32)
    elif case == "matmul_precision":
        scope = _other_matmul_precision()
    else:
        exponent = opacity_exponent(5, 0.0, 1.0, 10)
    with scope:
        assert graph_key(other_inputs, transpose, exponent) != base
    assert graph_key(inputs, False, 1.0) == base


def test_the_key_does_not_follow_the_step_at_the_release_config():
    inputs = _inputs()
    keys = {graph_key(inputs, False, opacity_exponent(step, 0.0, 0.0, 1)) for step in (0, 1, 100, 10**6)}
    assert keys == {graph_key(inputs, False, 1.0)}


def test_a_cpu_forward_stays_eager_and_counts_no_encoder_call():
    model = Styl3rModel(sh_degree=0, device="cpu", seed=0, **TINY)
    before = trace.counters()
    with torch.no_grad():
        first = model.encoder(*_inputs())
        second = model.encoder(*_inputs())
    after = trace.counters()
    assert all(after[name] == before[name] for name in ENCODER_COUNTERS)
    assert not model.encoder._graphs
    assert all(torch.equal(a, b) for a, b in zip(first, second) if a is not None)
    assert not copy.deepcopy(model).encoder._graphs


def test_the_tracer_declares_the_encoder_counters():
    assert set(ENCODER_COUNTERS) <= set(trace.COUNTERS)
    assert all(trace.counters()[name] >= 0 for name in ENCODER_COUNTERS)
