"""Tensor parallelism in styl3r_tpu_torch (parallel/tp.py) on the CPU: a
(1, 2) (data, model) mesh of 2 ranks over gloo, started by
torch.multiprocessing.spawn through a file:// rendezvous under tmp_path, one
torch thread each. JAX is imported inside the test functions only.

  * The plan lands as the JAX module's does: qkv, fc1 and projq/k/v weights
    Shard(0) (JAX's kernel P(None, "model")), proj and fc2 weights Shard(1)
    (P("model", None)), column biases Shard(0), row biases and norms
    replicated, in every block; JAX's name rule also shards the patch
    embeddings' conv kernel over its height ("proj"), which the port keeps
    whole.
  * One TP train step (stage 1, MSE, the gs towers' dropout live) equals the
    unsharded step: the loss and grad_norm within 1e-5 relative (the row
    layers' partial sums are all-reduced, another summation order), the
    gathered weights within 1e-5 of each tensor's largest magnitude plus 0.5
    of the learning rate where the clipped gradient is within 100 * eps
    (1e-6) of zero (AdamW's first step, lr * g / (|g| + eps), turns such a
    gradient's rounding into a share of lr; tests/test_torch_distill.py's
    reason).
  * The gathered state dict holds the reference layout: before the step it
    is the unsharded state dict exactly, and JAX's convert_styl3r_encoder
    carries it to flax params that from_jax_params carries back exactly.
  * torch.distributed.checkpoint saves the sharded weights and AdamW moments
    and restores them into a model drawn from another seed exactly, with
    their placements.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from styl3r_tpu_torch.models.styl3r import Styl3rModel, batch_to
from styl3r_tpu_torch.train import step as tstep
from styl3r_tpu_torch.train.scratch_init import scratch_init_heads
from styl3r_tpu_torch.train.trainer import step_generator
from test_torch_parallel import HW, RENDER, TINY, _global_batch, to_flax

LR = 1e-3


def _model(weights):
    model = Styl3rModel(sh_degree=1, device="cpu", **TINY)
    model.load_state_dict(weights)
    return model


def _step(model, data=None):
    """One stage-1 step (MSE, live dropout) from `model`'s weights on the
    global batch (with `data`, on the rank's rows of it)."""
    from styl3r_tpu_torch.parallel import shard_batch

    opt = tstep.make_optimizer(model, lr=LR, warmup_steps=0, total_steps=5)
    step = tstep.make_train_step(model, opt, HW, stylized=False, data=data, **RENDER)
    batch = _global_batch(3, b=2)
    if data is not None:
        batch = shard_batch(batch, data.rank, data.world)
    grads = {}
    for name, p in model.named_parameters():
        p.register_hook(lambda g, name=name: grads.__setitem__(name, g))
    metrics = step(tstep.TrainState(), batch_to(batch, "cpu"), step_generator(1, 0, torch.device("cpu")))
    return {k: float(v) for k, v in metrics.items()}, opt, grads


def _tp_child(rank, workdir):
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import get_state_dict, set_state_dict
    from torch.distributed.tensor import DTensor

    from styl3r_tpu_torch.parallel import data_group_2d, gathered_state_dict, make_mesh_2d, shard_params_tp

    torch.set_num_threads(1)
    workdir = Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}", rank=rank, world_size=2)
    try:
        inputs = torch.load(workdir / "inputs.pt", weights_only=False)
        mesh = make_mesh_2d(1, 2, "cpu")
        model = shard_params_tp(_model(inputs["weights"]), mesh)
        placements = {n: tuple(f"Shard({x.dim})" if x.is_shard() else type(x).__name__ for x in p.placements)
                      if isinstance(p, DTensor) else None for n, p in model.named_parameters()}
        before = {k: v.clone() for k, v in gathered_state_dict(model).items()}
        metrics, opt, _ = _step(model, data_group_2d(mesh))
        after = gathered_state_dict(model)

        # A round trip through torch.distributed.checkpoint into a model of
        # other weights, both sharded alike.
        model_sd, optim_sd = get_state_dict(model, opt.adamw)
        dcp.save({"model": model_sd, "optim": optim_sd}, checkpoint_id=str(workdir / "dcp"))
        fresh = shard_params_tp(_model(inputs["other_weights"]), mesh)
        fresh_opt = tstep.make_optimizer(fresh, lr=LR, warmup_steps=0, total_steps=5)
        model_sd, optim_sd = get_state_dict(fresh, fresh_opt.adamw)
        state = {"model": model_sd, "optim": optim_sd}
        dcp.load(state, checkpoint_id=str(workdir / "dcp"))
        set_state_dict(fresh, fresh_opt.adamw, model_state_dict=state["model"], optim_state_dict=state["optim"])

        def local(t):
            return (t.to_local(), t.placements) if isinstance(t, DTensor) else (t, None)

        mismatched = []
        for (name, p), q in zip(model.named_parameters(), fresh.parameters()):
            pairs = [(p, q)] + [(opt.adamw.state[p][k], fresh_opt.adamw.state[q][k]) for k in opt.adamw.state[p]]
            for a, b in pairs:
                (a, pa), (b, pb) = local(a), local(b)
                if pa != pb or not torch.equal(a, b):
                    mismatched.append(name)
        moments = sum(len(s) for s in fresh_opt.adamw.state.values())
        torch.save(dict(placements=placements, before=before, after=after, metrics=metrics, mismatched=mismatched,
                        moments=moments), workdir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("parallel_tp")
    model = Styl3rModel(sh_degree=1, device="cpu", seed=0, **TINY)
    scratch_init_heads(model)
    other = Styl3rModel(sh_degree=1, device="cpu", seed=1, **TINY)
    inputs = dict(weights=model.state_dict(), other_weights=other.state_dict())
    torch.save(inputs, workdir / "inputs.pt")
    mp.spawn(_tp_child, args=(str(workdir),), nprocs=2)
    return inputs, [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_plan_lands_as_the_jax_module_does(tp_ranks):
    import jax
    import jax.numpy as jnp

    from styl3r_tpu.models.styl3r import Styl3rModel as JModel
    from styl3r_tpu.parallel.tp import tensor_parallel_spec
    from test_torch_model import _batch
    from test_torch_train import _label_by_port_name

    _, out = tp_ranks
    shapes = jax.eval_shape(JModel(sh_degree=1, **TINY).init, jax.random.key(0),
                            jax.tree.map(jnp.asarray, _batch(np.random.default_rng(0), *HW)))
    specs = jax.tree_util.tree_map_with_path(lambda path, _: str(tuple(tensor_parallel_spec(path))), shapes)
    by_port = _label_by_port_name(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), specs)
    # The port's placement of each weight for each JAX spec (flax kernels are
    # (in, out), torch weights (out, in)).
    want = {"(None, 'model')": ("Shard(0)",), "('model',)": ("Shard(0)",), "('model', None)": ("Shard(1)",)}
    placements = out[0]["placements"]
    assert placements == out[1]["placements"]
    sharded = 0
    for name, spec in by_port.items():
        got = placements[name]
        if name.endswith("patch_embed.proj.weight"):
            assert spec == "('model', None)" and got is None, (name, spec, got)
        elif spec == "()":
            # Row layers' biases are replicated DTensors; the rest plain.
            assert got is None or (got == ("Replicate",) and name.endswith(("proj.bias", "fc2.bias"))), (name, got)
        else:
            assert got == want[spec], (name, spec, got)
            sharded += 1
    assert sharded > 50
    assert all(placements[n] is None for n in placements if "norm" in n)


def test_tp_step_equals_the_unsharded_step(tp_ranks):
    inputs, out = tp_ranks
    model = _model(inputs["weights"])
    metrics, _, grads = _step(model)
    clip = min(1.0, 0.5 / metrics["grad_norm"])
    params = {n: p.detach() for n, p in model.named_parameters()}
    for rank in out:
        for k in ("loss", "mse", "grad_norm"):
            assert rank["metrics"][k] == pytest.approx(metrics[k], rel=1e-5), k
        for name, want in params.items():
            got = rank["after"][name]
            tol = 1e-5 * float(want.abs().max()) + torch.where((grads[name] * clip).abs() > 1e-6, 0.0, 0.5 * LR)
            assert ((got - want).abs() <= tol).all(), name
    assert rank["metrics"]["live_pairs"] > 0


def test_gathered_state_dict_has_the_reference_layout(tp_ranks):
    from styl3r_tpu_torch.utils.convert import from_jax_params

    inputs, out = tp_ranks
    for rank in out:
        assert rank["before"].keys() == inputs["weights"].keys()
        for name, value in inputs["weights"].items():
            assert torch.equal(rank["before"][name], value), name
    back = from_jax_params(to_flax(out[0]["after"]))
    assert back.keys() == out[0]["after"].keys()
    for name, value in out[0]["after"].items():
        assert torch.equal(back[name], value), name


def test_dcp_round_trip_is_exact(tp_ranks):
    _, out = tp_ranks
    for rank in out:
        assert rank["mismatched"] == []
        assert rank["moments"] >= 2 * len(rank["placements"])
