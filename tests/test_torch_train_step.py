"""Port parity for a whole train step of each stage against a JAX step
built from the same pieces, and the identity branch's dropout replay.

Tolerances: loss and metrics 1e-4 relative, gradients 2e-3 of each
tensor's largest magnitude and their global norm 1e-3 relative (measured
1.9e-4 in stage 2), params after the update 1e-6 of theirs. The f32 model
sums in other orders in XLA and PyTorch (1e-5 on its Gaussians,
tests/test_torch_model.py), and the backward passes through expm1, the
renderer's divisions by (1 - alpha) and VGG's std."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from styl3r_tpu.losses import vgg as jvgg
from styl3r_tpu.models.styl3r import Styl3rModel as JModel
from styl3r_tpu.train import losses as jtl
from styl3r_tpu.train import step as jstep
from styl3r_tpu_torch.losses.vgg import VGG19Features
from styl3r_tpu_torch.models import dpt as tdpt
from styl3r_tpu_torch.models.styl3r import batch_to
from styl3r_tpu_torch.train import losses as ttl
from styl3r_tpu_torch.train import step as tstep
from styl3r_tpu_torch.utils.convert import from_jax_params
from test_torch_model import RENDER, TINY, draw_params
from test_torch_train import HW, _label_by_port_name, _port_model, _to_port, _train_batch, flax_params  # noqa: F401


def _stage(name):
    if name == "stage1":
        return dict(stylized=False, identity_branch=False), dict(mse_weight=1.0)
    return dict(stylized=True, identity_branch=True), dict(mse_weight=None, style_weight=10.0, identity=True)


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_train_step_matches_jax(flax_params, stage, monkeypatch):
    """One step of each stage, dropout off: the loss, its metrics, every
    gradient and the params after the update against a JAX step built from
    the same pieces (model.forward(deterministic=True), LossBundle,
    tx.update; make_train_step itself hard-codes live dropout)."""
    vgg_params = draw_params(jvgg.VGG19Features(), jnp.zeros((1, *HW, 3)), seed=5)
    step_kw, loss_kw = _stage(stage)
    batch = _train_batch(7)
    jb = jax.tree.map(jnp.asarray, batch)
    jm = JModel(sh_degree=1, **TINY)
    j_loss_fn = jtl.LossBundle(**loss_kw, vgg19_params=vgg_params)
    opt_kw = dict(lr=1e-3, warmup_steps=0, total_steps=5)

    # JAX, from the pieces of make_train_step.
    if not step_kw["stylized"]:
        jb = jb._replace(style_image=jb.context_images[:, 0])

    def compute_loss(params):
        gaussians, output = jm.forward(params, jb, HW, global_step=0, deterministic=True, impl="pallas_interpret", **RENDER)
        id_out = None
        if step_kw["identity_branch"]:
            _, id_out = jm.forward(params, jb._replace(style_image=jb.context_images[:, 0]), HW,
                                   global_step=0, deterministic=True, impl="pallas_interpret", **RENDER)
        return j_loss_fn(output, jb, gaussians, global_step=0, identity_output=id_out)

    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(compute_loss, has_aux=True))(flax_params)
    port_grads = _to_port(j_grads, grads=True)
    port_params = _to_port(flax_params)

    # The port.
    monkeypatch.setattr(tdpt, "GS_DROPOUT", 0.0)
    tm = _port_model(flax_params)
    vgg = VGG19Features()
    vgg.load_state_dict(from_jax_params(vgg_params, model="vgg19"))
    t_loss_fn = ttl.LossBundle(**loss_kw, vgg19=vgg.requires_grad_(False))
    if stage == "stage1":
        opt = tstep.make_optimizer(tm, **opt_kw)
        labels = {n: "all" for n in port_params}
        groups = {"all": optax.adamw(jstep.make_schedule(1e-3, 0, 5), b1=0.9, b2=0.95, weight_decay=0.05)}
    else:
        opt = tstep.make_stage2_optimizer(tm, **opt_kw)
        labels = _label_by_port_name(flax_params, jstep.stage2_param_labels(flax_params))
        groups = {
            "new": optax.adamw(jstep.make_schedule(1e-3, 0, 5), b1=0.9, b2=0.95, weight_decay=0.05),
            "pretrained": optax.adamw(jstep.make_schedule(1e-4, 0, 5), b1=0.9, b2=0.95, weight_decay=0.05),
            "frozen": optax.set_to_zero(),
        }
    step = tstep.make_train_step(tm, opt, HW, loss_fn=t_loss_fn, **step_kw, **RENDER)
    grads_seen = {}

    def keep_grads(name):
        def hook(g):
            grads_seen[name] = g.detach().clone()
        return hook

    for name, p in tm.named_parameters():
        if p.requires_grad:
            p.register_hook(keep_grads(name))
    state = tstep.TrainState()
    metrics = step(state, batch_to(batch, "cpu"), torch.Generator().manual_seed(0))
    assert state.step == 1

    assert float(metrics["loss"]) == pytest.approx(float(j_loss), rel=1e-4)
    for k, v in j_metrics.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-4), k
    trained = [n for n, p in tm.named_parameters() if p.requires_grad]
    assert set(grads_seen) == set(trained) and len(trained) > 50
    for name in trained:
        b = port_grads[name]
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(grads_seen[name].numpy(), b, rtol=0, atol=2e-3 * scale + 1e-12, err_msg=name)
    j_norm = float(optax.global_norm({n: port_grads[n] for n in trained}))
    assert float(metrics["grad_norm"]) == pytest.approx(j_norm, rel=1e-3)  # as the grads
    assert int(metrics["live_pairs"]) <= int(metrics["pair_slots"])

    # optax with the port's grads, each group flattened into one vector
    # (AdamW is elementwise and the clip takes one global norm, so this is
    # the same update; one vector a group keeps optax's eager ops few).
    members = {g: [n for n in port_params if labels[n] == g] for g in groups}
    members = {g: ns for g, ns in members.items() if ns}

    def flat(tree):
        return {g: np.concatenate([np.ravel(tree[n]) for n in ns]) for g, ns in members.items()}

    tx = optax.chain(optax.masked(optax.set_to_zero(), {g: g == "frozen" for g in members}),
                     optax.clip_by_global_norm(0.5),
                     optax.multi_transform({g: groups[g] for g in members}, {g: g for g in members}))
    grads = {n: grads_seen[n].numpy() if n in grads_seen else np.zeros_like(v) for n, v in port_params.items()}
    flat_params = flat(port_params)
    updates, _ = tx.update(flat(grads), tx.init(flat_params), flat_params)
    expected = {}
    for g, vec in optax.apply_updates(flat_params, updates).items():
        offset = 0
        for n in members[g]:
            size = port_params[n].size
            expected[n] = np.asarray(vec[offset:offset + size]).reshape(port_params[n].shape)
            offset += size
    for name, p in tm.named_parameters():
        b = expected[name]
        np.testing.assert_allclose(p.detach().numpy(), b, rtol=0, atol=1e-6 * max(np.abs(b).max(), 1e-3), err_msg=name)


def test_identity_branch_replays_the_dropout_masks(flax_params):
    """With dropout live and style := context view 0 already, the identity
    forward sees the main forward's inputs and masks: equal renders."""
    tm = _port_model(flax_params)
    batch = batch_to(_train_batch(8), "cpu")
    batch = batch._replace(style_image=batch.context_images[:, 0])
    seen = {}

    def loss_fn(output, batch, gaussians, global_step=0, identity_output=None):
        seen["main"], seen["identity"] = output.color.detach(), identity_output.color.detach()
        return ((output.color - batch.target_images) ** 2).mean(), {}

    step = tstep.make_train_step(tm, tstep.make_optimizer(tm), HW, loss_fn=loss_fn, identity_branch=True, **RENDER)
    step(tstep.TrainState(), batch, torch.Generator().manual_seed(3))
    assert torch.equal(seen["main"], seen["identity"])
    tm.eval()
    with torch.no_grad():
        _, eval_out = tm(batch, HW, **RENDER)
    assert not torch.equal(eval_out.color, seen["main"])  # dropout was live
