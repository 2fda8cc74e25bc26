"""Port parity for training: the schedule, the optimizers, the stage-2
groups and scratch_init_heads against the JAX package; and the two training
repairs (f32 master weights under bf16 compute, dropout in the gs towers).
A whole train step of each stage is in test_torch_train_step.py.

Tolerances, each with its reason:
  * schedule: 1e-5 relative (optax computes in f32, the port in f64:
    1.5e-6 apart at warmup step 1);
  * optimizer steps: params within 1e-6 of their largest magnitude (the same
    AdamW arithmetic in another order);
  * bf16 compute: Gaussians within 2e-2 of each field's scale, or within
    2.5 times what bf16 compute moves the JAX model itself from its f32
    result where that is more (8 mantissa bits, rounded at other places in
    flax and under torch.autocast; expm1 in the means and the normalizing
    of small raw quaternions amplify it: measured, bf16 moves the JAX
    model's means by 2.1% and its rotations by 17% of their scale, and the
    port differs from it by 4.1% and 16.8%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from styl3r_tpu.models.styl3r import Styl3rModel as JModel
from styl3r_tpu.train import scratch_init as jsi
from styl3r_tpu.train import step as jstep
from styl3r_tpu_torch.models import dpt as tdpt
from styl3r_tpu_torch.models.styl3r import Styl3rModel as TModel
from styl3r_tpu_torch.models.styl3r import batch_to
from styl3r_tpu_torch.train import scratch_init as tsi
from styl3r_tpu_torch.train import step as tstep
from styl3r_tpu_torch.utils.convert import from_jax_params
from test_torch_model import RENDER, TINY, _batch, draw_params

HW = (32, 32)
PATCH_EXPAND = ("act_0_up", "act_1_up")


@pytest.fixture(scope="module")
def flax_params():
    jm = JModel(sh_degree=1, **TINY)
    return draw_params(jm, jax.tree.map(jnp.asarray, _batch(np.random.default_rng(0), *HW)), seed=0)


def _port_model(params, **kw):
    tm = TModel(sh_degree=1, device="cpu", **TINY, **kw)
    tm.load_state_dict(from_jax_params(params))
    return tm


def _to_port(tree, grads=False):
    """A flax-layout tree of params, or with `grads` of gradients, ->
    {port name: array}. A PatchExpand bias holds its ConvTranspose bias k*k
    times: its gradient is the sum over the copies."""
    def go(path, leaf):
        names = [getattr(k, "key", k) for k in path]
        leaf = np.asarray(leaf)
        if grads and names[-1] == "bias" and any(n in PATCH_EXPAND for n in names):
            kk = 16 if "act_0_up" in names else 4
            leaf = np.tile(leaf.reshape(kk, -1).sum(0), kk)
        return leaf

    return {k: v.numpy() for k, v in from_jax_params(jax.tree_util.tree_map_with_path(go, tree)).items()}


def _label_by_port_name(params, labels):
    """Each flax leaf's label carried to the port's parameter names through
    the weights bridge: leaf i is filled with i, converted, and read back."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    marked = jax.tree_util.tree_unflatten(treedef, [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])
    flat_labels = jax.tree_util.tree_leaves(labels)
    out = {}
    for name, t in from_jax_params(marked).items():
        ids = set(np.unique(t.numpy()).astype(int))
        assert len(ids) == 1, name
        out[name] = flat_labels[ids.pop()]
    return out


def _train_batch(seed):
    b = _batch(np.random.default_rng(seed), *HW)
    return b._replace(target_images=np.random.default_rng(seed + 1).uniform(0, 1, (1, 2, *HW, 3)).astype(np.float32))


# --- schedule and optimizers -------------------------------------------------


def test_schedule_matches_optax():
    for lr, warmup, total in ((2e-4, 125, 15_000), (1e-3, 3, 10), (5e-4, 0, 7)):
        ref = jstep.make_schedule(lr, warmup, total)
        ours = tstep.make_schedule(lr, warmup, total)
        for k in list(range(0, min(total + 3, 200))) + [total - 1, total, total + 100]:
            assert ours(k) == pytest.approx(float(ref(k)), rel=1e-5, abs=1e-12), (lr, warmup, total, k)


def _drawn_grads(params, seed, scale):
    """Flax-layout gradients, numpy-drawn; PatchExpand biases get none (the
    flax layout holds k*k copies of each, whose norm the clip would count
    k*k times)."""
    rng = np.random.default_rng(seed)

    def go(path, leaf):
        names = [getattr(k, "key", k) for k in path]
        if names[-1] == "bias" and any(n in PATCH_EXPAND for n in names):
            return np.zeros(leaf.shape, np.float32)
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(go, params)


OPTIMIZERS = {
    "make_optimizer": (
        lambda p: jstep.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=5),
        lambda m: tstep.make_optimizer(m, lr=1e-3, warmup_steps=1, total_steps=5),
    ),
    "backbone_0.1x": (
        lambda p: jstep.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=5, params=p, backbone_lr_multiplier=0.1),
        lambda m: tstep.make_optimizer(m, lr=1e-3, warmup_steps=1, total_steps=5, backbone_lr_multiplier=0.1),
    ),
    "stage2": (
        lambda p: jstep.make_stage2_optimizer(lr=1e-3, warmup_steps=1, total_steps=5, params=p),
        lambda m: tstep.make_stage2_optimizer(m, lr=1e-3, warmup_steps=1, total_steps=5),
    ),
}


@pytest.mark.parametrize("clip", ["clipped", "unclipped"])
@pytest.mark.parametrize("which", list(OPTIMIZERS))
def test_optimizer_steps_match_optax(flax_params, which, clip):
    """Three updates from fixed gradients: the port's params equal optax's
    after each step; frozen parameters stay bitwise unchanged."""
    make_j, make_t = OPTIMIZERS[which]
    tx = make_j(flax_params)
    params, opt_state = flax_params, tx.init(flax_params)
    tm = _port_model(flax_params)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = make_t(tm)
    trained = {n: p for n, p in tm.named_parameters() if p.requires_grad}
    scale = 0.3 if clip == "clipped" else 1e-4  # global norm ~30 or ~0.01 vs the 0.5 clip
    for k in range(3):
        grads = _drawn_grads(flax_params, seed=10 + k, scale=scale)
        norm = float(optax.global_norm(grads))
        assert (norm > 0.5) == (clip == "clipped")
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        port_grads = _to_port(grads, grads=True)
        for name, p in trained.items():
            p.grad = torch.from_numpy(port_grads[name].copy())
        opt.step()
        ref = _to_port(params)
        for name, p in tm.named_parameters():
            b = ref[name]
            np.testing.assert_allclose(p.detach().numpy(), b, rtol=0, atol=1e-6 * max(np.abs(b).max(), 1e-3), err_msg=f"{name} step {k}")
    if which == "stage2":
        frozen = [n for n in before if n not in trained]
        assert len(frozen) > 100
        for name in frozen:
            assert torch.equal(tm.state_dict()[name], before[name]), name
        assert not any(p.requires_grad for n, p in tm.named_parameters() if n in frozen)


def test_stage2_groups_match_jax_labels(flax_params):
    """The port's stage-2 and backbone groups equal the JAX labels of the
    flax tree, carried to the port's names through the weights bridge."""
    tm = _port_model(flax_params)
    for j_fn, t_fn in ((jstep.stage2_param_labels, tstep.stage2_param_labels),
                       (jstep.backbone_param_labels, tstep.backbone_param_labels)):
        expected = _label_by_port_name(flax_params, j_fn(flax_params))
        ours = t_fn(tm)
        assert ours == {k: expected[k] for k in ours}
        assert set(ours) == set(expected)
    counts = {l: list(tstep.stage2_param_labels(tm).values()).count(l) for l in ("new", "pretrained", "frozen")}
    assert all(counts.values()), counts


def test_scratch_init_heads_matches_jax(flax_params):
    tm = _port_model(flax_params)
    tsi.scratch_init_heads(tm)
    ref = from_jax_params(jsi.scratch_init_heads(flax_params))
    changed = 0
    for name, value in tm.state_dict().items():
        torch.testing.assert_close(value, ref[name], rtol=1e-6, atol=0, msg=name)
        changed += not torch.equal(value, from_jax_params(flax_params)[name])
    assert changed == 8  # the final kernel and bias of four heads


def test_distillation_is_not_ported_yet(flax_params):
    """Distillation is ported now (tests/test_torch_distill.py holds it
    against JAX): make_train_step takes a DistillCfg. Its distill-only step
    reaches neither the stylizer nor the gs heads, whose weights then move
    by decoupled weight decay alone, p * (1 - lr * 0.05), as optax's zero
    gradients move them; the point-map path moves by more."""
    from styl3r_tpu_torch.models.distiller import Dust3RTeacher
    from styl3r_tpu_torch.utils.convert import init_like_flax_

    tm = _port_model(flax_params)
    teacher = init_like_flax_(Dust3RTeacher(**TINY), torch.Generator().manual_seed(2)).freeze()
    opt = tstep.make_optimizer(tm, lr=1e-3, warmup_steps=0, total_steps=5)
    step = tstep.make_train_step(tm, opt, HW, stylized=False,
                                 distill=tstep.DistillCfg(teacher=teacher, distill_only=True))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    metrics = step(tstep.TrainState(), batch_to(_train_batch(7), "cpu"), torch.Generator().manual_seed(0))
    assert set(metrics) == {"distill", "loss", "grad_norm"} and float(metrics["distill"]) > 0
    decayed = moved = 0
    for name, p in tm.named_parameters():
        only_decay = torch.equal(p.detach(), before[name] * (1 - 1e-3 * 0.05))
        if name.startswith(("encoder.token_stylizer.", "encoder.gaussian_")):
            assert only_decay, name
            decayed += 1
        elif name.startswith(("encoder.backbone.", "encoder.downstream_head")):
            moved += not only_decay
    assert decayed > 100 and moved > 100


# --- the two repairs ---------------------------------------------------------


def _record_compute_dtypes(tm):
    """Forward hooks recording the output dtypes of a backbone encoder and
    decoder layer, a stylizer layer, three DPT trunks' first conv and a
    head's f32 final conv: {layer: set of dtypes}."""
    enc = tm.encoder
    layers = {
        "backbone encoder": enc.backbone.enc_blocks[0].mlp.fc1,
        "backbone decoder": enc.backbone.dec_blocks2[0].mlp.fc1,
        "stylizer": enc.token_stylizer.dec_blocks[0].mlp.fc1,
        "pts3d trunk": enc.downstream_head1.dpt.scratch.layer1_rn,
        "gs trunk": enc.gaussian_param_head2.dpt.scratch.layer1_rn,
        "appearance trunk": enc.gaussian_appearance_head.dpt.scratch.layer1_rn,
        "final conv": enc.gaussian_param_head.dpt.head["4"],
    }
    seen = {k: set() for k in layers}
    for k, m in layers.items():
        m.register_forward_hook(lambda mod, args, out, k=k: seen[k].add(out.dtype))
    return seen


def test_bf16_compute_keeps_f32_weights_and_grads(flax_params):
    """backbone_dtype / head_trunk_dtype are compute dtypes: the port model
    holds f32 parameters and gets f32 gradients, its backbone, stylizer and
    DPT trunks compute in bf16 (in eval and in training mode) while the
    final convs stay f32, and its Gaussians match the JAX model of the same
    dtypes (f32 params) on the CPU. The same hooks on the f32 model see f32
    everywhere, so the dtype check holds where the value check cannot tell
    bf16 compute from f32."""
    bf16 = dict(backbone_dtype=torch.bfloat16, head_trunk_dtype=torch.bfloat16)
    tm = _port_model(flax_params, **bf16)
    assert not tm.training
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    seen = _record_compute_dtypes(tm)
    expected = {k: {torch.float32 if k == "final conv" else torch.bfloat16} for k in seen}
    batch = _train_batch(9)
    jb = jax.tree.map(jnp.asarray, batch)
    j_bf16, j_f32 = (
        jax.jit(JModel(sh_degree=1, backbone_dtype=dt, head_trunk_dtype=dt, **TINY).predict_gaussians)(flax_params, jb)
        for dt in (jnp.bfloat16, None)
    )
    tb = batch_to(batch, "cpu")
    tg, out = tm(tb, HW, **RENDER)
    assert seen == expected
    for name in j_bf16._fields:
        a, b = getattr(tg, name).detach().numpy(), np.asarray(getattr(j_bf16, name), np.float32)
        assert a.dtype == np.float32
        bf16_effect = float(np.abs(b - np.asarray(getattr(j_f32, name))).max())
        atol = max(2e-2 * max(float(np.abs(b).max()), 1.0), 2.5 * bf16_effect)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)
    ((out.color - tb.target_images) ** 2).mean().backward()
    grads = [p.grad for p in tm.parameters()]
    assert all(g is not None and g.dtype == torch.float32 for g in grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    # Training mode computes in bf16 too.
    for v in seen.values():
        v.clear()
    tm.train()
    tm(tb, HW, generator=torch.Generator().manual_seed(0), **RENDER)
    assert seen == expected
    # The f32 model: f32 at every hooked layer.
    f32_model = _port_model(flax_params)
    f32_seen = _record_compute_dtypes(f32_model)
    with torch.no_grad():
        f32_model(tb, HW, **RENDER)
    assert f32_seen == {k: {torch.float32} for k in seen}
    # Serving may still store the trunks in bf16, explicitly.
    tm.cast_dtypes()
    assert tm.encoder.backbone.enc_norm.weight.dtype == torch.bfloat16
    assert tm.encoder.downstream_head1.dpt.head["4"].weight.dtype == torch.float32


def test_gs_tower_dropout():
    """Eval mode: the identity. Training mode: about 10% of the activations
    zeroed, the rest scaled by 1/0.9, the mask from the generator given."""
    x = torch.rand(4, 16, 32, 32) + 0.5
    assert torch.equal(tdpt.dropout(x, 0.1, False, None), x)
    y = tdpt.dropout(x, 0.1, True, torch.Generator().manual_seed(1))
    zeroed = y == 0
    assert abs(float(zeroed.float().mean()) - 0.1) < 0.01
    torch.testing.assert_close(y[~zeroed], x[~zeroed] / 0.9)
    assert torch.equal(y, tdpt.dropout(x, 0.1, True, torch.Generator().manual_seed(1)))
    assert not torch.equal(y, tdpt.dropout(x, 0.1, True, torch.Generator().manual_seed(2)))

    head = tdpt.DPTGSSHHead((32, 16, 16, 16), out_channels=3, hooks=(0, 2, 3, 4), feature_dim=16,
                            layer_dims=(8, 8, 16, 16))
    tokens = [torch.randn(1, 4, d) for d in (32, 16, 16, 16, 16)]
    head.eval()
    ref = head(tokens, (32, 32), torch.Generator().manual_seed(0))
    head.train()
    a = head(tokens, (32, 32), torch.Generator().manual_seed(0))
    b = head(tokens, (32, 32), torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, ref)
