"""Port parity for the distillation stage: Regr3D and its normalization,
the conf pts3d head and the frozen DUSt3R teacher against the JAX package;
one distill-only (stage 0) step and one stage-1 + distill step against
JAX's make_train_step(distill=...); the max_steps gate; the MASt3R
checkpoint converter; and `python -m styl3r_tpu_torch.train.main` on
configs/experiment/re10k_style_distill.yaml at tiny widths.

Tolerances, each with its reason:
  * Regr3D on identical arrays: its masks exactly (the same quantile
    arithmetic and the same >= / <=), the loss 1e-5 relative and its
    gradient 1e-4 of its largest magnitude (with normalization each
    element's gradient holds a sum over all 2 * 1024 points of its batch
    element through the average distance, taken in another order: measured
    2.1e-5);
  * the conf head and the teacher: 1e-4 of each output's largest magnitude,
    the whole-model tolerance of tests/test_torch_model.py (pts3d go through
    expm1: the teacher's reach 2e4 at random weights);
  * the steps: the loss 1e-5 relative (the teacher's points agree to ~3e-6,
    the student's to 1e-5, and the valid set is the same); the gradient's
    global norm 1e-3 relative (tests/test_torch_train_step.py's, measured
    7e-5); each weight after the update within 1e-6 of its tensor's largest
    magnitude plus 0.01 of its learning rate where the clipped gradient
    exceeds 100 * eps (1e-6), and 0.5 of it elsewhere: the first AdamW
    step moves a weight by lr * g / (|g| + eps), which for a gradient near
    eps (1e-8) turns its rounding into a share of lr (measured 0.0012 and
    0.14 of lr).
The JAX PatchExpand keeps k*k free copies of each ConvTranspose bias, which
an update moves apart, so those biases are left out of the update check."""

import json
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from styl3r_tpu.losses import regr3d as jregr
from styl3r_tpu.models import dpt as jdpt
from styl3r_tpu.models.distiller import Dust3RTeacher as JTeacher
from styl3r_tpu.models.styl3r import Styl3rModel as JModel
from styl3r_tpu.train import step as jstep
from styl3r_tpu_torch.losses import regr3d as tregr
from styl3r_tpu_torch.models import dpt as tdpt
from styl3r_tpu_torch.models.distiller import Dust3RTeacher, convert_dust3r_checkpoint
from styl3r_tpu_torch.models.styl3r import Styl3rModel, batch_to
from styl3r_tpu_torch.train import main as train_main
from styl3r_tpu_torch.train import step as tstep
from styl3r_tpu_torch.utils import convert
from styl3r_tpu_torch.utils.convert import from_jax_params
from test_data import make_scene
from test_torch_dpt import HEAD, HOOK_DIMS, _tokens, load
from test_torch_model import RENDER, _scaled_close, draw_params
from test_torch_train import HW, _to_port, _train_batch

# tests/test_train.py's distillation dims (test_trainer_distillation_fit):
# the student, and the teacher with its head_last_dim of 8.
TINY = dict(
    enc_depth=1, dec_depth=2, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2,
    head_feature_dim=16, head_last_dim=16, head_layer_dims=(8, 8, 16, 16),
)
TEACHER = dict(TINY, head_last_dim=8)
STEP_BATCH = 8
PATCH_EXPAND_BIAS = (".act_postprocess.0.1.bias", ".act_postprocess.1.1.bias")


# --- Regr3D --------------------------------------------------------------------


def _points(seed, b=2, hw=(32, 32)):
    """Teacher and student point maps and confidences; the teacher's
    distances tie in blocks (rounded to 0.25), and about half its points
    are below the confidence threshold."""
    rng = np.random.default_rng(seed)
    gt1, gt2 = (np.round(4 * rng.normal(size=(b, *hw, 3)) * 2) / 4 for _ in range(2))
    pr1, pr2 = (g + 0.3 * rng.normal(size=g.shape) for g in (gt1, gt2))
    conf1, conf2 = (1.0 + np.exp(rng.normal(size=(b, *hw))) for _ in range(2))
    return [x.astype(np.float32) for x in (gt1, gt2, pr1, pr2, conf1, conf2)]


CASES = {
    "conf_normalized": dict(),
    "conf_raw": dict(normalize=False),
    "no_conf": dict(conf=False),
    "disable_view1": dict(disable_view1=True),
    "disable_view1_raw": dict(disable_view1=True, normalize=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_regr3d_matches_jax(case):
    kw = dict(CASES[case])
    with_conf = kw.pop("conf", True)
    gt1, gt2, pr1, pr2, conf1, conf2 = _points(1)
    confs = (conf1, conf2) if with_conf else (None, None)

    def jloss(p1, p2):
        return jregr.regr3d_loss(jnp.asarray(gt1), jnp.asarray(gt2), p1, p2,
                                 *(None if c is None else jnp.asarray(c) for c in confs), **kw)

    j_val, j_grads = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(pr1), jnp.asarray(pr2))
    t_pr = [torch.from_numpy(x).requires_grad_() for x in (pr1, pr2)]
    t_val = tregr.regr3d_loss(torch.from_numpy(gt1), torch.from_numpy(gt2), *t_pr,
                              *(None if c is None else torch.from_numpy(c) for c in confs), **kw)
    t_val.backward()
    value = float(t_val.detach())
    assert value > 0 and value == pytest.approx(float(j_val), rel=1e-5)
    if case == "disable_view1_raw":
        # View 1 reaches the loss only through the shared normalization.
        assert t_pr[0].grad is None and float(np.abs(j_grads[0]).max()) == 0.0
        t_pr, j_grads = t_pr[1:], j_grads[1:]
    for t, j in zip(t_pr, j_grads):
        j = np.asarray(j)
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=0, atol=1e-4 * np.abs(j).max())


def test_regr3d_masks_and_normalization_match_jax():
    gt1, gt2, pr1, pr2, conf1, conf2 = _points(2)
    for gt in (gt1, gt2):
        mask = tregr._quantile_mask(torch.from_numpy(gt)).numpy()
        np.testing.assert_array_equal(mask, np.asarray(jregr._quantile_mask(jnp.asarray(gt))))
        assert 0.99 < mask.mean() < 1.0  # the quantiles cut a few points
        flat = np.linalg.norm(gt, axis=-1).reshape(2, -1)
        for q in (0.002, 0.5, 0.998):
            np.testing.assert_array_equal(tregr.quantile(torch.from_numpy(flat), q).numpy(),
                                          np.asarray(jnp.quantile(jnp.asarray(flat), q, axis=1)))
    valid1 = (conf1 >= 3.0).astype(np.float32)
    valid2 = (conf2 >= 3.0).astype(np.float32)
    assert 0.2 < valid1.mean() < 0.8
    ours = tregr.normalize_pointcloud_avg_dis(*(torch.from_numpy(x) for x in (pr1, pr2, valid1, valid2)))
    theirs = jregr.normalize_pointcloud_avg_dis(*(jnp.asarray(x) for x in (pr1, pr2, valid1, valid2)))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    # Every point below the confidence threshold: no valid point, loss 0.
    low = np.ones_like(conf1)
    zero = tregr.regr3d_loss(*(torch.from_numpy(x) for x in (gt1, gt2, pr1, pr2, low, low)), normalize=False)
    assert float(zero) == 0.0


# --- the conf head and the teacher -------------------------------------------


def test_conf_pts3d_head_matches_jax():
    rng = np.random.default_rng(0)
    tokens = _tokens(rng)
    h, w = 32, 48
    jm = jdpt.DPTPts3dHead(last_dim=16, with_conf=True, **HEAD)
    jt = [jnp.asarray(t) for t in tokens]
    p = draw_params(types.SimpleNamespace(init=lambda key, t: jm.init(key, t, (h, w))), jt, seed=1)
    tm = load(tdpt.DPTPts3dHead(HOOK_DIMS, last_dim=16, with_conf=True, **HEAD), convert._pts3d_head, p)
    assert tm.dpt.head["4"].out_channels == 4
    with torch.no_grad():
        pts, conf = tm([torch.from_numpy(t) for t in tokens], (h, w))
    j_pts, j_conf = jax.jit(lambda p, t: jm.apply(p, t, (h, w)))(p, jt)
    assert pts.shape == (2, h, w, 3) and conf.shape == (2, h, w) and float(conf.min()) >= 1.0
    _scaled_close(pts.numpy(), j_pts)
    _scaled_close(conf.numpy(), j_conf)


@pytest.fixture(scope="module")
def teachers():
    """The JAX teacher, its numpy-drawn params, and the port's teacher with
    those params carried by from_jax_params, frozen."""
    jt = JTeacher(**TEACHER)
    params = draw_params(jt, jnp.zeros((1, 2, *HW, 3)), seed=1)
    tt = Dust3RTeacher(**TEACHER)
    tt.load_state_dict(from_jax_params(params, model="teacher"))
    return jt, params, tt.freeze()


def test_teacher_matches_jax(teachers):
    jt, params, tt = teachers
    images = np.random.default_rng(3).uniform(-1, 1, (2, 2, *HW, 3)).astype(np.float32)
    ref = jax.jit(jt.apply)(params, jnp.asarray(images))
    with torch.no_grad():
        out = tt(torch.from_numpy(images))
    assert sorted(out) == sorted(ref) == ["conf_1", "conf_2", "pts3d_1", "pts3d_2"]
    for key in ref:
        assert out[key].shape == ref[key].shape and out[key].dtype == torch.float32
        _scaled_close(out[key].numpy(), ref[key])
    # Both masks of the distillation loss have work to do at these weights.
    assert 0.05 < float((out["conf_1"] >= 3).float().mean()) < 0.95
    assert not tt.training and not any(p.requires_grad for p in tt.parameters())


def test_mast3r_checkpoint_loads_with_or_without_the_backbone_prefix(teachers):
    """A MASt3R `model` dict (backbone at the top level, no dec_blocks2, a
    local-feature head and the unused refinenet4.resConfUnit1 beside the
    DPTs) and a `backbone.`-prefixed one both load strictly."""
    _, _, tt = teachers
    sd = tt.state_dict()
    raw = {k[len("backbone."):] if k.startswith("backbone.") else k: v for k, v in sd.items()
           if ".dec_blocks2." not in k}
    raw["downstream_head1.head_local_features.fc1.weight"] = torch.zeros(4, 4)
    raw["downstream_head2.dpt.scratch.refinenet4.resConfUnit1.conv1.weight"] = torch.zeros(1)
    raw["mask_token"] = torch.zeros(1, 1, 32)
    for source in (raw, {k if k.startswith("downstream") else f"backbone.{k}": v for k, v in raw.items()}):
        fresh = Dust3RTeacher(**TEACHER)
        fresh.load_state_dict(convert_dust3r_checkpoint(source), strict=True)
        for k, v in fresh.state_dict().items():
            want = sd[k.replace(".dec_blocks2.", ".dec_blocks.")]
            assert torch.equal(v, want), k
    with pytest.raises(ValueError, match="downstream_head1"):
        convert_dust3r_checkpoint({k: v for k, v in raw.items() if not k.startswith("downstream")})


# --- the steps -------------------------------------------------------------------


@pytest.fixture
def no_dropout(monkeypatch):
    """Both packages without the gs towers' dropout, whose masks come from
    different generators (the distillation term does not read those towers)."""
    monkeypatch.setattr(tdpt, "GS_DROPOUT", 0.0)
    monkeypatch.setattr(fnn, "Dropout", lambda *args, **kwargs: (lambda x: x))


def _assert_step_matches(tm, grads_seen, metrics, j_metrics, j_params, flax_params, lr_of):
    assert float(metrics["loss"]) == pytest.approx(float(j_metrics["loss"]), rel=1e-5)
    assert float(metrics["distill"]) == pytest.approx(float(j_metrics["distill"]), rel=1e-5)
    assert float(metrics["distill"]) > 0
    assert float(metrics["grad_norm"]) == pytest.approx(float(j_metrics["grad_norm"]), rel=1e-3)

    def keep_patch_expand_bias(path, new, old):
        names = [getattr(k, "key", k) for k in path]
        return old if names[-1] == "bias" and {"act_0_up", "act_1_up"} & set(names) else new

    after = _to_port(jax.tree_util.tree_map_with_path(keep_patch_expand_bias, j_params, flax_params))
    clip = min(1.0, 0.5 / float(metrics["grad_norm"]))
    moved = 0
    for name, p in tm.named_parameters():
        if name.endswith(PATCH_EXPAND_BIAS):
            continue
        ours, theirs = p.detach().numpy(), after[name]
        g = grads_seen[name].numpy() * clip if name in grads_seen else np.zeros_like(ours)
        lr = lr_of(name)
        tol = 1e-6 * max(np.abs(theirs).max(), 1e-3) + np.where(np.abs(g) > 1e-6, 0.01 * lr, 0.5 * lr)
        np.testing.assert_array_less(np.abs(ours - theirs), tol + 1e-12, err_msg=name)
        moved += int((np.abs(g) > 1e-6).sum())
    assert moved > 10_000


def _port_step(flax_params, teacher, distill_only, **opt_kw):
    tm = Styl3rModel(sh_degree=1, device="cpu", **TINY)
    tm.load_state_dict(from_jax_params(flax_params))
    opt = tstep.make_optimizer(tm, lr=1e-3, warmup_steps=0, total_steps=5, **opt_kw)
    distill = tstep.DistillCfg(teacher=teacher, weight=0.1, max_steps=100, distill_only=distill_only)
    step = tstep.make_train_step(tm, opt, HW, stylized=False, distill=distill, **RENDER)
    grads_seen = {}
    for name, p in tm.named_parameters():
        p.register_hook(lambda g, name=name: grads_seen.__setitem__(name, g.detach().clone()))
    return tm, step, grads_seen


@pytest.fixture(scope="module")
def flax_params():
    """At random weights most Gaussians fall out of the targets' view: these
    params render 461 live pairs on STEP_BATCH's targets (seed 0 renders
    none on batch 7), so the step's photometric gradient is not empty."""
    jm = JModel(sh_degree=1, **TINY)
    return draw_params(jm, jax.tree.map(jnp.asarray, _train_batch(STEP_BATCH)), seed=1)


def test_distill_only_step_matches_jax(flax_params, teachers, no_dropout):
    """Stage 0: the encoder alone, Regr3D unweighted, the backbone at 0.1x
    lr (re10k_style_distill.yaml's optimizer); no render."""
    jt, teacher_params, tt = teachers
    batch = _train_batch(STEP_BATCH)
    jm = JModel(sh_degree=1, **TINY)
    tx = jstep.make_optimizer(lr=1e-3, warmup_steps=0, total_steps=5, params=flax_params, backbone_lr_multiplier=0.1)
    j_step = jax.jit(jstep.make_train_step(jm, tx, HW, stylized=False, distill=jstep.DistillCfg(
        teacher=jt, weight=0.1, max_steps=100, distill_only=True)))
    j_state = jstep.TrainState(flax_params, tx.init(flax_params), jnp.zeros((), jnp.int32))
    j_new, j_metrics = j_step(j_state, jax.tree.map(jnp.asarray, batch), jax.random.key(0), teacher_params)

    tm, step, grads_seen = _port_step(flax_params, tt, True, backbone_lr_multiplier=0.1)
    state = tstep.TrainState()
    metrics = step(state, batch_to(batch, "cpu"), torch.Generator().manual_seed(0))
    assert state.step == 1 and set(metrics) == set(j_metrics) == {"distill", "loss", "grad_norm"}
    assert float(metrics["loss"]) == float(metrics["distill"])
    # The render's heads and the stylizer get no gradient, as in JAX.
    assert not any(n.startswith(("encoder.gaussian", "encoder.token_stylizer")) for n in grads_seen)

    def lr_of(name):
        return 1e-4 if name.startswith("encoder.backbone.") else 1e-3

    _assert_step_matches(tm, grads_seen, metrics, j_metrics, j_new.params, flax_params, lr_of)


def test_stage1_distill_step_matches_jax(flax_params, teachers, no_dropout):
    """Stage 1 + the distillation term: the render's MSE plus 0.1 x Regr3D,
    through the compositor's plain versions here and JAX's impl="jnp"."""
    jt, teacher_params, tt = teachers
    batch = _train_batch(STEP_BATCH)
    jm = JModel(sh_degree=1, **TINY)
    tx = jstep.make_optimizer(lr=1e-3, warmup_steps=0, total_steps=5)
    j_step = jax.jit(jstep.make_train_step(
        jm, tx, HW, stylized=False, distill=jstep.DistillCfg(teacher=jt, weight=0.1, max_steps=100),
        impl="jnp", **RENDER))
    j_state = jstep.TrainState(flax_params, tx.init(flax_params), jnp.zeros((), jnp.int32))
    j_new, j_metrics = j_step(j_state, jax.tree.map(jnp.asarray, batch), jax.random.key(0), teacher_params)

    tm, step, grads_seen = _port_step(flax_params, tt, False)
    metrics = step(tstep.TrainState(), batch_to(batch, "cpu"), torch.Generator().manual_seed(0))
    assert float(metrics["mse"]) == pytest.approx(float(j_metrics["mse"]), rel=1e-5)
    assert float(metrics["loss"]) == pytest.approx(float(metrics["mse"]) + float(metrics["distill"]), rel=1e-6)
    assert 0 < int(metrics["live_pairs"]) <= int(metrics["pair_slots"])
    _assert_step_matches(tm, grads_seen, metrics, j_metrics, j_new.params, flax_params, lambda name: 1e-3)


def test_max_steps_gate_zeroes_the_term(flax_params, teachers):
    """Past distill_max_steps the term is 0 and adds nothing to the loss."""
    _, _, tt = teachers
    tm, step, _ = _port_step(flax_params, tt, False)
    metrics = step(tstep.TrainState(step=101), batch_to(_train_batch(STEP_BATCH), "cpu"), torch.Generator().manual_seed(0))
    assert float(metrics["distill"]) == 0.0
    assert float(metrics["loss"]) == float(metrics["mse"]) > 0


# --- the entry point ---------------------------------------------------------------


@pytest.fixture(scope="module")
def chunk_root(tmp_path_factory):
    """Two synthetic scenes of 30 noise frames at 72x96 (tests/test_data.py)."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("re10k_distill")
    (root / "train").mkdir()
    torch.save([make_scene(rng, f"scene_{i}") for i in range(2)], root / "train" / "000000.torch")
    style = root / "styles" / "train"
    style.mkdir(parents=True)
    Image.fromarray((rng.uniform(0, 1, (40, 60, 3)) * 255).astype(np.uint8)).save(style / "style0.jpg")
    (style / "scene_style_mapping_all.json").write_text(json.dumps({f"scene_{i}": "style0.jpg" for i in range(2)}))
    return root


def test_main_runs_the_distillation_stage(chunk_root, tmp_path, capsys):
    """`python -m styl3r_tpu_torch.train.main --cpu --config
    re10k_style_distill.yaml` on tiny widths: 2 logged steps with the
    distillation term, no validation though one is due every step, and
    checkpoints that hold the student alone."""
    model = Styl3rModel(sh_degree=0, device="cpu", **TINY)
    teacher = Dust3RTeacher(**TEACHER)
    out = tmp_path / "out"
    state = train_main.main([
        "--config", "configs/experiment/re10k_style_distill.yaml", "--cpu", "--max-steps", "2",
        f"datasets.0.roots=[{chunk_root}]", f"datasets.0.style_root={chunk_root / 'styles'}",
        "datasets.0.original_image_shape=[72,96]", "datasets.0.input_image_shape=[16,16]",
        "datasets.0.view_sampler.min_gap=10", "datasets.0.view_sampler.max_gap=20", "train.batch_size=2",
        "train.val_every_n_steps=1", "train.log_every_n_steps=1", "checkpointing.every_n_train_steps=1",
        f"checkpointing.output_dir={out}",
    ], model=model, teacher=teacher)
    assert state.step == 2
    assert "teacher will be RANDOMLY INITIALIZED" in capsys.readouterr().out
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(r["distill"] == r["loss"] > 0 and "grad_norm" in r for r in steps)
    assert all(r["step_ms"] >= r["forward_ms"] >= r["teacher_ms"] > 0 for r in steps)  # the logged spans
    assert not any("val_psnr" in r or "validate_seconds" in r for r in records)
    assert not (out / "val_comparison").exists()
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["final.pt", "step_1.pt", "step_2.pt"]
    for name in ("step_1.pt", "final.pt"):
        ckpt = torch.load(out / "checkpoints" / name, weights_only=True)
        assert ckpt["model"].keys() == model.state_dict().keys()
        assert all(k.startswith("encoder.") for k in ckpt["model"])
        # Stage 0 trains the whole student, and nothing else.
        assert len(ckpt["optimizer"]["adamw"]["state"]) == len(list(model.parameters()))
    assert not any(p.requires_grad for p in teacher.parameters())
