"""Data parallelism in styl3r_tpu_torch (parallel/mesh.py, the train step,
the trainer and train.main) on the CPU: 2 ranks over gloo, started by
torch.multiprocessing.spawn, one torch thread each; the train steps' ranks
meet through a file:// rendezvous under tmp_path, train.main's through
torchrun's environment (MASTER_ADDR/MASTER_PORT on a free local port).
JAX is imported inside the test functions only: the spawned children import
this module and must not start it.

  * The 2-rank step equals the 1-process step on the same global batch:
    stage 1 + distillation (MSE + Regr3D) with the gs towers' dropout live, 2
    steps on a global batch of 4 split 2/2. Each step's losses and grad_norm
    within 1e-5 relative (measured 1.3e-7 and 2e-6: the same f32 arithmetic,
    summed in another order, each rank's half and the all-reduce's sum of
    the halves); the averaged gradients within 1e-3 of each tensor's largest
    magnitude (measured 3.5e-4: CPU convolutions round otherwise at batch 2
    than at 4, and the backward amplifies it through expm1 and the
    renderer's divisions by 1 - alpha, as tests/test_torch_train_step.py
    says); the weights after the second update within 1e-5 of each tensor's
    largest magnitude plus 0.01 of the learning rate where Adam's
    bias-corrected first moment of the clipped gradients exceeds 1e-5 (1000
    * eps), and 0.5 of it elsewhere (measured 0.0053 and 0.082: AdamW moves
    a weight by lr * m / (sqrt(v) + eps), which where m is small turns the
    gradients' rounding into a share of lr; tests/test_torch_distill.py's
    reason). The first update's learning rate is 0 (one warm-up step), so
    the second step's loss and gradients are taken at the same weights in
    both runs, and its loss holds step 2's dropout masks too. The ranks'
    weights are equal bit for bit. The two halves' Regr3D valid counts
    differ, so a per-rank ratio would fail it.
  * The same global batch against JAX, dropout off (make_train_step hard-codes
    live dropout, so the JAX reference is built from the step's pieces): its
    render under shard_data on 2 of conftest's 8 CPU devices. The loss 1e-4
    relative, each gradient 2e-3 of its tensor's largest magnitude and the
    global norm 1e-3 relative: tests/test_torch_train_step.py's tolerances
    (the f32 model sums in other orders in XLA and PyTorch, and the backward
    passes through expm1 and the renderer's divisions by 1 - alpha).
  * Stage 2 (style + identity, VGG19 at random weights) on 2 ranks against
    the 1-process step on the whole batch of 4, dropout off, one step at
    learning rate 0. The losses and VGG run in float64 (the loss bundle
    takes the f32 renders and images up); the encoder, batch_to and the
    renderer fix f32, so the gradients' tolerance is that f32 rounding,
    measured as the distance between the whole batch's 1-process gradients
    and the mean of its two halves' (each rank's own gradients before the
    all-reduce, on one thread as the whole batch's; bounded itself by 1e-3
    of each tensor's largest magnitude, stage 1's bound, which a term that
    couples the examples of a batch, or a rank on the wrong rows, would
    exceed): the 2 ranks' averaged gradients lie within twice that distance
    of the whole batch's, plus 1e-6 of scale, and within 1e-6 of scale of
    the halves' mean; the loss within 1e-5 relative; the gradient norm
    within the gradients' L2 distance.
  * The all-reduce's None-pattern check: two ranks that leave different
    parameters without a gradient raise on both, even where their
    gradients' element totals are equal.
  * pair_cap_per_gaussian is per rank: with a cap that truncates, each rank's
    render keeps the pair slots and renders what the JAX sharded render's
    shard does (live pairs and slots equal; images within 1e-5).
  * train.main --cpu under 2 ranks, 2 steps: one checkpoint file a save,
    holding both ranks' stream positions; a resume at world size 2 continues both streams
    exactly (bit for bit, as the single-rank resume in test_torch_trainer.py);
    a resume at world size 1 restarts the stream and says why; a global
    batch that the ranks do not divide raises.
"""

import io
import json
import os
import socket
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from PIL import Image

from styl3r_tpu_torch.geometry.gaussians import Gaussians
from styl3r_tpu_torch.losses.vgg import VGG19Features
from styl3r_tpu_torch.losses.regr3d import _quantile_mask
from styl3r_tpu_torch.models import dpt as tdpt
from styl3r_tpu_torch.models.decoder import render_gaussians
from styl3r_tpu_torch.models.distiller import Dust3RTeacher
from styl3r_tpu_torch.models.styl3r import Batch, Styl3rModel, batch_to, normalize_images
from styl3r_tpu_torch.parallel import DataGroup, all_reduce_grads_, shard_batch
from styl3r_tpu_torch.train import step as tstep
from styl3r_tpu_torch.train.losses import LossBundle
from styl3r_tpu_torch.train.scratch_init import scratch_init_heads
from styl3r_tpu_torch.train.trainer import step_generator
from styl3r_tpu_torch.utils.convert import init_like_flax_

WORLD = 2
HW = (32, 32)
TINY = dict(
    enc_depth=1, dec_depth=2, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2,
    head_feature_dim=16, head_last_dim=16, head_layer_dims=(8, 8, 16, 16),
)
TEACHER = dict(TINY, head_last_dim=8)
RENDER = dict(max_tiles_per_gaussian=8, max_per_tile=512, pair_cap_per_gaussian=2)
CAP_RENDER = dict(max_tiles_per_gaussian=8, max_per_tile=512, pair_cap_per_gaussian=1)
K = np.asarray([[0.9, 0, 0.5], [0, 1.1, 0.45], [0, 0, 1.0]], np.float32)


def _global_batch(seed, b=4):
    rng = np.random.default_rng(seed)
    ext = np.tile(np.eye(4, dtype=np.float32), (b, 2, 1, 1))
    ext[:, 1, 0, 3] = 0.05
    return Batch(
        context_images=rng.uniform(0, 1, (b, 2, *HW, 3)).astype(np.float32),
        context_intrinsics=np.tile(K, (b, 2, 1, 1)),
        target_extrinsics=ext,
        target_intrinsics=np.tile(K, (b, 2, 1, 1)),
        target_near=np.full((b, 2), 0.1, np.float32),
        target_far=np.full((b, 2), 100.0, np.float32),
        style_image=rng.uniform(0, 1, (b, *HW, 3)).astype(np.float32),
        target_images=rng.uniform(0, 1, (b, 2, *HW, 3)).astype(np.float32),
    )


def _cap_scene(seed, b=4, v=2, g=64):
    """Gaussians large enough to cover several 16x16 tiles of a 32x32 view
    each, so one pair slot a (view, Gaussian) truncates."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 3.0, (b, g))
    means = np.stack([rng.uniform(-0.4, 0.4, (b, g)) * z, rng.uniform(-0.4, 0.4, (b, g)) * z, z], -1)
    ext = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    ext[:, :, 0, 3] = 0.05 * np.arange(v)
    return dict(
        means=means.astype(np.float32),
        scales=rng.uniform(0.05, 0.3, (b, g, 3)).astype(np.float32),
        rotations=rng.normal(size=(b, g, 4)).astype(np.float32),
        harmonics=rng.normal(scale=0.5, size=(b, g, 3, 1)).astype(np.float32),
        opacities=rng.uniform(0.3, 0.9, (b, g)).astype(np.float32),
        extrinsics=ext,
        intrinsics=np.tile(K, (b, v, 1, 1)),
        near=np.full((b, v), 0.1, np.float32),
        far=np.full((b, v), 100.0, np.float32),
    )


def _port_render(scene, rank=0, world=1):
    from styl3r_tpu_torch.geometry.gaussians import build_covariance

    n = scene["means"].shape[0] // world
    t = {k: torch.from_numpy(v[rank * n:(rank + 1) * n]) for k, v in scene.items()}
    gaussians = Gaussians(
        t["means"], build_covariance(t["scales"], t["rotations"]), t["harmonics"], t["opacities"],
        t["scales"], t["rotations"],
    )
    out = render_gaussians(gaussians, t["extrinsics"], t["intrinsics"], t["near"], t["far"], HW, **CAP_RENDER)
    return {k: getattr(out, k).numpy() for k in ("color", "alpha", "live_pairs", "pair_slots")}


def _models(seed=0):
    """A tiny student with scratch-initialized heads (its Gaussians land in
    the targets' view) and a frozen tiny teacher, both drawn on the CPU."""
    model = Styl3rModel(sh_degree=1, device="cpu", seed=seed, **TINY)
    scratch_init_heads(model)
    teacher = Dust3RTeacher(**TEACHER)
    init_like_flax_(teacher, torch.Generator().manual_seed(2))
    return model, teacher.freeze()


LR = 1e-3


def _steps(weights, teacher_weights, batch, data, steps, distill, grad_clip=0.5):
    """`steps` train steps of stage 1 (MSE, and with `distill` 0.1 x Regr3D)
    from `weights`, the first at learning rate 0: on the whole batch, or with
    `data` on the rank's rows. Returns each step's metrics, the weights
    after, and each step's gradients (after the all-reduce, before the
    clip)."""
    model = Styl3rModel(sh_degree=1, device="cpu", **TINY)
    model.load_state_dict(weights)
    if data is not None:
        tdpt.shard_dropout_(model, data.rank, data.world)
        batch = shard_batch(batch, data.rank, data.world)
    cfg = None
    if distill:
        teacher = Dust3RTeacher(**TEACHER)
        teacher.load_state_dict(teacher_weights)
        cfg = tstep.DistillCfg(teacher=teacher.freeze(), weight=0.1, max_steps=100)
    opt = tstep.make_optimizer(model, lr=LR, warmup_steps=1, total_steps=5, grad_clip=grad_clip)
    step = tstep.make_train_step(model, opt, HW, stylized=False, distill=cfg, data=data, **RENDER)
    state, metrics, grads = tstep.TrainState(), [], []
    for i in range(steps):
        out = step(state, batch_to(batch, "cpu"), step_generator(1, i, torch.device("cpu")))
        metrics.append({k: float(v) for k, v in out.items()})
        # The clip scaled the averaged gradients in place.
        unclip = max(1.0, metrics[-1]["grad_norm"] / grad_clip)
        grads.append({n: p.grad.detach() * unclip for n, p in model.named_parameters()})
    return metrics, {n: p.detach().clone() for n, p in model.named_parameters()}, grads


def _vgg():
    """VGG19 at random weights from a fixed seed, in float64, frozen."""
    vgg = VGG19Features()
    init_like_flax_(vgg, torch.Generator().manual_seed(5))
    return vgg.double().requires_grad_(False)


def _f64_losses(bundle):
    """The loss bundle on float64 copies of the renders and images."""

    def up(output):
        return None if output is None else output._replace(color=output.color.double())

    def loss_fn(output, batch, gaussians, global_step=0, identity_output=None):
        batch = batch._replace(target_images=batch.target_images.double(), style_image=batch.style_image.double())
        return bundle(up(output), batch, gaussians, global_step, up(identity_output))

    return loss_fn


def _stage2_step(weights, batch, data):
    """One stage-2 step (style 10 + identity, learning rate 0, no clip) from
    `weights` on the whole batch, or with `data` on the rank's rows, with
    the gs towers' dropout off. Returns its metrics, the trained parameters'
    gradients (averaged over the ranks with `data`) and, with `data`, the
    rank's own gradients before the all-reduce: its rows' 1-process
    gradients."""
    model = Styl3rModel(sh_degree=1, device="cpu", **TINY)
    model.load_state_dict(weights)
    if data is not None:
        batch = shard_batch(batch, data.rank, data.world)
    opt = tstep.make_stage2_optimizer(model, lr=LR, warmup_steps=1, total_steps=5, grad_clip=float("inf"))
    losses = _f64_losses(LossBundle(mse_weight=None, style_weight=10.0, identity=True, vgg19=_vgg()))
    step = tstep.make_train_step(model, opt, HW, loss_fn=losses, stylized=True, identity_branch=True, data=data,
                                 **RENDER)
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    local = {}

    def keep(name):
        def hook(p):
            local[name] = p.grad.detach().clone()
        return hook

    for name, p in trained.items():
        p.register_post_accumulate_grad_hook(keep(name))
    out = step(tstep.TrainState(), batch_to(batch, "cpu"), step_generator(1, 0, torch.device("cpu")))
    grads = {n: p.grad.detach().clone() for n, p in trained.items()}
    return {k: float(v) for k, v in out.items()}, grads, local


def _none_pattern_error(data):
    """all_reduce_grads_ where rank 0 holds the first of two 3-element
    parameters' gradients and rank 1 the second: equal element totals, the
    old count check's blind spot. Returns the error's message, or None."""
    params = [torch.nn.Parameter(torch.ones(3)) for _ in range(2)]
    params[data.rank].grad = torch.ones(3)
    try:
        all_reduce_grads_(params, data)
    except RuntimeError as exc:
        return str(exc)
    return None


def _step_child(rank, workdir, dropout_for_jax):
    """One rank of the step checks: (a) 2 live-dropout steps of stage 1 +
    distillation, (b) with the gs towers' dropout at `dropout_for_jax` (the
    JAX reference runs without it; a monkeypatch in the parent does not reach
    this process) one MSE step without a clip and one stage-2 step, (c) the
    capped render of its rows of a synthetic scene, (d) the None-pattern
    check on unlike patterns."""
    torch.set_num_threads(1)
    workdir = Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'rendezvous'}", rank=rank, world_size=WORLD)
    try:
        inputs = torch.load(workdir / "inputs.pt", weights_only=False)
        data = DataGroup(rank, WORLD)
        live = _steps(inputs["weights"], inputs["teacher"], inputs["batch"], data, 2, distill=True)
        tdpt.GS_DROPOUT = dropout_for_jax
        plain = _steps(inputs["weights"], None, inputs["batch"], data, 1, distill=False, grad_clip=float("inf"))
        stage2 = _stage2_step(inputs["weights"], inputs["batch"], data)
        torch.save({"live": live, "plain": plain, "stage2": stage2, "render": _port_render(inputs["scene"], rank, WORLD),
                    "none_pattern": _none_pattern_error(data)}, workdir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs (weights, teacher, global batch, capped scene) and what
    each of 2 ranks made of them."""
    workdir = tmp_path_factory.mktemp("parallel_step")
    model, teacher = _models()
    inputs = dict(weights=model.state_dict(), teacher=teacher.state_dict(), batch=_global_batch(3),
                  scene=_cap_scene(4))
    torch.save(inputs, workdir / "inputs.pt")
    mp.spawn(_step_child, args=(str(workdir), 0.0), nprocs=WORLD)
    return inputs, [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def to_flax(state_dict):
    """The port's state dict -> flax params through the JAX package's own
    converter (convert_styl3r_encoder). The converter reads the DPTs'
    refinenet4.resConfUnit1, which neither model uses: it is filled in with
    zeros and dropped from the result (tests/test_torch_model.py)."""
    from styl3r_tpu.utils.checkpoint import convert_styl3r_encoder

    sd = {k: v.numpy() for k, v in state_dict.items()}
    heads = {k.split(".")[1] for k in sd if ".dpt.scratch." in k}
    for head in heads:
        dim = sd[f"encoder.{head}.dpt.scratch.refinenet4.out_conv.weight"].shape[1]
        for conv in ("conv1", "conv2"):
            p = f"encoder.{head}.dpt.scratch.refinenet4.resConfUnit1.{conv}"
            sd[f"{p}.weight"] = np.zeros((dim, dim, 3, 3), np.float32)
            sd[f"{p}.bias"] = np.zeros((dim,), np.float32)
    params = convert_styl3r_encoder(sd)
    for head in params["params"].values():
        if "trunk" in head:
            del head["trunk"]["refinenet4"]["resConfUnit1"]
    return params


def _close_to_scale(ours, theirs, rel, what):
    scale = max(float(theirs.abs().max()), 1e-12)
    err = float((ours - theirs).abs().max())
    assert err <= rel * scale, (what, err, scale)


def test_two_rank_step_equals_the_one_process_step(ranks):
    inputs, out = ranks
    batch = inputs["batch"]
    # The halves' valid Regr3D points differ in number: a per-rank ratio of
    # sums averaged over the ranks would be another loss than the global one.
    teacher = Dust3RTeacher(**TEACHER)
    teacher.load_state_dict(inputs["teacher"])
    with torch.no_grad():
        pseudo = teacher.freeze()(normalize_images(torch.from_numpy(batch.context_images[:, :2])))
    valid = sum((_quantile_mask(pseudo[f"pts3d_{i}"]) & (pseudo[f"conf_{i}"] >= 3.0)).sum(dim=(1, 2))
                for i in (1, 2))
    halves = [int(valid[:2].sum()), int(valid[2:].sum())]
    assert halves[0] != halves[1] and min(halves) > 0, halves

    metrics, params, grads = _steps(inputs["weights"], inputs["teacher"], batch, None, 2, distill=True)
    assert all(m["live_pairs"] > 0 and m["distill"] > 0 for m in metrics)
    clips = [min(1.0, 0.5 / m["grad_norm"]) for m in metrics]
    for r, rank in enumerate(out):
        rank_metrics, rank_params, rank_grads = rank["live"]
        for i, (want, got) in enumerate(zip(metrics, rank_metrics)):
            for k in ("loss", "mse", "distill", "grad_norm"):
                assert got[k] == pytest.approx(want[k], rel=1e-5), (r, i, k)
            assert got["allreduce_bytes"] == 4 * sum(p.numel() for p in params.values())
            for name, g in grads[i].items():
                _close_to_scale(rank_grads[i][name], g, 1e-3, (r, i, name))
        for name, want in params.items():
            first_moment = (0.9 * 0.1 * clips[0] * grads[0][name] + 0.1 * clips[1] * grads[1][name]) / (1 - 0.9**2)
            tol = 1e-5 * float(want.abs().max()) + torch.where(first_moment.abs() > 1e-5, 0.01 * LR, 0.5 * LR)
            assert ((rank_params[name] - want).abs() <= tol).all(), (r, name)
    # Both ranks hold the same weights.
    for name, p in out[0]["live"][1].items():
        assert torch.equal(p, out[1]["live"][1][name]), name


def test_two_rank_stage2_step_equals_the_one_process_step(ranks, monkeypatch):
    """Measured on the CPU: the ranks' gradients equal the mean of their
    own rows' gradients exactly and lie up to 3.7e-4 of scale from the
    whole batch's, which is that mean's own distance from it; the loss
    5e-8 relative."""
    inputs, out = ranks
    monkeypatch.setattr(tdpt, "GS_DROPOUT", 0.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    try:
        whole, g_whole, _ = _stage2_step(inputs["weights"], inputs["batch"], None)
    finally:
        torch.set_num_threads(threads)
    assert whole["style"] > 0 and whole["identity"] > 0 and len(g_whole) > 20
    g_halves = {n: sum(rank["stage2"][2][n] for rank in out) / WORLD for n in g_whole}
    for r, rank in enumerate(out):
        metrics, grads, _ = rank["stage2"]
        assert sorted(grads) == sorted(g_whole)
        assert metrics["loss"] == pytest.approx(whole["loss"], rel=1e-5)
        # | |G2| - |G1| | <= |G2 - G1|, up to the norms' own rounding.
        gap = float(torch.sqrt(sum(((grads[n] - g).double() ** 2).sum() for n, g in g_whole.items())))
        assert abs(metrics["grad_norm"] - whole["grad_norm"]) <= gap + 1e-6 * whole["grad_norm"]
        for name, want in g_whole.items():
            scale = float(want.abs().max())
            rounding = float((g_halves[name] - want).abs().max())
            assert rounding <= 1e-3 * scale, (name, rounding, scale)
            _close_to_scale(grads[name], g_halves[name], 1e-6, (r, name))
            err = float((grads[name] - want).abs().max())
            assert err <= 2 * rounding + 1e-6 * scale, (r, name, err, rounding, scale)


def test_all_reduce_refuses_unlike_none_patterns_with_equal_totals(ranks):
    """Rank 0 held only the first parameter's gradient and rank 1 only the
    second's, 3 elements each: both raised, naming the first index that
    differs."""
    _, out = ranks
    for r, rank in enumerate(out):
        message = rank["none_pattern"]
        assert message is not None, r
        assert f"rank {r}: 3 gradient elements in 1 of 2 parameters" in message
        assert "between 3 and 3 elements" in message and "the first at parameter index 0" in message


def test_two_rank_step_matches_the_jax_mesh_step(ranks):
    """The JAX step's loss and gradients on the global batch, its render run
    under shard_data over a 2-device data mesh, against the 2 ranks'
    reduced loss and averaged gradients (both packages without dropout)."""
    import jax
    import jax.numpy as jnp

    from styl3r_tpu.models.styl3r import Styl3rModel as JModel
    from styl3r_tpu.parallel.mesh import batch_sharding, make_mesh, replicated_sharding
    from test_torch_train import _to_port

    inputs, out = ranks
    mesh = make_mesh(2)
    params = jax.device_put(to_flax(inputs["weights"]), replicated_sharding(mesh))
    batch = inputs["batch"]
    jb = jax.device_put(Batch(*batch[:8])._replace(style_image=batch.context_images[:, 0]), batch_sharding(mesh))
    jm = JModel(sh_degree=1, **TINY)

    def loss_fn(p, b):
        _, output = jm.forward(p, b, HW, global_step=0, deterministic=True, impl="jnp",
                               shard_data=(mesh, "data"), **RENDER)
        return jnp.mean((output.color - b.target_images) ** 2)

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params, jb)
    j_grads = _to_port(j_grads, grads=True)
    for rank in out:
        metrics, _, (grads,) = rank["plain"]
        assert metrics[0]["loss"] == pytest.approx(float(j_loss), rel=1e-4)
        trained = [n for n in grads if n in j_grads]
        assert len(trained) == len(grads) > 50
        for name in trained:
            _close_to_scale(grads[name], torch.from_numpy(j_grads[name]), 2e-3, name)
        j_norm = float(np.sqrt(sum(float((j_grads[n].astype(np.float64) ** 2).sum()) for n in trained)))
        assert metrics[0]["grad_norm"] == pytest.approx(j_norm, rel=1e-3)


def test_pair_cap_is_per_rank(ranks):
    """Each rank derives its cap from its own views and Gaussians, as the
    JAX render does per shard under shard_data: one slot a (view, Gaussian)
    truncates here, and a cap over the global batch would keep twice the
    slots."""
    import jax
    import jax.numpy as jnp

    from styl3r_tpu.geometry.gaussians import Gaussians as JGaussians
    from styl3r_tpu.geometry.gaussians import build_covariance
    from styl3r_tpu.models.decoder import render_gaussians as j_render
    from styl3r_tpu.parallel.mesh import batch_sharding, make_mesh

    inputs, out = ranks
    s = inputs["scene"]
    mesh = make_mesh(2)
    placed = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh)) for k, v in s.items()}

    def render(sc):
        g = JGaussians(sc["means"], build_covariance(sc["scales"], sc["rotations"]), sc["harmonics"],
                       sc["opacities"], sc["scales"], sc["rotations"])
        return j_render(g, sc["extrinsics"], sc["intrinsics"], sc["near"], sc["far"], HW, impl="jnp",
                        shard_data=(mesh, "data"), **CAP_RENDER)

    ref = jax.jit(render)(placed)
    n = s["means"].shape[0] // WORLD
    for r, rank in enumerate(out):
        got = rank["render"]
        rows = slice(r * n, (r + 1) * n)
        live, slots = np.asarray(ref.live_pairs)[rows], np.asarray(ref.pair_slots)[rows]
        np.testing.assert_array_equal(got["live_pairs"], live)
        np.testing.assert_array_equal(got["pair_slots"], slots)
        assert (live > slots).all() and (slots == 128 * -(-2 * 64 * n // 128)).all()
        for k in ("color", "alpha"):
            np.testing.assert_allclose(got[k], np.asarray(getattr(ref, k))[rows], rtol=1e-5, atol=1e-5)
    # The whole batch in one render keeps the global batch's slots.
    assert int(_port_render(s)["pair_slots"][0, 0]) == 2 * int(out[0]["render"]["pair_slots"][0, 0])


# --- train.main under 2 ranks ------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jpeg(rng, hw=(72, 96)):
    buf = io.BytesIO()
    Image.fromarray((rng.uniform(0, 1, (*hw, 3)) * 255).astype(np.uint8)).save(buf, format="JPEG")
    return bytearray(buf.getvalue())


@pytest.fixture(scope="module")
def chunk_root(tmp_path_factory):
    """One chunk of three synthetic scenes (30 noise frames of 72x96, the
    camera sliding along x; tests/test_data.py's) and a style root."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("re10k_parallel")
    (root / "train").mkdir()
    cameras = np.zeros((30, 18), np.float32)
    cameras[:, :4] = 0.8, 0.9, 0.5, 0.5
    w2c = np.tile(np.eye(4, dtype=np.float32), (30, 1, 1))
    w2c[:, 0, 3] = -0.05 * np.arange(30)
    cameras[:, 6:] = w2c[:, :3].reshape(30, 12)
    scenes = [{"key": f"scene_{i}", "cameras": torch.from_numpy(cameras),
               "images": [torch.frombuffer(_jpeg(rng), dtype=torch.uint8) for _ in range(30)], "url": ""}
              for i in range(3)]
    torch.save(scenes, root / "train" / "000000.torch")
    style = root / "styles" / "train"
    style.mkdir(parents=True)
    Image.fromarray((rng.uniform(0, 1, (40, 60, 3)) * 255).astype(np.uint8)).save(style / "style0.jpg")
    (style / "scene_style_mapping_all.json").write_text(json.dumps({f"scene_{i}": "style0.jpg" for i in range(3)}))
    return root


def _main(chunk_root, out, max_steps, *extra):
    """train.main --cpu on the paper's stage 2 at tiny widths
    (tests/test_torch_trainer.py::_main's arguments), a global batch of 2,
    a checkpoint every step keeping 1, and a moving curriculum."""
    from styl3r_tpu_torch.train import main as train_main

    args = [
        "--config", "configs/experiment/re10k_3view_style.yaml", "--cpu", "--max-steps", str(max_steps),
        f"datasets.0.roots=[{chunk_root}]", f"datasets.0.style_root={chunk_root / 'styles'}",
        "datasets.0.original_image_shape=[72,96]", "datasets.0.input_image_shape=[16,16]",
        "datasets.0.view_sampler.num_context_views=2", "datasets.0.view_sampler.num_target_views=2",
        "datasets.0.view_sampler.min_gap=10", "datasets.0.view_sampler.max_gap=20",
        "datasets.0.view_sampler.warm_up_steps=3", "datasets.0.view_sampler.initial_min_gap=4",
        "datasets.0.view_sampler.initial_max_gap=6",
        "train.batch_size=2", "train.val_every_n_steps=100", "train.log_every_n_steps=1",
        "checkpointing.every_n_train_steps=1", "checkpointing.save_top_k=1", f"checkpointing.output_dir={out}",
        "model.decoder.max_per_tile=128", "model.decoder.max_tiles_per_gaussian=4", *extra,
    ]
    return train_main.main(args, model=Styl3rModel(sh_degree=0, device="cpu", seed=0, **TINY))


def _main_child(rank, chunk_root, out, ports):
    """One rank of `python -m styl3r_tpu_torch.train.main --cpu` under
    torchrun's environment: 2 steps, 1 step, a resume of that to step 2,
    and a global batch of 3, each run with a rendezvous port of its own."""
    torch.set_num_threads(1)
    chunk_root, out = Path(chunk_root), Path(out)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1")
    resume = (f"checkpointing.load={out / 'part' / 'checkpoints' / 'step_1.pt'}", "checkpointing.resume=true")
    for port, (where, steps, extra) in zip(ports, [("whole", 2, ()), ("part", 1, ()), ("part", 2, resume)]):
        os.environ["MASTER_PORT"] = str(port)
        if _main(chunk_root, out / where, steps, *extra).step != steps:
            raise AssertionError(f"rank {rank}: {where} stopped short of step {steps}")
    os.environ["MASTER_PORT"] = str(ports[-1])
    try:
        _main(chunk_root, out / "odd", 1, "train.batch_size=3")
    except ValueError as exc:
        (out / f"odd_rank{rank}.txt").write_text(str(exc))
    if dist.is_initialized():
        raise AssertionError("train.main left its process group")


def _records(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_main_runs_two_ranks_and_resumes_each_stream(chunk_root, tmp_path, capsys):
    mp.spawn(_main_child, args=(str(chunk_root), str(tmp_path), [_free_port() for _ in range(4)]), nprocs=WORLD)

    # One file a save, by rank 0, holding both ranks' stream positions.
    part = tmp_path / "part" / "checkpoints"
    assert sorted(p.name for p in part.iterdir()) == ["final.pt", "step_2.pt"]
    positions = torch.load(tmp_path / "whole" / "checkpoints" / "step_2.pt", weights_only=True)["data"]
    assert len(positions) == WORLD and all(p is not None for p in positions)
    assert positions[0]["datasets"][0] != positions[1]["datasets"][0]

    def logged(out):
        # Host and device times, the step's spans among them, differ run to run.
        return [{k: v for k, v in r.items() if k not in ("seconds_per_step", "data_seconds") and not k.endswith("_ms")}
                for r in _records(out) if "loss" in r]

    assert [r["step"] for r in logged(tmp_path / "whole")] == [1, 2]
    assert logged(tmp_path / "part") == logged(tmp_path / "whole")  # step 1, then the resumed step 2
    assert all(r["allreduce_bytes"] > 0 for r in logged(tmp_path / "whole"))
    # The logged steps' spans (utils/trace.py): the step and its all-reduce.
    assert all(r["step_ms"] > r["allreduce_ms"] >= 0 for r in _records(tmp_path / "whole") if "loss" in r)
    resumed = torch.load(part / "final.pt", weights_only=True)
    for key, value in torch.load(tmp_path / "whole" / "checkpoints" / "final.pt", weights_only=True)["model"].items():
        assert torch.equal(value, resumed["model"][key]), key

    # Each rank raised on a global batch of 3.
    for r in range(WORLD):
        assert "train.batch_size=3 is the global batch" in (tmp_path / f"odd_rank{r}.txt").read_text()

    # One process resuming the 2-rank checkpoint starts its stream anew.
    capsys.readouterr()
    state = _main(chunk_root, tmp_path / "single", 3, f"checkpointing.load={part / 'final.pt'}",
                  "checkpointing.resume=true")
    assert state.step == 3 and [r["step"] for r in logged(tmp_path / "single")] == [3]
    assert "was written by 2 ranks and this run has 1: the data stream starts from its beginning" in capsys.readouterr().out


def test_main_under_torchrun_needs_cuda_unless_told_cpu(monkeypatch, tmp_path):
    """Under torchrun's environment without --cpu, train.main asks for the
    card LOCAL_RANK and raises without CUDA, before any process group."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: main runs there")
    from styl3r_tpu_torch.train import main as train_main

    for key, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main.main(["--config", "configs/main.yaml", f"checkpointing.output_dir={tmp_path}"])
    assert not dist.is_initialized()


def test_step_metrics_reduce_by_kind():
    """reduce_metrics over one rank (gloo, in this process): live_pairs by
    max, pair_slots by min, the rest by mean, each in its dtype; the
    all-reduce refuses ranks whose steps left different gradients None."""
    from styl3r_tpu_torch.parallel import all_reduce_grads_, reduce_metrics

    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        data = DataGroup(0, 1)
        metrics = {"loss": torch.tensor(2.5), "live_pairs": torch.tensor(7, dtype=torch.int32),
                   "pair_slots": torch.tensor(50_331_649, dtype=torch.int32)}
        out = reduce_metrics(metrics, data)
        assert {k: (v.item(), v.dtype) for k, v in out.items()} == {k: (v.item(), v.dtype) for k, v in metrics.items()}
        p = torch.nn.Parameter(torch.ones(3))
        p.grad = torch.full((3,), 2.0)
        assert all_reduce_grads_([p, torch.nn.Parameter(torch.ones(2))], data) == 12
        assert torch.equal(p.grad, torch.full((3,), 2.0))
    finally:
        dist.destroy_process_group()
