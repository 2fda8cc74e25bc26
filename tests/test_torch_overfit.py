"""The scene-overfit entry point (styl3r_tpu_torch/train/overfit_colmap.py)
on the CPU against scripts/overfit_colmap.py, imported unedited: its
module-level functions are called as they are, and the pieces that live
inside its `main` (the samplers, the stage-2 style draw, `stage1_loss`,
the record's keys) are read from its source with `ast` and run from there.

Tolerances: scene arrays and batches 1e-6 (the same numpy and PIL calls;
only the final f32 conversion differs), anchor indices and masks exact. One
stage-1 step as tests/test_torch_train_step.py holds one: loss and metrics
1e-4 relative, gradients 2e-3 of each tensor's largest magnitude, params
after the update 1e-6 of theirs; the held-out PSNR 1e-3 dB (the loss's
1e-4 relative times 10 / ln 10). The file runs on one torch thread and
compiles one JAX function."""

import argparse
import ast
import importlib.util
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from styl3r_tpu.models.styl3r import Batch as JBatch
from styl3r_tpu.models.styl3r import Styl3rModel as JModel
from styl3r_tpu.train import scratch_init as jsi
from styl3r_tpu.train import step as jstep
from styl3r_tpu_torch.models import dpt as tdpt
from styl3r_tpu_torch.models.styl3r import Styl3rModel as TModel
from styl3r_tpu_torch.train import overfit_colmap as oc
from styl3r_tpu_torch.train import step as tstep
from styl3r_tpu_torch.utils.convert import from_jax_params
from test_torch_model import ROOT, draw_params
from test_torch_train import _to_port

SCRIPT = ROOT / "scripts" / "overfit_colmap.py"
SIZE = 32
N_FRAMES = 12
# A 12-frame scene fits context gaps up to 5: n - 2g must stay positive.
FLAGS = dict(gap_min=2, gap_max=4, targets=2, eval_gap=5, holdout_every=4, batch=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jscript():
    spec = importlib.util.spec_from_file_location("overfit_colmap_script", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _main_body():
    tree = ast.parse(SCRIPT.read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main").body


def _assigned(node):
    return {t.id for t in getattr(node, "targets", []) if isinstance(t, ast.Name)}


def _run(nodes, namespace):
    """Executes statements taken from the script's `main` in `namespace`."""
    exec(compile(ast.Module(body=list(nodes), type_ignores=[]), str(SCRIPT), "exec"), namespace)
    return namespace


def _script_samplers(seed, n):
    """The script's `rng`, split, `sample_train` and `eval_samples`, run
    from its own statements with the test's flags."""
    wanted = {"held", "train_frames", "train_set", "eval_samples"}
    nodes = []
    for node in _main_body():
        fills_evals = isinstance(node, ast.For) and any(
            isinstance(c, ast.Attribute) and c.attr == "append" and getattr(c.value, "id", None) == "eval_samples"
            for c in ast.walk(node))
        sampler = isinstance(node, ast.FunctionDef) and node.name == "sample_train"
        if _assigned(node) & wanted or fills_evals or sampler:
            nodes.append(node)
    return _run(nodes, dict(np=np, n=n, args=argparse.Namespace(**FLAGS), rng=np.random.default_rng(seed)))


def _script_style_draw(namespace, samples):
    """The script's stage-2 `styles = [...]` on `samples`."""
    node = next(n for n in ast.walk(ast.Module(body=_main_body(), type_ignores=[])) if "styles" in _assigned(n))
    return _run([node], dict(namespace, samples=samples))["styles"]


def _script_stage1_loss():
    """The script's `stage1_loss`, defined under `if not args.no_stabilize`."""
    node = next(n for n in _main_body() if isinstance(n, ast.If) and "no_stabilize" in ast.unparse(n.test))
    return _run(node.body, dict(jnp=jnp))["stage1_loss"]


def _record_keys():
    """The keys of the dict literal in the script's `write_output` and of its
    stage-2 summary."""
    body = ast.Module(body=_main_body(), type_ignores=[])
    write = next(n for n in ast.walk(body) if isinstance(n, ast.FunctionDef) and n.name == "write_output")
    out = next(n for n in write.body if "out" in _assigned(n))
    stage2 = next(n for n in ast.walk(body) if "stage2" in _assigned(n) and isinstance(n.value, ast.Dict))
    return {k.value for k in out.value.keys}, {k.value for k in stage2.value.keys}


# --- a scene in COLMAP's text model or LLFF's poses_bounds ------------------


def _write_points3d(path, xyz, rgb):
    """COLMAP's points3D.bin: id, xyz, rgb, error and a track of one
    observation a point."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c) in enumerate(zip(xyz, rgb)):
            f.write(struct.pack("<Q3d3Bd", i, *p, *c, 0.5) + struct.pack("<Q", 1) + struct.pack("<ii", 1, i))


def _scene(directory, layout):
    """N_FRAMES numbered frames at 40x36 (resized on load) and a style image
    the loader must skip; cameras on an arc about y looking at the origin,
    as a text COLMAP model or as poses_bounds.npy; 64 points near the
    origin in points3D.bin."""
    from PIL import Image

    rng = np.random.default_rng(3)
    (directory / "images").mkdir(parents=True)
    sparse = directory / "sparse" / "0"
    sparse.mkdir(parents=True)
    for i in range(N_FRAMES):
        frame = (rng.uniform(0, 1, (36, 40, 3)) * 255).astype(np.uint8)
        Image.fromarray(frame).save(directory / "images" / f"{i:03d}.png")
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(directory / "images" / "style.jpg")
    thetas = np.linspace(-0.4, 0.4, N_FRAMES)
    rots = np.stack([[[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]] for t in thetas])
    tvecs = np.tile([0.0, 0.1, 3.0], (N_FRAMES, 1)) + rng.normal(0, 0.01, (N_FRAMES, 3))
    if layout == "colmap":
        (sparse / "cameras.txt").write_text("1 PINHOLE 40 36 33.0 31.0 20.0 18.0\n")
        lines = [f"{i + 1} {float(np.cos(t / 2))!r} 0.0 {float(np.sin(t / 2))!r} 0.0 "
                 f"{' '.join(map(repr, tvecs[i].tolist()))} 1 {i:03d}.png\n1.0 2.0 -1\n" for i, t in enumerate(thetas)]
        (sparse / "images.txt").write_text("".join(lines))
    else:
        c2w = np.tile(np.eye(4), (N_FRAMES, 1, 1))
        c2w[:, :3, :3] = rots.transpose(0, 2, 1)
        c2w[:, :3, 3] = -np.einsum("nji,nj->ni", rots, tvecs)
        gl = c2w[:, :3, :3] @ np.diag([1.0, -1.0, -1.0])  # OpenCV -> OpenGL [right, up, back]
        blocks = np.concatenate([-gl[:, :, 1:2], gl[:, :, 0:1], gl[:, :, 2:3], c2w[:, :3, 3:4],
                                 np.tile([[36.0], [40.0], [33.0]], (N_FRAMES, 1, 1))], -1)
        bounds = np.tile([1.0, 6.0], (N_FRAMES, 1))
        np.save(directory / "poses_bounds.npy", np.concatenate([blocks.reshape(N_FRAMES, 15), bounds], 1))
    _write_points3d(sparse / "points3D.bin", rng.uniform(-1, 1, (64, 3)), rng.integers(0, 256, (64, 3)))
    return directory


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    return _scene(tmp_path_factory.mktemp("colmap"), "colmap")


@pytest.mark.parametrize("points", [False, True], ids=["frames", "points"])
@pytest.mark.parametrize("layout", ["colmap", "llff"])
def test_load_scene_matches_jax(jscript, tmp_path, layout, points):
    scene = _scene(tmp_path, layout)
    ours = oc.load_scene(scene, SIZE, return_points=points)
    ref = jscript.load_scene(scene, SIZE, return_points=points)
    assert len(ours) == len(ref) == 3 + points
    assert ours[0].shape == (N_FRAMES, SIZE, SIZE, 3)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    if points:
        assert ours[3].shape == (64, 3)


def test_make_batch_and_sparse_anchor_match_jax(jscript, colmap_scene):
    """Both contexts of each sample see anchor points; the flat indices and
    masks are equal, the targets and every Batch field within 1e-6, with and
    without style frames."""
    images, intrinsics, poses, points = oc.load_scene(colmap_scene, SIZE, return_points=True)
    samples = [(1, 9, [2, 6]), (2, 6, [3, 5])]
    k = 16
    for style_idx in (None, [7, 10]):
        ours = oc.make_batch(images, intrinsics, poses, samples, 2, "cpu", style_idx=style_idx, points=points,
                             k_points=k)
        ref = jscript.make_batch(images, intrinsics, poses, samples, 2, JBatch, style_idx=style_idx, points=points,
                                 k_points=k)
        assert ours.sparse_anchor["flat_idx"].dtype == torch.int32
        for key in ("flat_idx", "mask"):
            np.testing.assert_array_equal(ours.sparse_anchor[key].numpy(), np.asarray(ref.sparse_anchor[key]))
        np.testing.assert_allclose(ours.sparse_anchor["target"].numpy(), np.asarray(ref.sparse_anchor["target"]),
                                   rtol=0, atol=1e-6)
        mask = ours.sparse_anchor["mask"].numpy().reshape(2, 2, k)
        assert (mask.sum(-1) > 0).all()  # each context of each sample
        for name in JBatch._fields[:8]:
            a, b = getattr(ours, name), np.asarray(getattr(ref, name))
            assert a.dtype == torch.float32 and a.shape == b.shape, name
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6, err_msg=name)
    # The sampler's own anchor: a strided subsample once a view has more
    # points than k, equal to the script's.
    ext = poses.copy()
    for a, b in zip(oc._sparse_anchor(points, ext, intrinsics, 0, 3, (SIZE, SIZE), 4),
                    jscript._sparse_anchor(points, ext, intrinsics, 0, 3, (SIZE, SIZE), 4)):
        np.testing.assert_array_equal(a, b)


def test_samplers_match_jax():
    """From one seed: the held-out split, the evaluation samples, a run of
    training samples and stage-2 style frames drawn in the script's order
    (each stage-2 step draws its samples, then their styles)."""
    seed = 5
    ref = _script_samplers(seed, N_FRAMES)
    held, train_frames, train_set = oc.split_frames(N_FRAMES, FLAGS["holdout_every"])
    assert (held, train_frames, train_set) == (ref["held"], ref["train_frames"], ref["train_set"])
    ours_eval = oc.eval_samples(held, train_set, N_FRAMES, FLAGS["eval_gap"], FLAGS["targets"])
    assert ours_eval == ref["eval_samples"] and len(ours_eval) == 2
    rng = np.random.default_rng(seed)
    draws = dict(n=N_FRAMES, train_set=train_set, gap_min=FLAGS["gap_min"], gap_max=FLAGS["gap_max"],
                 targets=FLAGS["targets"])
    ours = [oc.sample_train(rng, **draws) for _ in range(20)]
    theirs = [ref["sample_train"]() for _ in range(20)]
    assert ours == theirs and len(set(map(str, ours))) > 5
    for _ in range(4):
        samples = [oc.sample_train(rng, **draws)]
        assert samples == [ref["sample_train"]()]
        styles = oc.draw_styles(rng, train_frames, samples)
        assert styles == _script_style_draw(ref, samples)
        assert styles[0] in train_set and styles[0] not in samples[0][:2]


def test_stage1_step_matches_jax(jscript, colmap_scene, monkeypatch):
    """One stage-1 step from JAX's tiny params after scratch_init_heads
    (pts3d_bound 20, the script's render caps at 32^2), dropout off, against
    a JAX step built from the script's `stage1_loss` and the pieces of
    make_train_step; then the held-out PSNR of the same params through the
    same compiled function. JAX renders through its plain compositor
    (impl="jnp"), as the script does on the CPU."""
    images, intrinsics, poses = oc.load_scene(colmap_scene, SIZE)
    held, _, train_set = oc.split_frames(N_FRAMES, FLAGS["holdout_every"])
    sample = oc.sample_train(np.random.default_rng(0), N_FRAMES, train_set, 2, 4, 2)
    evals = oc.eval_samples(held, train_set, N_FRAMES, FLAGS["eval_gap"], 2)
    hw = (SIZE, SIZE)
    render = oc.render_settings(SIZE)
    jb = jscript.make_batch(images, intrinsics, poses, [sample], 2, JBatch)
    jm = JModel(sh_degree=0, pts3d_bound=20.0, **jscript.MODEL_KWARGS["tiny"])
    params = jsi.scratch_init_heads(draw_params(jm, jb, seed=0))
    j_loss_fn = _script_stage1_loss()

    @jax.jit
    def j_step(params, batch):
        batch = batch._replace(style_image=batch.context_images[:, 0])  # stylized=False

        def loss_of(p):
            gaussians, out = jm.forward(p, batch, hw, global_step=0, deterministic=True, impl="jnp",
                                        **render)
            loss, metrics = j_loss_fn(out, batch, gaussians)
            return loss, (metrics, out.color)

        (loss, (metrics, color)), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        return loss, metrics, grads, color

    j_loss, j_metrics, j_grads, _ = j_step(params, jb)
    psnrs = []
    for s in evals:
        _, _, _, color = j_step(params, jscript.make_batch(images, intrinsics, poses, [s], 2, JBatch))
        psnrs.append(-10.0 * np.log10(max(float(np.mean((np.asarray(color)[0, 0] - images[s[2][0]]) ** 2)), 1e-10)))
    port_grads = _to_port(j_grads, grads=True)
    port_params = _to_port(params)

    monkeypatch.setattr(tdpt, "GS_DROPOUT", 0.0)
    tm = TModel(sh_degree=0, pts3d_bound=20.0, device="cpu", **oc.MODEL_KWARGS["tiny"])
    tm.load_state_dict(from_jax_params(params))
    mean_p, min_p, max_p = oc.eval_psnr(tm, images, intrinsics, poses, evals, 2, hw, render, "cpu")
    assert mean_p == pytest.approx(float(np.mean(psnrs)), abs=1e-3)
    assert (min_p, max_p) == pytest.approx((min(psnrs), max(psnrs)), abs=1e-3)

    opt = tstep.make_optimizer(tm, lr=1e-3, warmup_steps=0, total_steps=5, backbone_lr_multiplier=1.0)
    step = tstep.make_train_step(tm, opt, hw, stylized=False, loss_fn=oc.stage1_loss, **render)
    grads_seen = {}
    for name, p in tm.named_parameters():
        p.register_hook(lambda g, name=name: grads_seen.__setitem__(name, g.detach().clone()))
    state = tstep.TrainState()
    metrics = step(state, oc.make_batch(images, intrinsics, poses, [sample], 2, "cpu"), torch.Generator())
    assert state.step == 1
    assert float(metrics["loss"]) == pytest.approx(float(j_loss), rel=1e-4)
    assert set(j_metrics) == {"mse", "stab_z", "stab_opacity", "stab_dist"}
    for k, v in j_metrics.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-4), k
    assert int(metrics["live_pairs"]) > 0
    assert set(grads_seen) == set(port_params)
    for name, g in grads_seen.items():
        b = port_grads[name]
        np.testing.assert_allclose(g.numpy(), b, rtol=0, atol=2e-3 * float(np.abs(b).max()) + 1e-12, err_msg=name)

    # optax's update of the port's gradients, as one flat vector (one group).
    names = [name for name, _ in tm.named_parameters()]
    flat = np.concatenate([np.ravel(port_params[n]) for n in names])
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.adamw(jstep.make_schedule(1e-3, 0, 5), b1=0.9, b2=0.95, weight_decay=0.05))
    updates, _ = tx.update(np.concatenate([grads_seen[n].numpy().ravel() for n in names]), tx.init(flat), flat)
    expected = np.asarray(optax.apply_updates(flat, updates))
    offset = 0
    for name, p in tm.named_parameters():
        b = expected[offset:offset + p.numel()].reshape(p.shape)
        offset += p.numel()
        np.testing.assert_allclose(p.detach().numpy(), b, rtol=0, atol=1e-6 * max(np.abs(b).max(), 1e-3), err_msg=name)


def test_main_writes_the_scripts_record(colmap_scene, tmp_path, capsys):
    """python -m styl3r_tpu_torch.train.overfit_colmap --cpu --model tiny,
    3 stage-1 steps with an evaluation every 2 and a stage-2 step: the
    record has the keys of the script's write_output (and of its stage-2
    summary), finite losses, and the record's evaluations."""
    out = tmp_path / "overfit.json"
    argv = ["--scene-dir", str(colmap_scene), "--cpu", "--model", "tiny", "--size", str(SIZE), "--steps", "3",
            "--eval-every", "2", "--stage2-steps", "1", "--warmup", "1", "--output", str(out),
            *(f"--{k.replace('_', '-')}={v}" for k, v in FLAGS.items())]
    record = oc.main(argv)
    keys, stage2_keys = _record_keys()
    assert set(record) == keys | {"stage2"}
    assert set(record["stage2"]) == stage2_keys
    assert json.loads(out.read_text()) == record
    assert record["backend"] == "cpu" and record["pts3d_bound"] == 20.0 and record["stabilizer"]
    assert [e["step"] for e in record["evals"]] == [2, 3] and record["held_out"] == 2
    assert [s["step"] for s in record["series"]] == [1, 2, 3]
    assert all(np.isfinite(s["loss"]) for s in record["series"] + record["stage2"]["series"])
    assert np.isfinite(record["final_psnr"]) and record["final_psnr"] == record["evals"][-1]["psnr"]
    assert "held-out PSNR" in capsys.readouterr().out


def test_main_needs_cuda_without_cpu(colmap_scene, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        oc.main(["--scene-dir", str(colmap_scene), "--model", "tiny", "--output", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_bounded_pts3d_gradient_overflows_as_jax():
    """The pts3d bound the script trains with, d_min + span *
    tanh(expm1(|raw|) / span), has a gradient of 0 * inf = NaN once expm1
    overflows f32 (|raw| above ~88.7), in JAX as in the port: a
    from-scratch run whose raw point norms grow that far turns NaN in both
    (the card's run with 5 warm-up steps did at step 16). Below it the
    gradients agree (1e-6: the radial one rounds to 0 or 1e-7)."""
    from styl3r_tpu.models.dpt import reg_dense_pts3d as j_reg

    raw = np.asarray([[10.0, 0.0, 0.0], [0.0, 80.0, 1.0], [89.0, 0.0, 0.0], [60.0, 70.0, 0.0]], np.float32)
    ours = torch.from_numpy(raw).requires_grad_()
    tdpt.reg_dense_pts3d(ours, bound=20.0).sum().backward()
    ref = np.asarray(jax.grad(lambda x: j_reg(x, bound=20.0).sum())(jnp.asarray(raw)))
    overflow = np.linalg.norm(raw, axis=-1) > 88.8
    assert overflow.tolist() == [False, False, True, True]
    assert np.isnan(ref[overflow]).all() and torch.isnan(ours.grad[overflow]).all()
    np.testing.assert_allclose(ours.grad.numpy()[~overflow], ref[~overflow], rtol=1e-6, atol=1e-6)
