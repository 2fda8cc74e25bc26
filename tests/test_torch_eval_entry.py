"""The evaluation entry points of the port against the JAX package's:
`python -m styl3r_tpu_torch.eval.evaluate` against evaluate.py on one torch
checkpoint file and one synthetic chunk, `eval.compute_metrics` against
compute_metrics.py on the same PNG directories, and
`eval.eval_pose`, whose PnP start is held against the JAX package's on the
same predicted means (the JAX eval_pose.py is not run: its trace of the
refinement costs more than the whole port run, and
tests/test_torch_pose.py holds the refinement itself).

Tolerances: scores.json's PSNR within 1e-4 dB and SSIM within 1e-5 (f32
compute on both sides, as tests/test_torch_eval.py holds the harness);
compute_metrics' means within 1e-5 (the same 8-bit images, metrics summed in
another order); the PnP start exactly (the same numpy code).
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from styl3r_tpu.eval import pose as jpose
from styl3r_tpu_torch.eval import compute_metrics as tcompute
from styl3r_tpu_torch.eval import eval_pose as teval_pose
from styl3r_tpu_torch.eval import evaluate as tevaluate
from styl3r_tpu_torch.eval import pose as tpose
from styl3r_tpu_torch.infer import cli as tcli
from styl3r_tpu_torch.models.styl3r import Styl3rModel
from tests.test_data import make_scene


@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    """Two RE10K-style test scenes (tests/test_data.py::make_scene: 30 noise
    frames of 72x96, cameras sliding along x), an evaluation index of two
    context views and two targets each, and a tiny model's weights as a
    Lightning checkpoint with the refinenet4.resConfUnit1 entries that
    released checkpoints carry (the JAX package's reader needs them)."""
    root = tmp_path_factory.mktemp("eval")
    (root / "re10k" / "test").mkdir(parents=True)
    rng = np.random.default_rng(0)
    scenes = [make_scene(rng, f"scene_{i}") for i in range(2)]
    torch.save(scenes, root / "re10k" / "test" / "000000.torch")
    (root / "re10k" / "test" / "index.json").write_text(json.dumps({s["key"]: "000000.torch" for s in scenes}))
    (root / "index.json").write_text(json.dumps(
        {s["key"]: {"context": [0, 12], "target": [4, 8], "overlap": 0.6} for s in scenes}))
    model = Styl3rModel(device="cpu", seed=4, **tcli.TINY)
    gen = torch.Generator().manual_seed(5)
    sd = {k: p + 0.02 * torch.randn(p.shape, generator=gen) for k, p in model.state_dict().items()}
    for head in ("downstream_head1", "downstream_head2", "gaussian_param_head", "gaussian_param_head2",
                 "gaussian_appearance_head"):
        for conv in ("conv1", "conv2"):
            prefix = f"encoder.{head}.dpt.scratch.refinenet4.resConfUnit1.{conv}"
            sd[f"{prefix}.weight"] = torch.zeros(256, 256, 3, 3)
            sd[f"{prefix}.bias"] = torch.zeros(256)
    torch.save({"state_dict": sd}, root / "model.ckpt")
    return root


def _args(root, *extra):
    return ["--cpu", "--tiny", "--max-scenes", "2", "--checkpoint", str(root / "model.ckpt"),
            f"datasets.0.roots=[{root / 're10k'}]", "datasets.0.input_image_shape=[32,32]",
            "datasets.0.original_image_shape=[72,96]", f"datasets.0.view_sampler.index_path={root / 'index.json'}",
            *extra]


@pytest.fixture(scope="module")
def evaluated(eval_data, tmp_path_factory):
    """evaluate.py and the port's evaluate with 2 alignment steps, saving
    the renders; both sides decode with PIL."""
    import evaluate
    import styl3r_tpu.native
    import styl3r_tpu_torch.native

    out = tmp_path_factory.mktemp("evaluated")
    options = ("test.align_pose=true", "test.pose_align_steps=2", "test.save_image=true")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(styl3r_tpu.native, "decode_jpeg_batch", lambda *a, **k: None)
        mp.setattr(styl3r_tpu_torch.native, "decode_jpeg_batch", lambda *a, **k: None)
        jmeans = evaluate.main(_args(eval_data, f"test.output_path={out / 'jax'}", *options))
        tmeans = tevaluate.main(_args(eval_data, f"test.output_path={out / 'port'}", *options))
    return out, jmeans, tmeans


def test_evaluate_matches_jax(evaluated):
    out, jmeans, tmeans = evaluated
    jscores, tscores = (json.loads((out / side / "scores.json").read_text()) for side in ("jax", "port"))
    assert tscores == tmeans and jscores == pytest.approx(jmeans)
    assert sorted(tscores) == sorted(jscores) == ["psnr/all", "psnr/medium", "ssim/all", "ssim/medium"]
    for key in tscores:
        tol = 1e-4 if key.startswith("psnr") else 1e-5
        assert np.isfinite(tscores[key]) and abs(tscores[key] - jscores[key]) <= tol, key
    bench = json.loads((out / "port" / "benchmark.json").read_text())
    assert {"encoder", "optimize", "decoder", "decoder_unpadded"} <= set(bench)
    assert json.loads((out / "port" / "peak_memory.json").read_text()) == {"cpu": None}
    for side in ("jax", "port"):
        assert sorted(str(p.relative_to(out / side)) for p in (out / side / "images").rglob("*.png")) == [
            f"images/scene_{s}/{i:04d}.png" for s in range(2) for i in range(2)]


def _png(path, rng, hw):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((rng.uniform(0, 1, (*hw, 3)) * 255).astype(np.uint8)).save(path)


def test_compute_metrics_matches_jax(evaluated, tmp_path):
    """The saved renders against ground truth of another size (so each is
    LANCZOS-resized), nested one level, with a file that only one side has,
    and a method directory with no match."""
    import compute_metrics

    out, _, _ = evaluated
    rng = np.random.default_rng(6)
    gt = tmp_path / "gt"
    for s in range(2):
        for i in range(2):
            _png(gt / "images" / f"scene_{s}" / f"{i:04d}.png", rng, (40, 36))
    _png(gt / "images" / "scene_9" / "0000.png", rng, (40, 36))
    _png(tmp_path / "other" / "x.png", rng, (8, 8))
    args = ["--cpu", "--gt-dir", str(gt), "--pred-dir", str(out / "port"), "--pred-dir", str(out / "jax"),
            "--pred-dir", str(tmp_path / "other")]
    ours, ref = tcompute.main(args), compute_metrics.main(args)
    assert sorted(ours) == sorted(ref) == sorted([str(out / "port"), str(out / "jax")])
    for method, means in ref.items():
        assert sorted(ours[method]) == sorted(means) == ["psnr/all", "ssim/all"]
        for key, value in means.items():
            assert abs(ours[method][key] - value) <= 1e-5, (method, key)
    assert ours[str(out / "port")]["psnr/all"] != ours[str(out / "jax")]["psnr/all"]
    with pytest.raises(SystemExit, match="no images"):
        tcompute.main(["--cpu", "--gt-dir", str(tmp_path / "empty"), "--pred-dir", str(gt)])


def test_eval_pose_runs_and_starts_from_the_jax_pnp_pose(eval_data, monkeypatch):
    """Two refinement steps a scene give finite AUCs; the PnP start of each
    scene, from the second view's predicted means and densities, equals the
    JAX package's PnP on the same arrays."""
    calls = []
    real = tpose.pnp_pose_from_gaussians

    def record(pts3d, opacity, intrinsics, **kwargs):
        pose = real(pts3d, opacity, intrinsics, **kwargs)
        calls.append((pts3d, opacity, intrinsics, kwargs, pose))
        return pose

    monkeypatch.setattr(tpose, "pnp_pose_from_gaussians", record)
    aucs = teval_pose.main(_args(eval_data, "--refine-steps", "2"))
    assert sorted(aucs) == [5, 10, 20] and all(np.isfinite(v) and 0 <= v <= 1 for v in aucs.values())
    assert len(calls) == 2
    for pts3d, opacity, intrinsics, kwargs, pose in calls:
        assert pts3d.shape == (32, 32, 3) and opacity.shape == (32, 32) and np.isfinite(pts3d).all()
        np.testing.assert_array_equal(pose, jpose.pnp_pose_from_gaussians(pts3d, opacity, intrinsics, **kwargs))


def test_entry_points_need_cuda_unless_told_cpu(eval_data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(eval_data, f"test.output_path={tmp_path / 'out'}")[1:]  # without --cpu
    with pytest.raises(RuntimeError, match="no CUDA"):
        tevaluate.main(args)
    with pytest.raises(RuntimeError, match="no CUDA"):
        teval_pose.main(args)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tcompute.main(["--gt-dir", str(eval_data), "--pred-dir", str(eval_data)])
    assert not (tmp_path / "out").exists()
