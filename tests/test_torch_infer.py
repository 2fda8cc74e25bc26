"""Port parity for the inference path: styl3r_tpu_torch.infer and its pose
updates, trajectories and PLY export against styl3r_tpu's, pose alignment
against JAX's (impl="jnp"), and the re10k entry point end to end against
infer_re10k.py on one checkpoint file.

Tolerances, each with its reason:
  * update_pose, camera_normalization, trajectories: 1e-6 (the same f32 or
    f64 arithmetic; only the order of a matmul's sums differs).
  * the PLY: byte for byte (the same f32 arrays and the same writer).
  * the first alignment step's camera-delta gradients: 1e-4 of their
    largest component (the plain compositor's gradient against autodiff of
    the jnp one, as tests/test_torch_backward.py holds it).
  * extrinsics after 5 steps of alignment: 1e-5. Adam divides each moment by
    its own root, so its first step is +-lr whatever the gradient's size, and
    later steps depend on ratios of gradients: a relative error e in a
    gradient moves an increment by about e * lr (1e-4 * 3e-3 here), far
    below 1e-5, unless a component's gradient is near 0 and its sign flips,
    which these scenes do not have (each component is > 1e-3 of the largest).
  * the entry point, f32 compute on both sides: info.json's PSNR within
    1e-4 dB, the PNGs within 1/255 (one 8-bit step where a value lies on a
    rounding edge), the PLYs within 1e-5 of each column's largest magnitude
    (the whole model's rounding, as tests/test_torch_model.py holds it).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from styl3r_tpu.geometry import se3 as jse3
from styl3r_tpu.geometry.gaussians import Gaussians as JGaussians
from styl3r_tpu.infer import pipeline as jpipeline
from styl3r_tpu.infer import trajectory as jtraj
from styl3r_tpu.models.decoder import render_gaussians as j_render
from styl3r_tpu.utils import ply_export as jply
from styl3r_tpu_torch.geometry import se3 as tse3
from styl3r_tpu_torch.geometry.gaussians import Gaussians as TGaussians
from styl3r_tpu_torch.infer import cli as tcli
from styl3r_tpu_torch.infer import pipeline as tpipeline
from styl3r_tpu_torch.infer import trajectory as ttraj
from styl3r_tpu_torch.models.decoder import render_gaussians as t_render
from styl3r_tpu_torch.ops.rasterizer.project import SH_C0
from styl3r_tpu_torch.utils import ply_export as tply

H = W = 64
K = np.asarray([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32)
RENDER = dict(max_per_tile=1024)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread for this file. Under pytest-xdist with
    6 workers on an 8-core host each worker's default of a thread a core
    oversubscribes the host, and the alignment loops of small ops wait on
    spinning threads: test_pose_alignment_recovers_perturbation took 459 s
    there against 5 s alone, and 13 s on one thread beside 7 busy
    processes. Alone the file takes as long either way (80 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _poses(rng, n):
    tau = np.concatenate([rng.normal(0, 0.5, (n, 3)), rng.normal(0, 0.4, (n, 3))], -1).astype(np.float32)
    return np.asarray(jse3.se3_exp(jnp.asarray(tau)))


def test_update_pose_and_camera_normalization_match_jax():
    rng = np.random.default_rng(0)
    ext = _poses(rng, 6)
    trans = rng.normal(0, 0.05, (6, 3)).astype(np.float32)
    rot = rng.normal(0, 0.03, (6, 3)).astype(np.float32)
    rot[0] = 0.0  # the small-angle branch
    ours = tse3.update_pose(_t(trans), _t(rot), _t(ext)).numpy()
    ref = np.asarray(jse3.update_pose(jnp.asarray(trans), jnp.asarray(rot), jnp.asarray(ext)))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    ours = tse3.camera_normalization(_t(ext[2]), _t(ext)).numpy()
    ref = np.asarray(jse3.camera_normalization(jnp.asarray(ext[2]), jnp.asarray(ext)))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_allclose(ours[2], np.eye(4), atol=1e-6)


def test_trajectories_match_jax():
    rng = np.random.default_rng(1)
    e0, e1 = _poses(rng, 2)
    t = np.linspace(0, 1, 7)
    np.testing.assert_allclose(ttraj.interpolate_extrinsics(e0, e1, t), jtraj.interpolate_extrinsics(e0, e1, t), atol=1e-6)
    k0, k1 = K, K * 1.3
    np.testing.assert_allclose(ttraj.interpolate_intrinsics(k0, k1, t), jtraj.interpolate_intrinsics(k0, k1, t), atol=1e-6)
    np.testing.assert_allclose(ttraj.wobble_extrinsics(e0, 9, 0.2), jtraj.wobble_extrinsics(e0, 9, 0.2), atol=1e-6)
    np.testing.assert_allclose(ttraj.generate_spin(12, 20.0, 2.5), jtraj.generate_spin(12, 20.0, 2.5), atol=1e-6)


@pytest.mark.parametrize("kwargs", [dict(), dict(shift_and_scale=True, save_sh_dc_only=False)],
                         ids=["dc_only", "shifted_with_rest"])
def test_ply_is_byte_identical_to_jax(tmp_path, kwargs):
    rng = np.random.default_rng(2)
    g = 37
    arrays = (
        rng.normal(size=(g, 3)).astype(np.float32),
        np.abs(rng.normal(size=(g, 3))).astype(np.float32) + 0.01,
        rng.normal(size=(g, 4)).astype(np.float32),
        rng.normal(size=(g, 3, 4)).astype(np.float32),
        rng.uniform(0, 1, g).astype(np.float32),
    )
    tply.export_ply(*arrays, tmp_path / "port.ply", **kwargs)
    jply.export_ply(*arrays, tmp_path / "jax.ply", **kwargs)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    ours, ref = tply.load_ply(tmp_path / "port.ply"), jply.load_ply(tmp_path / "jax.ply")
    assert list(ours) == list(ref)
    for name in ref:
        np.testing.assert_array_equal(ours[name], ref[name])


def test_adam_matches_optax():
    """1e-4 relative: optax and the port both take 1 - b2**t in f32, where a
    one-ulp difference in b2**t (6e-8) is 3e-5 of 1 - b2**2."""
    rng = np.random.default_rng(3)
    opt = optax.adam(3e-3)
    state = opt.init(jnp.zeros(5))
    ours = tpipeline.Adam(3e-3)
    for scale in (1.0, 1e-3, 10.0, 1e-6):
        g = (scale * rng.normal(size=5)).astype(np.float32)
        ref, state = opt.update(jnp.asarray(g), state)
        np.testing.assert_allclose(ours.update(_t(g)).numpy(), np.asarray(ref), rtol=1e-4, atol=1e-12)


def _scene(seed, g=512):
    """tests/test_infer.py::make_scene's cloud, as numpy arrays."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, g), rng.uniform(-1.5, 1.5, g), rng.uniform(2, 6, g)], -1)
    scales = rng.uniform(0.02, 0.08, (g, 3))
    quats = rng.normal(size=(g, 4))
    sh = (rng.uniform(0, 1, (g, 3)) - 0.5)[..., None] / SH_C0
    op = rng.uniform(0.5, 1.0, g)
    return [np.asarray(x, np.float32)[None] for x in (means, sh, op, scales, quats)]


def _gaussians(arrays, pkg):
    means, sh, op, scales, quats = arrays
    if pkg == "jax":
        from styl3r_tpu.geometry import build_covariance

        cov = build_covariance(jnp.asarray(scales), jnp.asarray(quats))
        return JGaussians(jnp.asarray(means), cov, jnp.asarray(sh), jnp.asarray(op), jnp.asarray(scales), jnp.asarray(quats))
    return TGaussians(_t(means), None, _t(sh), _t(op), _t(scales), _t(quats))


def _cams(v, seed):
    """v target views near the identity, each one's own pose."""
    rng = np.random.default_rng(seed)
    tau = np.concatenate([rng.normal(0, 0.05, (v, 3)), rng.normal(0, 0.02, (v, 3))], -1).astype(np.float32)
    ext = np.asarray(jse3.se3_exp(jnp.asarray(tau)))[None]
    return ext, np.broadcast_to(K, (1, v, 3, 3)).copy(), np.full((1, v), 0.1, np.float32), np.full((1, v), 100.0, np.float32)


def _targets(arrays, v, seed):
    """What the true cameras see: the render at other poses."""
    ext, k, near, far = _cams(v, seed)
    out = t_render(_gaussians(arrays, "torch"), _t(ext), _t(k), _t(near), _t(far), (H, W), **RENDER)
    return out.color.numpy()


def test_alignment_gradients_and_steps_match_jax():
    arrays = _scene(0)
    v = 3
    images = _targets(arrays, v, seed=10)
    ext, k, near, far = _cams(v, seed=11)

    def j_loss(deltas):
        out = j_render(_gaussians(arrays, "jax"), jnp.asarray(ext), jnp.asarray(k), jnp.asarray(near),
                       jnp.asarray(far), (H, W), cam_rot_delta=deltas["rot"], cam_trans_delta=deltas["trans"],
                       impl="jnp", **RENDER)
        return jnp.mean((out.color - jnp.asarray(images)) ** 2)

    ref = jax.jit(jax.grad(j_loss))({"rot": jnp.zeros((1, v, 3)), "trans": jnp.zeros((1, v, 3))})
    rot = torch.zeros(1, v, 3, requires_grad=True)
    trans = torch.zeros(1, v, 3, requires_grad=True)
    out = t_render(_gaussians(arrays, "torch"), _t(ext), _t(k), _t(near), _t(far), (H, W),
                   cam_rot_delta=rot, cam_trans_delta=trans, **RENDER)
    ours = torch.autograd.grad(((out.color - _t(images)) ** 2).mean(), (rot, trans))
    for name, g in zip(("rot", "trans"), ours):
        r = np.asarray(ref[name])
        scale = np.abs(r).max()
        assert scale > 0 and np.abs(r).min() > 1e-3 * scale, (name, r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * scale, err_msg=name)

    args = (ext, k, near, far, images)
    j_ext = jpipeline.align_target_poses(_gaussians(arrays, "jax"), *map(jnp.asarray, args), (H, W), steps=5,
                                         impl="jnp", **RENDER)
    t_ext = tpipeline.align_target_poses(_gaussians(arrays, "torch"), *map(_t, args), (H, W), steps=5, **RENDER)
    np.testing.assert_allclose(t_ext.numpy(), np.asarray(j_ext), atol=1e-5)
    assert np.abs(t_ext.numpy() - ext).max() > 1e-3  # the steps moved the cameras


def test_pose_alignment_recovers_perturbation():
    """tests/test_infer.py::test_pose_alignment_recovers_perturbation in the
    port: from the identity, 60 steps bring the pose error below 0.3x."""
    arrays = _scene(0)
    gaussians = _gaussians(arrays, "torch")
    true_ext = tse3.se3_exp(torch.tensor([0.05, -0.03, 0.0, 0.0, 0.02, 0.0]))[None, None]
    intr, near, far = _t(K)[None, None], torch.full((1, 1), 0.1), torch.full((1, 1), 100.0)
    target = t_render(gaussians, true_ext, intr, near, far, (H, W), **RENDER).color
    start = torch.eye(4)[None, None]
    aligned = tpipeline.align_target_poses(gaussians, start, intr, near, far, target, (H, W), steps=60,
                                           rot_lr=5e-3, trans_lr=5e-3, **RENDER)
    before = float((start - true_ext).abs().max())
    after = float((aligned - true_ext).abs().max())
    assert after < 0.3 * before, (before, after)


def test_alignment_takes_no_gradient_into_the_gaussians():
    arrays = _scene(1, g=64)
    gaussians = TGaussians(*(None if x is None else x.requires_grad_() for x in _gaussians(arrays, "torch")))
    ext, k, near, far = _cams(1, seed=3)
    images = _targets(arrays, 1, seed=4)
    tpipeline.align_target_poses(gaussians, *map(_t, (ext, k, near, far, images)), (H, W), steps=1, **RENDER)
    assert all(x.grad is None for x in gaussians if x is not None)


@pytest.fixture(scope="module")
def synthetic_chunk(tmp_path_factory):
    """One RE10K-style chunk (tests/test_data.py::make_scene) and a tiny
    port model's weights saved as a Lightning checkpoint, with the
    refinenet4.resConfUnit1 entries released checkpoints carry."""
    from tests.test_data import make_scene
    from styl3r_tpu_torch.models.styl3r import Styl3rModel

    root = tmp_path_factory.mktemp("re10k")
    (root / "test").mkdir()
    rng = np.random.default_rng(0)
    torch.save([make_scene(rng, "scene_0")], root / "test" / "000000.torch")
    (root / "test" / "index.json").write_text(json.dumps({"scene_0": "000000.torch"}))

    model = Styl3rModel(device="cpu", seed=4, **tcli.TINY)
    gen = torch.Generator().manual_seed(5)
    sd = {}
    for name, p in model.state_dict().items():
        # Biases and LayerNorm shifts are 0 at init: perturb every tensor.
        sd[name] = p + 0.02 * torch.randn(p.shape, generator=gen)
    for head in ("downstream_head1", "downstream_head2", "gaussian_param_head",
                 "gaussian_param_head2", "gaussian_appearance_head"):
        for conv in ("conv1", "conv2"):
            prefix = f"encoder.{head}.dpt.scratch.refinenet4.resConfUnit1.{conv}"
            sd[f"{prefix}.weight"] = torch.zeros(256, 256, 3, 3)
            sd[f"{prefix}.bias"] = torch.zeros(256)
    ckpt = root / "model.ckpt"
    torch.save({"state_dict": sd, "epoch": 3}, ckpt)
    return root, ckpt


def test_re10k_entry_point_matches_jax(synthetic_chunk, tmp_path, monkeypatch):
    """infer_re10k.py and `python -m styl3r_tpu_torch.infer.re10k` on the
    same chunk and checkpoint, with 2 alignment steps. Both compute in f32
    here (each entry point's default is a bf16 backbone, which XLA and
    PyTorch round in other places)."""
    import infer_re10k
    from PIL import Image

    from styl3r_tpu_torch.infer import re10k

    root, ckpt = synthetic_chunk
    monkeypatch.setattr(jpipeline.InferencePipeline.__init__, "__defaults__", (0, jnp.float32, (256, 256)))
    monkeypatch.setattr(tcli, "load_model", _f32_load_model(tcli.load_model))
    args = ["--data-root", str(root), "--scene", "scene_0", "--cpu", "--tiny", "--size", "32",
            "--max-targets", "1", "--video-frames", "0", "--align-pose-steps", "2", "--checkpoint", str(ckpt)]
    infer_re10k.main([*args, "--output", str(tmp_path / "jax")])
    re10k.main([*args, "--output", str(tmp_path / "port")])

    jdir, tdir = tmp_path / "jax" / "scene_0", tmp_path / "port" / "scene_0"
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    assert "color_0001.png" in names and "gaussians_stylized.ply" in names
    jinfo, tinfo = (json.loads((d / "info.json").read_text()) for d in (jdir, tdir))
    assert np.isfinite(tinfo["psnr_unstylized"])
    assert abs(tinfo["psnr_unstylized"] - jinfo["psnr_unstylized"]) <= 1e-4
    assert tinfo["scale"] == pytest.approx(jinfo["scale"], rel=1e-6)
    for name in names:
        if name.endswith(".png"):
            a = np.asarray(Image.open(jdir / name), np.int16)
            b = np.asarray(Image.open(tdir / name), np.int16)
            assert np.abs(a - b).max() <= 1, name
        elif name.endswith(".ply"):
            a, b = jply.load_ply(jdir / name), tply.load_ply(tdir / name)
            assert list(a) == list(b)
            for prop in a:
                scale = max(1.0, float(np.abs(a[prop]).max()))
                np.testing.assert_allclose(b[prop], a[prop], atol=1e-5 * scale, err_msg=f"{name}:{prop}")


def _f32_load_model(load_model):
    def f32(checkpoint, device, **kwargs):
        return load_model(checkpoint, device, backbone_dtype=torch.float32, **kwargs)

    return f32


def test_entry_points_without_cpu_need_cuda(synthetic_chunk, tmp_path, monkeypatch):
    from styl3r_tpu_torch.infer import colmap, re10k, tnt_batch

    root, _ = synthetic_chunk
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        re10k.main(["--data-root", str(root), "--scene", "scene_0", "--tiny", "--output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA"):
        colmap.main(["--scene-dir", str(tmp_path), "--tiny", "--output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA"):
        tnt_batch.main(["--scene-dir", str(tmp_path), "--style-dir", str(tmp_path), "--tiny"])
    assert not any(tmp_path.iterdir())


def _colmap_scene(directory, n=5):
    """n numbered 256^2 frames (and a style image among them, which the
    entry points must skip) with a text COLMAP model of cameras sliding
    along x."""
    from PIL import Image

    rng = np.random.default_rng(6)
    (directory / "images").mkdir(parents=True)
    (directory / "sparse" / "0").mkdir(parents=True)
    for i in range(n):
        Image.fromarray((rng.uniform(0, 1, (256, 256, 3)) * 255).astype(np.uint8)).save(directory / "images" / f"{i:03d}.png")
    Image.fromarray((rng.uniform(0, 1, (300, 280, 3)) * 255).astype(np.uint8)).save(directory / "images" / "style.jpg")
    (directory / "sparse" / "0" / "cameras.txt").write_text("1 PINHOLE 256 256 230.0 240.0 128.0 128.0\n")
    lines = [f"{i + 1} 1 0 0 0 {-0.1 * i} 0 0 1 {i:03d}.png\n1.0 2.0 -1\n" for i in range(n)]
    (directory / "sparse" / "0" / "images.txt").write_text("".join(lines))
    return directory


@pytest.mark.parametrize("entry", ["colmap", "tnt_batch"])
def test_colmap_entry_points_pass_what_jax_passes(tmp_path, monkeypatch, entry):
    """infer_colmap.py / infer_tnt_batch.py and the port's entry points on
    the same COLMAP scene hand run_scene_inference the same frames, poses,
    intrinsics, views, style, output directory and options (the flow
    itself is test_re10k_entry_point_matches_jax's). The model is not
    built: both loaders and both flows are replaced by recorders."""
    import importlib

    from styl3r_tpu.infer import cli as jcli

    scene = _colmap_scene(tmp_path / "scene")
    calls = {}

    def recorder(name):
        def run(*args, **kwargs):
            calls[name] = (args, kwargs)
            return {"psnr_unstylized": 0.0, "scale": 1.0}
        return run

    monkeypatch.setattr(jcli, "load_params", lambda *args, **kwargs: None)
    monkeypatch.setattr(jcli, "run_scene_inference", recorder("jax"))
    monkeypatch.setattr(tcli, "load_model", lambda *args, **kwargs: None)
    monkeypatch.setattr(tcli, "run_scene_inference", recorder("port"))
    args = ["--scene-dir", str(scene), "--cpu", "--tiny", "--scale-invariant", "--video-frames", "5"]
    if entry == "colmap":
        args += ["--max-targets", "2", "--align-pose-steps", "3", "--style", str(scene / "images" / "style.jpg")]
    else:
        args += ["--style-dir", str(scene / "images"), "--style-ids", "1"]
    importlib.import_module(f"infer_{entry}").main(
        [*args, "--output", str(tmp_path / "jax")])
    importlib.import_module(f"styl3r_tpu_torch.infer.{entry}").main([*args, "--output", str(tmp_path / "port")])

    (jargs, jkw), (targs, tkw) = calls["jax"], calls["port"]
    assert jargs[0] is None and targs[0] is None  # the loaders' results
    for a, b in zip(targs[1:4], jargs[1:4]):  # images, intrinsics, poses
        np.testing.assert_array_equal(a, b)
    assert list(targs[4]) == list(jargs[4]) and list(targs[5]) == list(jargs[5])  # context, targets
    np.testing.assert_array_equal(targs[6], jargs[6])  # style
    assert targs[7].relative_to(tmp_path / "port") == jargs[7].relative_to(tmp_path / "jax")
    jkw.pop("model_kwargs")
    assert tkw == jkw
    assert len(targs[1]) == 5  # style.jpg is not a frame


def test_load_model_drops_only_the_unused_keys(synthetic_chunk, tmp_path):
    from styl3r_tpu_torch.utils.checkpoint import load_checkpoint

    _, ckpt = synthetic_chunk
    model = tcli.load_model(str(ckpt), "cpu", **tcli.TINY)
    sd = torch.load(ckpt, weights_only=False)["state_dict"]
    for name, p in model.state_dict().items():
        assert torch.equal(p, sd[name]), name
    sd["encoder.extra.weight"] = torch.zeros(1)
    torch.save({"state_dict": sd}, tmp_path / "extra.ckpt")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_checkpoint(model, str(tmp_path / "extra.ckpt"))
    del sd["encoder.extra.weight"], sd["encoder.backbone.enc_norm.weight"]
    torch.save(sd, tmp_path / "missing.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_checkpoint(model, str(tmp_path / "missing.pth"))
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(model, str(tmp_path))
