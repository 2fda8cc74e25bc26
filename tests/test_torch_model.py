"""Port parity for the whole slice: styl3r_tpu_torch.Styl3rModel.forward vs
styl3r_tpu's Styl3rModel.forward (impl="jnp") at tiny widths, the weights
bridge both ways, and the port's import and device rules.

Tolerance 1e-4 for the whole model in f32 on the CPU: 2 encoder + 4 decoder
blocks, three DPT heads and the adapter add up rounding differences of
1e-5-sized modules; values that scale with expm1 (means, covariances, depth)
get it relative to their largest magnitude."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.models.styl3r import Batch as JBatch
from styl3r_tpu.models.styl3r import Styl3rModel as JModel
from styl3r_tpu.utils.checkpoint import convert_styl3r_encoder
from styl3r_tpu_torch import resolve_device
from styl3r_tpu_torch.models.styl3r import Styl3rModel as TModel
from styl3r_tpu_torch.models.styl3r import batch_to
from styl3r_tpu_torch.ops.rasterizer import composite
from styl3r_tpu_torch.utils import trace
from styl3r_tpu_torch.utils.convert import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(
    enc_depth=2, dec_depth=4, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2,
    head_feature_dim=16, head_last_dim=16, head_layer_dims=(8, 8, 16, 16),
)
RENDER = dict(max_tiles_per_gaussian=8, max_per_tile=512, pair_cap_per_gaussian=2)


def draw_params(module, *init_args, seed):
    """Flax-shaped params (jax.eval_shape of the flax init, which is much
    cheaper than running it) drawn with seeded numpy: lecun-normal kernels
    and noise on every bias and LayerNorm scale. A PatchExpand bias keeps its
    k*k tiles equal, as the ConvTranspose2d bias it stands for must."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *init_args)

    def go(path, leaf):
        names = [getattr(p, "key", None) for p in path]
        shape = leaf.shape
        if names[-1] == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        k = 4 if "act_0_up" in names else 2 if "act_1_up" in names else 1
        noise = 0.05 * np.tile(rng.standard_normal(shape[0] // (k * k)), k * k)
        return (noise + (1.0 if names[-1] == "scale" else 0.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(go, shapes)


def _batch(rng, h, w):
    k = np.asarray([[0.9, 0, 0.5], [0, 1.1, 0.45], [0, 0, 1.0]], np.float32)
    ext = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    ext[0, 1, 0, 3] = 0.05
    return JBatch(
        context_images=rng.uniform(0, 1, (1, 2, h, w, 3)).astype(np.float32),
        context_intrinsics=np.tile(k, (1, 2, 1, 1)),
        target_extrinsics=ext,
        target_intrinsics=np.tile(k, (1, 2, 1, 1)),
        target_near=np.full((1, 2), 0.1, np.float32),
        target_far=np.full((1, 2), 100.0, np.float32),
        style_image=rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def models():
    """One flax param tree for every test here: no param shape depends on
    the image size, so landscape and portrait batches share it."""
    jm = JModel(sh_degree=1, **TINY)
    batch = jax.tree.map(jnp.asarray, _batch(np.random.default_rng(0), 32, 32))
    params = draw_params(jm, batch, seed=0)
    tm = TModel(sh_degree=1, device="cpu", **TINY)
    tm.load_state_dict(from_jax_params(params))
    return jm, params, tm


def _scaled_close(a, b, rtol=1e-4):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1.0))


def _assert_images_close(tout, jout):
    """Rendered images at the whole-model tolerance, except where a pair's
    alpha at a pixel lands within rounding of the 1/255 cutoff: the two
    packages' 1e-6-sized differences upstream then keep it in one render and
    drop it in the other, which moves that pixel by at most 1/255 of a
    color. Such flips are rare (0.02% of pixels in the portrait case)."""
    for name in ("color", "alpha"):
        a, b = getattr(tout, name).numpy(), np.asarray(getattr(jout, name))
        off = np.abs(a - b) > 1e-4 + 1e-4 * np.abs(b)
        assert off.mean() < 1e-3, (name, off.mean())
        np.testing.assert_allclose(a, b, atol=1.0 / 255.0 + 1e-4)


@pytest.mark.parametrize("portrait", [False, True], ids=["landscape", "portrait"])
def test_forward_matches_jax(models, portrait):
    from styl3r_tpu.geometry.gaussians import Gaussians as JGaussians
    from styl3r_tpu.models.decoder import render_gaussians as j_render

    jm, params, tm = models
    h, w = (48, 32) if portrait else (32, 48)
    batch = _batch(np.random.default_rng(1), h, w)
    jb = jax.tree.map(jnp.asarray, batch)
    jg, jout = jax.jit(
        lambda p, b: jm.forward(p, b, (h, w), portrait=portrait, impl="jnp", **RENDER)
    )(params, jb)
    with torch.no_grad():
        tg, tout = tm(batch_to(batch, "cpu"), (h, w), portrait=portrait, **RENDER)
    for name in jg._fields:
        _scaled_close(getattr(tg, name).numpy(), getattr(jg, name))
    _assert_images_close(tout, jout)
    np.testing.assert_array_equal(tout.live_pairs.numpy(), np.asarray(jout.live_pairs))
    np.testing.assert_array_equal(tout.pair_slots.numpy(), np.asarray(jout.pair_slots))
    assert int(tout.live_pairs.min()) > 0
    assert float(tout.alpha.max()) > 0.1  # something was actually drawn

    # The render stage on identical inputs: JAX renders the port's Gaussians.
    jout2 = jax.jit(lambda g, b: j_render(
        g, b.target_extrinsics, b.target_intrinsics, b.target_near, b.target_far, (h, w),
        impl="jnp", **RENDER,
    ))(JGaussians(*(jnp.asarray(x.numpy()) for x in tg)), jb)
    for name in ("color", "alpha"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout2, name)), rtol=1e-5, atol=1e-5)
    _scaled_close(tout.depth.numpy(), jout2.depth, rtol=1e-5)
    _scaled_close(tout.depth.numpy(), jout.depth)


def test_state_dict_round_trips_to_flax_params(models):
    """convert_styl3r_encoder of the port's state dict gives back the flax
    params exactly. Released reference checkpoints also hold
    refinenet4.resConfUnit1, which neither model uses; the converter reads
    it, so it is filled in here and dropped from the result."""
    _, params, tm = models
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    for head in ("downstream_head1", "downstream_head2", "gaussian_param_head",
                 "gaussian_param_head2", "gaussian_appearance_head"):
        for conv in ("conv1", "conv2"):
            p = f"encoder.{head}.dpt.scratch.refinenet4.resConfUnit1.{conv}"
            sd[f"{p}.weight"] = np.zeros((16, 16, 3, 3), np.float32)
            sd[f"{p}.bias"] = np.zeros((16,), np.float32)
    back = convert_styl3r_encoder(sd)
    for head in back["params"].values():
        if "trunk" in head:
            del head["trunk"]["refinenet4"]["resConfUnit1"]
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_parameter_count_matches_flax_minus_patch_expand_tiles(models):
    """The torch layout stores each ConvTranspose bias once where flax's
    PatchExpand stores it k*k times: 5 trunks x (ld0*15 + ld1*3) fewer."""
    _, params, tm = models
    n_flax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    n_torch = sum(p.numel() for p in tm.parameters())
    assert n_flax - n_torch == 5 * (8 * 15 + 8 * 3)


def test_flax_like_init_scale():
    """init_like_flax_: lecun-normal kernels (std 1/sqrt(fan_in)), zero
    biases, LayerNorm ones, from the seed."""
    a, b = TModel(device="cpu", seed=3, **TINY), TModel(device="cpu", seed=3, **TINY)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    qkv = a.encoder.backbone.enc_blocks[0].attn.qkv
    assert abs(float(qkv.weight.detach().std()) * 32**0.5 - 1.0) < 0.1
    assert float(qkv.weight.abs().max()) <= 2.0 / 0.87962566103423978 / 32**0.5 + 1e-6
    assert torch.equal(qkv.bias, torch.zeros_like(qkv.bias))
    assert torch.equal(a.encoder.backbone.enc_norm.weight, torch.ones(32))


@pytest.mark.parametrize("shapes", [
    dict(),
    dict(b=2, v=3, h=128, w=192, style_hw=128, n_targets=2, sh_degree=2, pair_cap_per_gaussian=0),
], ids=["bench", "other"])
def test_flops_match_jax(shapes):
    """The port's copy of the analytic count equals the JAX package's."""
    from styl3r_tpu.utils import flops as jflops
    from styl3r_tpu_torch.utils import flops as tflops

    assert tflops.styl3r_forward_flops(**shapes) == jflops.styl3r_forward_flops(**shapes)
    t = tflops.styl3r_forward_flops(**shapes)["total"]
    assert tflops.mfu(t, 0.1)["mfu"] == pytest.approx(jflops.mfu(t, 0.1, peak_tflops=989.0)["mfu"], abs=1e-4)


def test_resolve_device_and_cpu_compositor_path(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        TModel(**TINY)  # no device given, no CUDA: no silent CPU fallback

    rng = np.random.default_rng(6)
    attrs = torch.from_numpy(rng.uniform(0.1, 1.0, (300, 12)).astype(np.float32))
    starts = torch.tensor([0, 100, 200, 300], dtype=torch.int32)
    counts = torch.tensor([100, 100, 100, 0], dtype=torch.int32)
    bg = torch.zeros(1, 3)
    before = trace.counters()["composite_fwd"]
    out = composite.composite_tiles(attrs, starts, counts, bg, (2, 2), 256)
    ref = composite.composite_tiles_plain(attrs, starts, counts, bg, (2, 2), 256)
    assert trace.counters()["composite_fwd"] == before  # CPU tensors never reach the kernel
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


_PORT_FILES = sorted(
    str(p.relative_to(ROOT).with_suffix("")).replace(os.sep, ".").removesuffix(".__init__")
    for p in (ROOT / "styl3r_tpu_torch").rglob("*.py")
)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {_PORT_FILES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'styl3r_tpu', '__graft_entry__'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(_PORT_FILES) > 15


@pytest.mark.parametrize("path", ["chip_smoke.py", *(
    str(p.relative_to(ROOT)) for p in sorted((ROOT / "styl3r_tpu_torch").rglob("*.py"))
)])
def test_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "styl3r_tpu", "__graft_entry__"), (path, name)
