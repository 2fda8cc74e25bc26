"""The 2-D AdaIN baseline and the orbax checkpoint converter:
styl3r_tpu_torch.models.stylizers.AdaIN2D against styl3r_tpu's on one
synthesized reference state dict carried through each side's
convert_adain2d_checkpoint, Trainer.validate logging the baseline, and
scripts/orbax_to_torch.py on a JAX model's params saved as the JAX trainer
saves them.

Tolerances: AdaIN2D's output within 1e-4 of its largest magnitude (f32 VGG
and decoder convolutions summed in another order, through instance
statistics that divide by a channel's spread); the converted state dict
exactly (the same arrays, restored and transposed).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.models import stylizers as jstylizers
from styl3r_tpu.models.styl3r import Styl3rModel as JModel
from styl3r_tpu_torch.models import stylizers as tstylizers
from styl3r_tpu_torch.models.styl3r import Styl3rModel as TModel
from styl3r_tpu_torch.train.trainer import Trainer
from styl3r_tpu_torch.utils.checkpoint import load_checkpoint
from styl3r_tpu_torch.utils.config import load_config
from styl3r_tpu_torch.utils.convert import from_jax_params
from tests.test_torch_model import TINY, _batch, draw_params
from tests.test_torch_trainer import SMALL_RENDER
from tests.test_torch_trainer import _batch as trainer_batch
from tests.test_torch_trainer import _tiny

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference encoder's convs: (slice, index inside the slice, in, out).
VGG_CONVS = [("slice1", 0, 3, 64), ("slice2", 0, 64, 64), ("slice2", 3, 64, 128), ("slice3", 0, 128, 128),
             ("slice3", 3, 128, 256), ("slice4", 0, 256, 256), ("slice4", 2, 256, 256), ("slice4", 4, 256, 256),
             ("slice4", 7, 256, 512)]


def reference_adain_state(seed=0):
    """A state dict in the reference AdaIN2D's layout (ckpts/model_state.pth:
    vgg_encoder.sliceK.I.* and decoder.rcN.conv.*), He-scaled so that the
    activations stay of order 1."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, c_in, c_out):
        sd[f"{name}.weight"] = torch.from_numpy(
            (rng.standard_normal((c_out, c_in, 3, 3)) * np.sqrt(2.0 / (9 * c_in))).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy((0.05 * rng.standard_normal(c_out)).astype(np.float32))

    for slice_name, idx, c_in, c_out in VGG_CONVS:
        conv(f"vgg_encoder.{slice_name}.{idx}", c_in, c_out)
    for i, (c_in, c_out) in enumerate(tstylizers.DECODER_CONVS, start=1):
        conv(f"decoder.rc{i}.conv", c_in, c_out)
    return sd


def test_adain2d_matches_jax():
    sd = reference_adain_state()
    rng = np.random.default_rng(1)
    content = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    style = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    model = tstylizers.AdaIN2D()
    model.load_state_dict(tstylizers.convert_adain2d_checkpoint(sd))
    jparams = jax.tree.map(jnp.asarray, jstylizers.convert_adain2d_checkpoint(sd))
    for alpha in (1.0, 0.4):
        with torch.no_grad():
            ours = model(torch.from_numpy(content), torch.from_numpy(style), alpha=alpha).numpy()
        ref = np.asarray(jstylizers.AdaIN2D().apply(jparams, jnp.asarray(content), jnp.asarray(style), alpha))
        assert ours.shape == ref.shape == (2, 64, 64, 3)
        scale = np.abs(ref).max()
        assert scale > 0.1
        np.testing.assert_allclose(ours, ref, atol=1e-4 * scale, err_msg=f"alpha {alpha}")
    feats = np.random.default_rng(2).normal(1, 2, (2, 5, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tstylizers.adain(torch.from_numpy(feats), torch.from_numpy(feats[::-1].copy())).numpy(),
        np.asarray(jstylizers.adain(jnp.asarray(feats), jnp.asarray(feats[::-1]))), atol=1e-5)


def test_validate_logs_the_adain_baseline(tmp_path):
    """A stylized run with train.adain_baseline_weights logs
    val_adain_baseline at its validation: the AdaIN2D of context view 0 in
    the style image, at the context's size."""
    weights = tmp_path / "adain.pth"
    torch.save(reference_adain_state(), weights)
    cfg = load_config("configs/experiment/re10k_3view_style.yaml", [
        f"checkpointing.output_dir={tmp_path / 'out'}", f"train.adain_baseline_weights={weights}",
        "train.val_every_n_steps=1", "checkpointing.every_n_train_steps=100", *SMALL_RENDER])
    trainer = Trainer(cfg, model=_tiny())
    batch = trainer_batch(np.random.default_rng(1))
    trainer.fit(max_steps=1, batches=iter([batch]))
    trainer.close()
    pngs = sorted((tmp_path / "out" / "val_adain_baseline").glob("*.png"))
    assert [p.name for p in pngs] == ["00000001.png"]
    from PIL import Image

    assert Image.open(pngs[0]).size == (16, 16)
    # The logged image is the baseline of the validated batch.
    model = tstylizers.AdaIN2D()
    model.load_state_dict(tstylizers.convert_adain2d_checkpoint(reference_adain_state()))
    with torch.no_grad():
        expected = model(torch.as_tensor(batch.context_images[:1, 0], dtype=torch.float32),
                         torch.as_tensor(batch.style_image[:1], dtype=torch.float32))[0].numpy()
    logged = np.asarray(Image.open(pngs[0]), np.float32) / 255.0
    assert np.abs(logged - np.clip(expected, 0, 1)).max() <= 1.0 / 255 + 1e-6


def _converter():
    spec = importlib.util.spec_from_file_location("orbax_to_torch", os.path.join(ROOT, "scripts", "orbax_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("layout", ["full_state", "params"])
def test_orbax_converter_gives_the_ports_state_dict(tmp_path, layout):
    """A tiny JAX model's params saved with StandardCheckpointer, in the
    JAX trainer's full-state layout ({"params", "opt_state", "step"}) or as
    bare params, converted by the script, load into the port's model
    strictly and equal from_jax_params of the params."""
    import optax
    import orbax.checkpoint as ocp

    jm = JModel(sh_degree=0, **TINY)
    params = draw_params(jm, jax.tree.map(jnp.asarray, _batch(np.random.default_rng(0), 32, 32)), seed=7)
    payload = params
    if layout == "full_state":
        # An optimizer state of one moment a weight stands for the trainer's
        # AdamW (two), which the converter drops all the same.
        payload = {"params": params, "opt_state": optax.sgd(1e-3, momentum=0.9).init(params), "step": jnp.asarray(3)}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save((tmp_path / "orbax").absolute(), payload)
    ckptr.wait_until_finished()

    _converter().main([str(tmp_path / "orbax"), str(tmp_path / "model.pth")])
    model = load_checkpoint(TModel(sh_degree=0, device="cpu", **TINY), str(tmp_path / "model.pth"))
    expected = from_jax_params(params)
    state = model.state_dict()
    assert sorted(state) == sorted(expected)
    for key, value in expected.items():
        assert torch.equal(state[key], value), key
    with pytest.raises(SystemExit, match="not an orbax checkpoint directory"):
        _converter().main([str(tmp_path / "model.pth"), str(tmp_path / "again.pth")])
