"""Port parity for the typed config: styl3r_tpu_torch.utils.config against
styl3r_tpu.utils.config on every file under configs/ and on dotted
overrides (list items by index included); and the trainer's check of
`model.decoder.impl` against the device. Exact: both build the same
dataclass values."""

import dataclasses
from pathlib import Path

import pytest
import torch

from styl3r_tpu.utils import config as jconfig
from styl3r_tpu_torch.train.trainer import render_settings
from styl3r_tpu_torch.utils import config as tconfig

CONFIGS = sorted(str(p) for p in Path("configs").rglob("*.yaml"))


def _same(ours, ref):
    assert type(ours).__name__ == type(ref).__name__
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("path", CONFIGS)
def test_every_config_file_loads_as_in_jax(path):
    _same(tconfig.load_config(path), jconfig.load_config(path))


@pytest.mark.parametrize("overrides", [
    ["datasets.0.roots=[/data/a, /data/b]", "datasets.0.view_sampler.num_context_views=2", "train.batch_size=2"],
    ["datasets.1.original_image_shape=[270, 480]", "optimizer.lr=3e-5", "losses.mse=null", "checkpointing.resume=true"],
    ["model.decoder.background_color=[1, 1, 1]", "train.seed=7", "wandb.mode=offline", "losses.identity=yes"],
], ids=["list-index", "second-dataset", "scalars"])
def test_overrides_apply_as_in_jax(overrides):
    path = "configs/experiment/re10k_dl3dv_3view_style.yaml"
    _same(tconfig.load_config(path, overrides), jconfig.load_config(path, overrides))
    _same(tconfig.load_config(None, overrides[-1:]), jconfig.load_config(None, overrides[-1:]))
    with pytest.raises(ValueError):
        tconfig.apply_overrides({}, ["no_equals_sign"])


def test_decoder_impl_is_checked_against_the_device():
    cfg = tconfig.load_config("configs/main.yaml", ["model.decoder.pair_cap_per_gaussian=2"])
    kw = render_settings(cfg, torch.device("cpu"))
    assert kw["pair_cap_per_gaussian"] == 2 and kw["max_per_tile"] == 4096 and kw["background_color"].shape == (3,)
    assert "impl" not in kw  # the renderer follows the tensors' device
    cfg.model.decoder.impl = "jnp"
    assert render_settings(cfg, torch.device("cpu")).keys() == kw.keys()
    # "jnp" on CUDA raises before any tensor is made on the device.
    for impl, device in (("pallas", "cpu"), ("jnp", "cuda"), ("triton", "cpu")):
        cfg.model.decoder.impl = impl
        with pytest.raises(ValueError, match="impl"):
            render_settings(cfg, torch.device(device))
