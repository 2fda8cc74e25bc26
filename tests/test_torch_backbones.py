"""NoPoSplat's legacy backbones: styl3r_tpu_torch.models.backbones against
styl3r_tpu's, on the same numpy inputs and flax params carried across by
from_jax_params; and the JAX package's converters (convert_backbone_resnet,
convert_dino_vit) reading the port's state_dict() back into those params.

Tolerances: 1e-4 of the output's largest magnitude (f32 convolutions,
instance norms and attention summed in another order) plus the JAX
module's own distance from the port run in float64 (close_to_jax):
resnet50's layer-4 instance norm over 2x2 pixels divides by channels'
near-zero spread, and there each f32 side is ~4e-4 of the scale off the
float64 value (4x4 pixels: ~5e-5); the bilinear resize 1e-5; the round
trip exactly, but for dino_resnet50's BatchNorm, whose running_var = 1 - eps
folds back to a scale within 1e-6 of the flax one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.models import backbones as jb
from styl3r_tpu_torch.models import backbones as tb
from styl3r_tpu_torch.utils.convert import from_jax_params
from tests.test_torch_stylizers3d import close_to_jax, flax_params


def _same_tree(back, params, rtol=0.0):
    """Every leaf of the flax params is in `back`, equal to it."""
    def check(path, leaf):
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_allclose(np.asarray(got), np.asarray(leaf), rtol=rtol, atol=0, err_msg=str(path))

    jax.tree_util.tree_map_with_path(check, params)


@pytest.mark.parametrize("out_hw", [(16, 12), (3, 4), (5, 7)])
def test_resize_bilinear_align_corners_matches_jax(out_hw):
    x = np.random.default_rng(3).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ours = tb.resize_bilinear_align_corners(torch.from_numpy(x), out_hw)
    ref = jax.jit(jb.resize_bilinear_align_corners, static_argnums=1)(jnp.asarray(x), out_hw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("model", ["resnet18", "resnet50"])
def test_backbone_resnet_matches_jax(model):
    """All four layers at 64x64 (num_layers 5: layer 4 keeps 2x2 pixels for
    its instance norm), the basic block and the bottleneck."""
    images = np.random.default_rng(1).uniform(-1, 1, (1, 2, 64, 64, 3)).astype(np.float32)
    jmod = jb.BackboneResnet(model=model, num_layers=5, d_out=16)
    params = flax_params(jmod, jnp.asarray(images), seed=2)
    port = tb.BackboneResnet(model, num_layers=5, d_out=16)
    port.load_state_dict(from_jax_params(params, model="backbone_resnet"))
    ours = close_to_jax(port, (images,), jax.jit(jmod.apply)(params, jnp.asarray(images)))
    assert ours.shape == (1, 2, 64, 64, 16)
    back = jb.convert_backbone_resnet(port.state_dict(), model, num_layers=5)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    _same_tree(back, params)


@pytest.fixture(scope="module")
def dino():
    images = np.random.default_rng(4).uniform(-1, 1, (1, 2, 16, 16, 3)).astype(np.float32)
    jmod = jb.BackboneDino(model="dino_vits8", d_out=8)
    params = flax_params(jmod, jnp.asarray(images), seed=5)
    port = tb.BackboneDino("dino_vits8", d_out=8, image_size=(16, 16))
    port.load_state_dict(from_jax_params(params, model="backbone_dino"))
    return images, jmod, params, port


def test_backbone_dino_matches_jax(dino):
    """ViT-S/8 at 16x16 (cls + 4 patch tokens) and the dino_resnet50
    pyramid (frozen BatchNorm, no first pool)."""
    images, jmod, params, port = dino
    ours = close_to_jax(port, (images,), jax.jit(jmod.apply)(params, jnp.asarray(images)))
    assert ours.shape == (1, 2, 16, 16, 8)


def test_backbone_dino_state_dict_round_trips(dino):
    _, _, params, port = dino
    sd = port.state_dict()
    p = params["params"]
    vit = jb.convert_dino_vit(sd, prefix="dino.")
    assert jax.tree.structure(vit) == jax.tree.structure(p["dino"])
    _same_tree(vit, p["dino"])
    resnet_sd = {k[len("resnet_backbone."):]: v for k, v in sd.items() if k.startswith("resnet_backbone.")}
    back = jb.convert_backbone_resnet(resnet_sd, "dino_resnet50", num_layers=4)["params"]
    assert jax.tree.structure(back) == jax.tree.structure(p["resnet_backbone"])
    _same_tree(back, p["resnet_backbone"], rtol=1e-6)
    for mlp in ("global_token_mlp", "local_token_mlp"):
        np.testing.assert_array_equal(sd[f"{mlp}.0.weight"].numpy().T, p[f"{mlp}_fc1"]["kernel"])
        np.testing.assert_array_equal(sd[f"{mlp}.2.bias"].numpy(), p[f"{mlp}_fc2"]["bias"])


def test_backbone_dino_checks_its_input_size():
    port = tb.BackboneDino("dino_vits8", d_out=4, image_size=(16, 16))
    with pytest.raises(ValueError, match="divisible by patch size 8"):
        port(torch.zeros(1, 1, 20, 16, 3))
    with pytest.raises(ValueError, match="built for"):
        port(torch.zeros(1, 1, 24, 16, 3))
    assert port.dino.pos_embed.shape == (1, 5, 384)
    assert port.global_token_mlp[0].in_features == 384 and port.global_token_mlp[0].out_features == 768
