"""Port parity for the model registry's encoder family and the point-cloud
helpers: the 2-view token-style encoder (its distill_only return too) and
the NoPoSplat encoder against the JAX package on flax params carried by
from_jax_params, the linear heads, geometry/ptc_geometry.py, the
registry's names and errors, and the encoder checkpoint converters against
the JAX converters on a synthetic state dict with the reference's key
names.

Tolerances: the encoders' Gaussians 1e-4 of each field's largest magnitude
(the whole-model tolerance of tests/test_torch_model.py: two encoder and
four decoder blocks, DPT heads and the adapter sum in another order, and
the means go through expm1); the linear heads 1e-5 (one matmul, then
expm1); ptc_geometry 1e-5 relative (elementwise f32 and sums of at most 2 *
24 * 32 values), its quantiles exactly (the same sort and selection);
converters exactly (they only rename and reshape)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.geometry import ptc_geometry as jptc
from styl3r_tpu.models import dpt as jdpt
from styl3r_tpu.models.encoder import NoPoSplatMultiEncoder as JNoPoSplat
from styl3r_tpu.models.encoder import Styl3rTokenStyleEncoder2View as JTokenStyle
from styl3r_tpu.utils import checkpoint as jckpt
from styl3r_tpu_torch.geometry import ptc_geometry as tptc
from styl3r_tpu_torch.models import dpt as tdpt
from styl3r_tpu_torch.models import registry
from styl3r_tpu_torch.models.backbones import BackboneDino, BackboneResnet
from styl3r_tpu_torch.models.croco import CrocoEncBackbone, MultiViewCrocoBackbone
from styl3r_tpu_torch.models.distiller import Dust3RTeacher
from styl3r_tpu_torch.models.encoder import NoPoSplatMultiEncoder, Styl3rEncoder, Styl3rTokenStyleEncoder2View
from styl3r_tpu_torch.utils import checkpoint as tckpt
from styl3r_tpu_torch.utils import convert
from styl3r_tpu_torch.utils.convert import from_jax_params
from test_torch_dpt import HEAD, HOOK_DIMS, _tokens, perturb
from test_torch_model import TINY, _scaled_close, draw_params

HW = (32, 32)
ENCODERS = {
    "token_style_2view": (JTokenStyle, Styl3rTokenStyleEncoder2View),
    "noposplat_multi": (JNoPoSplat, NoPoSplatMultiEncoder),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    k = np.tile(np.asarray([[0.9, 0, 0.5], [0, 1.1, 0.45], [0, 0, 1.0]], np.float32), (2, 2, 1, 1))
    images = rng.uniform(-1, 1, (2, 2, *HW, 3)).astype(np.float32)
    style = rng.uniform(-1, 1, (2, *HW, 3)).astype(np.float32)
    return images, k, style


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_matches_jax(name):
    """Gaussians and aux points at the model tolerance; the 2-view encoder's
    distill_only return is {pts3d, depths}, those points."""
    jcls, tcls = ENCODERS[name]
    args = _inputs(3)
    jargs = [jnp.asarray(x) for x in args]
    jm = jcls(sh_degree=1, **TINY)
    params = draw_params(jm, *jargs, seed=4)
    jg, jaux = jax.jit(lambda p, *a: jm.apply(p, *a, return_aux=True))(params, *jargs)
    tm = tcls(sh_degree=1, **TINY).eval()
    tm.load_state_dict(from_jax_params(params, model=name))
    targs = [torch.from_numpy(x) for x in args]
    with torch.no_grad():
        tg, taux = tm(*targs, return_aux=True)
    for field in jg._fields:
        _scaled_close(getattr(tg, field).numpy(), getattr(jg, field))
    assert tg.means.shape == (2, 2 * HW[0] * HW[1], 3)
    for key in ("pts3d", "depths", "densities"):
        _scaled_close(taux[key].numpy(), jaux[key])
    if name == "token_style_2view":
        jd = jax.jit(lambda p, *a: jm.apply(p, *a, distill_only=True))(params, *jargs)
        with torch.no_grad():
            td = tm(*targs, distill_only=True)
        assert sorted(td) == sorted(jd) == ["depths", "pts3d"]
        _scaled_close(td["pts3d"].numpy(), jd["pts3d"])
        with pytest.raises(ValueError, match="2-view"):
            tm(torch.zeros(1, 3, *HW, 3), torch.zeros(1, 3, 3, 3), torch.zeros(1, *HW, 3))


def _carried(fill, params, name):
    """One flax subtree through the weights bridge's converter `fill`."""
    out = {}
    fill(params, out, name)
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in out.items()}


@pytest.mark.parametrize("with_conf", [False, True], ids=["pts3d", "pts3d_conf"])
def test_linear_pts3d_head_matches_jax(with_conf):
    rng = np.random.default_rng(5)
    tokens = _tokens(rng)
    h, w = 32, 48
    jm = jdpt.LinearPts3dHead(with_conf=with_conf)
    jt = [jnp.asarray(t) for t in tokens]
    p = perturb(jm.init(jax.random.key(0), jt, (h, w)), 6)
    tm = tdpt.LinearPts3dHead(HOOK_DIMS[-1], with_conf=with_conf)
    tm.load_state_dict(_carried(convert._linear, p["params"]["proj"], "proj"))
    with torch.no_grad():
        out = tm([torch.from_numpy(t) for t in tokens], (h, w))
    ref = jm.apply(p, jt, (h, w))
    outs, refs = (out, ref) if with_conf else ((out,), (ref,))
    assert outs[0].shape == (2, h, w, 3)
    for a, b in zip(outs, refs):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def test_linear_gs_head_matches_jax():
    rng = np.random.default_rng(7)
    tokens = _tokens(rng)
    h, w = 32, 48
    jm = jdpt.LinearGSHead(out_channels=11)
    jt = [jnp.asarray(t) for t in tokens]
    p = perturb(jm.init(jax.random.key(0), jt, (h, w)), 8)
    tm = tdpt.LinearGSHead(HOOK_DIMS[-1], out_channels=11)
    tm.load_state_dict(_carried(convert._linear, p["params"]["proj"], "proj"))
    with torch.no_grad():
        out = tm([torch.from_numpy(t) for t in tokens], (h, w))
    assert out.shape == (2, h, w, 11)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply(p, jt, (h, w))), rtol=1e-5, atol=1e-5)


# --- ptc_geometry ------------------------------------------------------------


def _cloud(seed, b=2, h=24, w=32):
    rng = np.random.default_rng(seed)
    pts1 = rng.normal(size=(b, h, w, 3)).astype(np.float32) * 3.0
    pts2 = rng.normal(size=(b, h, w, 3)).astype(np.float32) * 2.0
    # Ties: a block of equal points in each view.
    pts1[:, :4, :4] = 1.5
    pts2[:, -3:, -5:] = -0.5
    valid1 = rng.uniform(size=(b, h, w)) > 0.3
    valid2 = rng.uniform(size=(b, h, w)) > 0.2
    return pts1, pts2, valid1, valid2


def _close(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["avg_dis", "avg_log1p", "median_dis", "sqrt_dis"])
@pytest.mark.parametrize("views", ["one", "two"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_normalize_pointcloud_matches_jax(mode, views, masked):
    pts1, pts2, valid1, valid2 = _cloud(1)
    kw = dict(norm_mode=mode)
    if masked:
        kw.update(valid1=valid1, valid2=valid2 if views == "two" else None)
    second = pts2 if views == "two" else None

    def args(to):
        return [to(pts1), None if second is None else to(second)], {
            k: v if isinstance(v, str) or v is None else to(v) for k, v in kw.items()
        }

    a, k = args(torch.from_numpy)
    b, kb = args(jnp.asarray)
    _close(tptc.normalize_pointcloud(*a, **k), jptc.normalize_pointcloud(*b, **kb))


@pytest.mark.parametrize("quantile", [0.1, 0.5, 0.93])
def test_joint_depth_and_center_scale_match_jax(quantile):
    """Weighted quantiles select the same element (ties included), so they
    agree exactly."""
    pts1, pts2, valid1, valid2 = _cloud(2)
    t = [torch.from_numpy(x) for x in (pts1, pts2, valid1, valid2)]
    j = [jnp.asarray(x) for x in (pts1, pts2, valid1, valid2)]
    np.testing.assert_array_equal(
        tptc.get_joint_pointcloud_depth(t[0][..., 2], t[1][..., 2], t[2], t[3], quantile=quantile).numpy(),
        np.asarray(jptc.get_joint_pointcloud_depth(j[0][..., 2], j[1][..., 2], j[2], j[3], quantile=quantile)),
    )
    np.testing.assert_array_equal(
        tptc.get_joint_pointcloud_depth(t[0][..., 2], quantile=quantile).numpy(),
        np.asarray(jptc.get_joint_pointcloud_depth(j[0][..., 2], quantile=quantile)),
    )
    for kw in (dict(), dict(z_only=True), dict(center=False)):
        _close(tptc.get_joint_pointcloud_center_scale(*t, **kw), jptc.get_joint_pointcloud_center_scale(*j, **kw))
    _close(tptc.get_joint_pointcloud_center_scale(t[0]), jptc.get_joint_pointcloud_center_scale(j[0]))


def test_geotrf_depthmaps_and_intrinsics_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    rot = rng.normal(size=(2, 1, 1, 3, 3)).astype(np.float32)
    hom = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1, 1, 1))
    hom[..., :3, :3] = rot
    hom[..., :3, 3] = rng.normal(size=(2, 1, 1, 3))
    for trf in (rot, hom):
        for kw in (dict(), dict(norm=1), dict(norm=2.5, ncol=2)):
            _close(tptc.geotrf(torch.from_numpy(trf), torch.from_numpy(pts), **kw),
                   jptc.geotrf(jnp.asarray(trf), jnp.asarray(pts), **kw))
    with pytest.raises(ValueError, match="incompatible"):
        tptc.geotrf(torch.zeros(5, 5), torch.from_numpy(pts))

    depth = rng.uniform(-0.5, 4.0, size=(6, 9)).astype(np.float32)
    k = np.asarray([[50.0, 0, 4.5], [0, 55.0, 3.0], [0, 0, 1]], np.float32)
    pose = hom[0, 0, 0]
    for fn in ("depthmap_to_camera_coordinates", "depthmap_to_absolute_camera_coordinates"):
        extra = (pose,) if "absolute" in fn else ()
        a = getattr(tptc, fn)(*(torch.from_numpy(x) for x in (depth, k, *extra)))
        b = getattr(jptc, fn)(*(jnp.asarray(x) for x in (depth, k, *extra)))
        _close(a[0], b[0])
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b[1]))
    kk = np.stack([k, 2 * k])
    for fn in ("colmap_to_opencv_intrinsics", "opencv_to_colmap_intrinsics"):
        t = torch.from_numpy(kk)
        _close(getattr(tptc, fn)(t), getattr(jptc, fn)(jnp.asarray(kk)))
        assert torch.equal(t, torch.from_numpy(kk))  # the input is not changed


# --- the registry ------------------------------------------------------------


def test_registry_names_and_errors():
    tiny = dict(enc_depth=1, dec_depth=2, enc_dim=32, dec_dim=16, enc_heads=2, dec_heads=2)
    heads = dict(head_feature_dim=16, head_last_dim=16, head_layer_dims=(8, 8, 16, 16))
    assert type(registry.get_encoder("noposplat_multi_token_style", **tiny, **heads)) is Styl3rEncoder
    assert type(registry.get_encoder("noposplat_token_style", **tiny, **heads)) is Styl3rTokenStyleEncoder2View
    for name in ("noposplat", "noposplat_multi"):
        assert type(registry.get_encoder(name, **tiny, **heads)) is NoPoSplatMultiEncoder
    for name in ("croco", "croco_multi"):
        assert type(registry.get_backbone(name, **tiny)) is MultiViewCrocoBackbone
    assert type(registry.get_backbone("croco_enc", enc_depth=1, enc_dim=32, enc_heads=2)) is CrocoEncBackbone
    assert type(registry.get_backbone("resnet", model="resnet18", num_layers=2, d_out=4)) is BackboneResnet
    assert type(registry.get_backbone("dino", model="dino_vits8", d_out=4, image_size=(16, 16))) is BackboneDino
    head_kw = dict(hook_dims=HOOK_DIMS, **HEAD)
    assert type(registry.get_head("dpt", last_dim=16, **head_kw)) is tdpt.DPTPts3dHead
    assert type(registry.get_head("dpt_gs", out_channels=8, **head_kw)) is tdpt.DPTGSHead
    assert type(registry.get_head("dpt_gs_sh", out_channels=3, **head_kw)) is tdpt.DPTGSSHHead
    assert type(registry.get_head("linear", dec_dim=16)) is tdpt.LinearPts3dHead
    assert type(registry.get_head("linear_gs", out_channels=11, dec_dim=16)) is tdpt.LinearGSHead
    for name in ("splatting", "splatting_cuda"):
        assert callable(registry.get_decoder(name, max_per_tile=128))
    for name in ("dust3r", "mast3r"):
        assert type(registry.get_distiller(name, **tiny, **heads)) is Dust3RTeacher
    for factory in (registry.get_encoder, registry.get_backbone, registry.get_head, registry.get_decoder,
                    registry.get_distiller):
        with pytest.raises(ValueError, match="unknown"):
            factory("bogus")


# --- the converters ------------------------------------------------------------


def _reference_state_dict(module, seed, prefix="encoder."):
    """A module's state dict with random values under the reference's
    Lightning names, plus the refinenet4.resConfUnit1 entries that released
    checkpoints carry and neither model uses, and an entry of another
    module."""
    g = torch.Generator().manual_seed(seed)
    sd = {prefix + k: torch.randn(v.shape, generator=g) for k, v in module.state_dict().items()}
    for k in list(sd):
        if k.endswith("refinenet3.resConfUnit1.conv1.weight"):
            base = k[: -len("refinenet3.resConfUnit1.conv1.weight")]
            for conv in ("conv1", "conv2"):
                for leaf, src in (("weight", "weight"), ("bias", "bias")):
                    sd[f"{base}refinenet4.resConfUnit1.{conv}.{leaf}"] = sd[f"{base}refinenet3.resConfUnit1.conv1.{src}"]
    sd["decoder.background"] = torch.zeros(3)
    return sd


def _no_unused(sd):
    return {k: v for k, v in sd.items() if tckpt.UNUSED_KEY not in k}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_converters_match_jax(name):
    """convert_token_style_encoder / convert_noposplat_multi_encoder load
    strictly and give the JAX converters' params back through
    from_jax_params; a NoPoSplat checkpoint without dec_blocks2 seeds it from
    dec_blocks in both."""
    tcls = ENCODERS[name][1]
    module = tcls(sh_degree=1, **TINY)
    sd = _reference_state_dict(module, seed=9)
    if name == "noposplat_multi":
        sd = {k: v for k, v in sd.items() if ".dec_blocks2." not in k}
        ours = tckpt.convert_noposplat_multi_encoder(sd)
        theirs = jckpt.convert_noposplat_multi_encoder(sd)
        assert torch.equal(ours["backbone.dec_blocks2.1.mlp.fc1.weight"], ours["backbone.dec_blocks.1.mlp.fc1.weight"])
    else:
        ours = tckpt.convert_token_style_encoder(sd)
        theirs = jckpt.convert_token_style_encoder(sd)
    module.load_state_dict(ours, strict=True)
    via_jax = _no_unused(from_jax_params(theirs, model=name))
    assert ours.keys() == via_jax.keys()
    for k, v in ours.items():
        assert torch.equal(v, via_jax[k]), k


def test_backbone_and_structure_builder_converters():
    """The bare CrocoEncBackbone and StructureBuilder keys, as the JAX
    converters read them (through the weights bridge)."""
    module = Styl3rTokenStyleEncoder2View(sh_degree=0, **TINY)
    sd = _reference_state_dict(module, seed=10, prefix="")
    enc = tckpt.convert_croco_enc_backbone(sd)
    module.backbone.load_state_dict(enc, strict=True)
    sb = tckpt.convert_structure_builder(sd)
    module.structure_builder.load_state_dict(sb, strict=True)
    for ours, theirs in ((enc, jckpt.convert_croco_enc_backbone(sd)), (sb, jckpt.convert_structure_builder(sd))):
        via_jax = {k[2:]: v for k, v in _carried(convert._croco, theirs, "m").items()}
        assert ours.keys() == via_jax.keys()
        for k, v in ours.items():
            assert torch.equal(v, via_jax[k]), k


def test_flax_param_shapes_carry_across():
    """from_jax_params of a freshly drawn flax tree covers every parameter of
    the port's module, for each of the new layouts."""
    images, k, style = (jnp.asarray(x) for x in _inputs(0))
    for name, (jcls, tcls) in ENCODERS.items():
        params = draw_params(jcls(sh_degree=0, **TINY), images, k, style, seed=1)
        tcls(sh_degree=0, **TINY).load_state_dict(from_jax_params(params, model=name), strict=True)
    with pytest.raises(ValueError, match="unknown model"):
        from_jax_params({}, model="bogus")
