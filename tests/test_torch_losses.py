"""Port parity for the losses: each loss's value, and its gradient w.r.t. the
prediction, against the JAX package with the flax params carried across by
from_jax_params.

Tolerance: 1e-5 relative on values and 1e-4 of the largest magnitude on
gradients. Everything runs in f32 on the CPU; the convs and the reductions
sum in other orders in XLA and in PyTorch, and the std and unit-norm
divisions of the style and LPIPS losses amplify that in the gradients."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.losses import lpips as jlpips
from styl3r_tpu.losses import style as jstyle
from styl3r_tpu.losses import vgg as jvgg
from styl3r_tpu.losses.basic import mse_loss as j_mse
from styl3r_tpu.train import losses as jtl
from styl3r_tpu_torch.losses import lpips as tlpips
from styl3r_tpu_torch.losses import style as tstyle
from styl3r_tpu_torch.losses import vgg as tvgg
from styl3r_tpu_torch.losses.basic import mse_loss as t_mse
from styl3r_tpu_torch.train import losses as ttl
from styl3r_tpu_torch.utils.convert import from_jax_params
from test_torch_model import draw_params

HW = 32


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _close(a, b, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=0)


def _grad_close(a, b, tol=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    scale = float(np.abs(b).max())
    assert scale > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module")
def vgg():
    """VGG19 features with numpy-drawn flax params, in both packages."""
    x = jnp.zeros((1, HW, HW, 3))
    params = draw_params(jvgg.VGG19Features(), x, seed=3)
    tm = tvgg.VGG19Features()
    tm.load_state_dict(from_jax_params(params, model="vgg19"))
    jm = jvgg.VGG19Features()
    return (lambda y: jm.apply(params, y)), tm.requires_grad_(False)


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_vgg19_features_match_jax(vgg):
    japply, tm = vgg
    assert sorted(tm.state_dict()) == sorted(
        f"features.{i}.{k}" for i in (0, 2, 5, 7, 10, 12, 14, 16, 19) for k in ("weight", "bias")
    )
    x = _images(0, (2, HW, HW, 3))
    j_feats = japply(jvgg.imagenet_normalize(jnp.asarray(x)))
    t_feats = tm(tvgg.imagenet_normalize(_t(x)))
    assert [tuple(f.shape) for f in t_feats] == [(2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256), (2, 4, 4, 512)]
    for a, b in zip(t_feats, j_feats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5 * float(np.abs(b).max()))


def test_calc_mean_std_matches_jax():
    feat = np.random.default_rng(1).normal(size=(3, 5, 4, 7)).astype(np.float32)
    for a, b in zip(tstyle.calc_mean_std(_t(feat)), jstyle.calc_mean_std(jnp.asarray(feat))):
        _close(a.numpy(), b)


def _value_and_grad_pair(j_fn, t_fn, *arrays):
    """(value, grad w.r.t. the first array) in both packages."""
    jv, jg = jax.jit(jax.value_and_grad(lambda p: j_fn(p, *map(jnp.asarray, arrays[1:]))))(jnp.asarray(arrays[0]))
    p = _t(arrays[0]).requires_grad_()
    tv = t_fn(p, *map(_t, arrays[1:]))
    (tg,) = torch.autograd.grad(tv, p)
    return (float(tv), float(jv)), (tg.numpy(), np.asarray(jg))


def test_style_loss_matches_jax(vgg):
    japply, tm = vgg
    pred, target = _images(2, (1, 2, HW, HW, 3)), _images(3, (1, 2, HW, HW, 3))
    style = _images(4, (1, HW, HW, 3))
    (tv, jv), (tg, jg) = _value_and_grad_pair(
        lambda p, t, s: jstyle.style_loss(japply, p, t, s, 10.0)[0],
        lambda p, t, s: tstyle.style_loss(tm, p, t, s, 10.0)[0],
        pred, target, style,
    )
    _close(tv, jv)
    _grad_close(tg, jg)
    _, t_metrics = tstyle.style_loss(tm, _t(pred), _t(target), _t(style))
    _, j_metrics = jstyle.style_loss(japply, *map(jnp.asarray, (pred, target, style)))
    for k in ("style_content", "style_stats"):
        _close(float(t_metrics[k]), float(j_metrics[k]))


def test_identity_loss_matches_jax(vgg):
    japply, tm = vgg
    pred, target = _images(5, (1, 2, HW, HW, 3)), _images(6, (1, 2, HW, HW, 3))
    (tv, jv), (tg, jg) = _value_and_grad_pair(
        lambda p, t: jstyle.identity_loss(japply, p, t),
        lambda p, t: tstyle.identity_loss(tm, p, t),
        pred, target,
    )
    _close(tv, jv)
    _grad_close(tg, jg)


def _lpips_states(seed):
    """A torchvision-vgg16-like and an lpips-package-like state dict, drawn
    with numpy; some lin weights negative, which the loss clamps."""
    rng = np.random.default_rng(seed)
    vgg16 = {}
    for spec in tlpips.VGG16_SLICE_CONVS:
        for layer in spec:
            if layer != "pool":
                idx, c_in, c_out = layer
                vgg16[f"features.{idx}.weight"] = (rng.normal(size=(c_out, c_in, 3, 3)) / np.sqrt(9 * c_in)).astype(np.float32)
                vgg16[f"features.{idx}.bias"] = (0.05 * rng.normal(size=c_out)).astype(np.float32)
    lins = {f"lin{i}.model.1.weight": rng.uniform(-0.2, 1.0, (1, c, 1, 1)).astype(np.float32)
            for i, c in enumerate(tlpips.LPIPS_CHANNELS)}
    return lins, vgg16


def test_lpips_matches_jax():
    lins, vgg16 = _lpips_states(7)
    j_params = jlpips.convert_lpips_state(lins, vgg16)
    tm = tlpips.LPIPSVgg16()
    tm.load_state_dict(tlpips.convert_lpips_state(lins, {k: _t(v) for k, v in vgg16.items()}))
    tm_bridge = tlpips.LPIPSVgg16()
    tm_bridge.load_state_dict(from_jax_params(j_params, model="lpips"))
    for a, b in zip(tm.state_dict().values(), tm_bridge.state_dict().values()):
        assert torch.equal(a, b)
    tm.requires_grad_(False)
    jm = jlpips.LPIPSVgg16()
    x, y = _images(8, (2, HW, HW, 3)), _images(9, (2, HW, HW, 3))
    (tv, jv), (tg, jg) = _value_and_grad_pair(
        lambda p, q: jm.apply(j_params, p, q).mean(), lambda p, q: tm(p, q).mean(), x, y,
    )
    _close(tv, jv)
    _grad_close(tg, jg)


def test_mse_loss_matches_jax():
    pred, target = _images(10, (2, 3, 8, 8, 3)), _images(11, (2, 3, 8, 8, 3))
    (tv, jv), (tg, jg) = _value_and_grad_pair(
        lambda p, t: j_mse(p, t, 0.5), lambda p, t: t_mse(p, t, 0.5), pred, target
    )
    _close(tv, jv)
    _grad_close(tg, jg, tol=1e-6)


def _gaussians(seed):
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=4.0, size=(2, 300, 3)).astype(np.float32)
    opacities = rng.uniform(0.0, 0.25, (2, 300)).astype(np.float32)
    return means, opacities


def test_scratch_stabilizer_matches_jax():
    means, opacities = _gaussians(12)
    (tv, jv), (tg, jg) = _value_and_grad_pair(
        lambda m, o: jtl.scratch_stabilizer(SimpleNamespace(means=m, opacities=o))[0],
        lambda m, o: ttl.scratch_stabilizer(SimpleNamespace(means=m, opacities=o))[0],
        means, opacities,
    )
    _close(tv, jv)
    _grad_close(tg, jg, tol=1e-6)
    t_metrics = ttl.scratch_stabilizer(SimpleNamespace(means=_t(means), opacities=_t(opacities)))[1]
    j_metrics = jtl.scratch_stabilizer(SimpleNamespace(means=jnp.asarray(means), opacities=jnp.asarray(opacities)))[1]
    for k, v in j_metrics.items():
        assert float(v) > 0, k  # every term active here
        _close(float(t_metrics[k]), float(v))


def test_sparse_anchor_loss_matches_jax():
    means, _ = _gaussians(13)
    rng = np.random.default_rng(14)
    anchor = dict(
        flat_idx=rng.integers(0, 300, (2, 40)).astype(np.int32),
        target=rng.normal(scale=4.0, size=(2, 40, 3)).astype(np.float32),
        mask=(rng.uniform(size=(2, 40)) > 0.3).astype(np.float32),
    )
    jv, jg = jax.value_and_grad(lambda m: jtl.sparse_anchor_loss(
        SimpleNamespace(means=m), {k: jnp.asarray(v) for k, v in anchor.items()}))(jnp.asarray(means))
    m = _t(means).requires_grad_()
    tv = ttl.sparse_anchor_loss(SimpleNamespace(means=m), {
        "flat_idx": torch.from_numpy(anchor["flat_idx"]), "target": _t(anchor["target"]), "mask": _t(anchor["mask"]),
    })
    (tg,) = torch.autograd.grad(tv, m)
    _close(float(tv), float(jv))
    _grad_close(tg.numpy(), np.asarray(jg), tol=1e-6)


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_loss_bundle_matches_jax(vgg, stage):
    """Stage 1: MSE (plus LPIPS, which no config turns on, gated by step);
    stage 2: style 10 and the identity branch. The value, every metric, and
    the gradients w.r.t. both renders."""
    japply, tm = vgg
    x = jnp.zeros((1, HW, HW, 3))
    vgg_params = draw_params(jvgg.VGG19Features(), x, seed=3)
    lins, vgg16 = _lpips_states(7)
    if stage == "stage1":
        kw = dict(mse_weight=1.0, lpips_weight=0.05, lpips_apply_after_step=0)
    else:
        kw = dict(mse_weight=None, style_weight=10.0, identity=True)
    jb = jtl.LossBundle(**kw, vgg19_params=vgg_params, lpips_params=jlpips.convert_lpips_state(lins, vgg16))
    lpips = tlpips.LPIPSVgg16()
    lpips.load_state_dict(tlpips.convert_lpips_state(lins, {k: _t(v) for k, v in vgg16.items()}))
    tb = ttl.LossBundle(**kw, vgg19=tm, lpips=lpips.requires_grad_(False))

    color, id_color = _images(15, (1, 2, HW, HW, 3)), _images(16, (1, 2, HW, HW, 3))
    target, style = _images(17, (1, 2, HW, HW, 3)), _images(18, (1, HW, HW, 3))

    def j_loss(c, ic):
        batch = SimpleNamespace(target_images=jnp.asarray(target), style_image=jnp.asarray(style))
        return jb(SimpleNamespace(color=c), batch, None, 3, SimpleNamespace(color=ic))

    (jv, j_metrics), jg = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(color), jnp.asarray(id_color))
    c, ic = _t(color).requires_grad_(), _t(id_color).requires_grad_()
    batch = SimpleNamespace(target_images=_t(target), style_image=_t(style))
    tv, t_metrics = tb(SimpleNamespace(color=c), batch, None, 3, SimpleNamespace(color=ic))
    tg = torch.autograd.grad(tv, (c, ic), allow_unused=True)
    _close(float(tv), float(jv))
    assert sorted(t_metrics) == sorted(j_metrics)
    for k, v in j_metrics.items():
        _close(float(t_metrics[k]), float(v))
    for a, b in zip(tg, jg):
        if float(np.abs(np.asarray(b)).max()) == 0:
            assert a is None or float(a.abs().max()) == 0
        else:
            _grad_close(a.numpy(), b)
    if stage == "stage1":  # before lpips_apply_after_step the term is 0
        gated = ttl.LossBundle(**dict(kw, lpips_apply_after_step=5), lpips=lpips)
        _, m = gated(SimpleNamespace(color=_t(color)), batch, None, 3)
        assert float(m["lpips"]) == 0.0
