"""The point-cloud stylizers and the secondary losses:
styl3r_tpu_torch.models.stylizers' 3-D half (adain_pointcloud,
linear_stylizer, NormalizedVGG, adain_cs, MLP1d, LST and the Linear3D /
AdaIN3D / AdaAttN3D stylizers), losses.adaattn and losses.depth against
styl3r_tpu's, on the same numpy inputs (64 points, 32x32 style images) and
flax params carried across by from_jax_params; and the JAX package's
converters reading the port's state_dict() back into those params.

Tolerances: 1e-4 of the output's largest magnitude for the networks and the
eigh whitening (f32 convolutions, matmuls and eigendecompositions summed in
another order); 1e-5 for the closed-form functions and the losses; the
converters' round trip exactly. The stylizers are held at 1e-4 of the
scale plus the JAX module's own distance from the port run in float64
(close_to_jax): AdaAttN3D's standard deviation is sqrt(E[s^2] - E[s]^2)
under the attention, which cancels where a point's attention is nearly
one-hot, and there each f32 side is ~4e-4 of the scale off the float64
value.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.losses import adaattn as jadaattn
from styl3r_tpu.losses import depth as jdepth
from styl3r_tpu.losses.vgg import VGG19Features as JVGG19
from styl3r_tpu.models import stylizers as js
from styl3r_tpu_torch.losses import adaattn as tadaattn
from styl3r_tpu_torch.losses import depth as tdepth
from styl3r_tpu_torch.losses.vgg import VGG19Features as TVGG19
from styl3r_tpu_torch.models import stylizers as ts
from styl3r_tpu_torch.utils.convert import from_jax_params

N_POINTS = 64
STYLE_HW = 32


def flax_params(module, *args, seed):
    """Flax params of `module` drawn with seeded numpy: lecun-normal kernels,
    noise on every other leaf (biases, scales)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return (0.05 * rng.standard_normal(leaf.shape) + (path[-1].key == "scale")).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_with(module, params, kind):
    """`module` with the flax params carried across. A NormalizedVGG's
    convs past its layer are not in them (the flax module never builds
    them); only those may be missing."""
    missing, unexpected = module.load_state_dict(from_jax_params(params, model=kind), strict=False)
    p = params["params"]
    ran = set(p.get("vgg", p))  # conv<index>
    assert not unexpected
    assert all(k.split(".")[-2].isdigit() and f"conv{k.split('.')[-2]}" not in ran for k in missing), missing
    return module


def close_to_jax(module, args, ref):
    """module(*args) (numpy inputs) against the JAX module's f32 output
    `ref` within 1e-4 of its largest magnitude plus the JAX output's own
    distance from `module` run in float64, which shares no rounding with
    it; that distance must stay within 1e-3 of the scale. Returns the f32
    output."""
    with torch.no_grad():
        ours = module(*(torch.from_numpy(x) for x in args))
        exact = copy.deepcopy(module).double()(*(torch.from_numpy(x).double() for x in args))
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    scale = np.abs(ref).max()
    ref_err = np.abs(ref - exact.numpy()).max()
    assert 0 < scale and ref_err <= 1e-3 * scale
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4 * scale + ref_err, rtol=0)
    return ours


def _close_scaled(ours, ref, tol=1e-4):
    ours, ref = ours.detach().numpy(), np.asarray(ref)
    assert ours.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(ours, ref, atol=tol * scale, rtol=0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {
        "style": rng.uniform(0, 1, (2, STYLE_HW, STYLE_HW, 3)).astype(np.float32),
        "feats": {d: rng.normal(0.2, 1.0, (2, N_POINTS, d)).astype(np.float32) for d in (8, 64, 256)},
        "style_map": rng.normal(-0.3, 1.5, (2, 8, 8, 8)).astype(np.float32),
    }


def test_adain_pointcloud_and_adain_cs_match_jax(data):
    content, style = data["feats"][8], data["style_map"]
    for fn in ("adain_pointcloud", "adain_cs"):
        ours = getattr(ts, fn)(torch.from_numpy(content), torch.from_numpy(style))
        ref = jax.jit(getattr(js, fn))(jnp.asarray(content), jnp.asarray(style))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5, err_msg=fn)
    np.testing.assert_allclose(ts._instance_norm(torch.from_numpy(content), dim=1).numpy(),
                               np.asarray(js._instance_norm(jnp.asarray(content), axis=1)), rtol=1e-5, atol=1e-5)


def test_linear_stylizer_matches_jax(data):
    content, style = data["feats"][8], data["style_map"]
    ours = ts.linear_stylizer(torch.from_numpy(content), torch.from_numpy(style))
    _close_scaled(ours, jax.jit(js.linear_stylizer)(jnp.asarray(content), jnp.asarray(style)))
    # The whitened and colored features carry the style's covariance.
    flat = style.reshape(2, -1, 8).astype(np.float64)
    out = ours.numpy().astype(np.float64)
    for i in range(2):
        np.testing.assert_allclose(np.cov(out[i].T, bias=True), np.cov(flat[i].T, bias=True), atol=1e-3)


@pytest.mark.parametrize("pool,layer", [("max", None), ("avg", 3)])
def test_normalized_vgg_matches_jax(data, pool, layer):
    """All five slices with max pools, and the third alone with average
    pools; the round trip through convert_normalized_vgg."""
    jmod = js.NormalizedVGG(layer=layer, pool=pool)
    params = flax_params(jmod, jnp.asarray(data["style"]), seed=1)
    port = port_with(ts.NormalizedVGG(layer=layer, pool=pool), params, "normalized_vgg")
    with torch.no_grad():
        ours = port(torch.from_numpy(data["style"]))
    ref = jax.jit(jmod.apply)(params, jnp.asarray(data["style"]))
    if layer is None:
        assert len(ours) == len(ref) == 5
    else:
        ours, ref = [ours], [ref]
    for i, (a, b) in enumerate(zip(ours, ref), start=(layer or 1) - 1):
        assert a.shape[1:] == (STYLE_HW >> i, STYLE_HW >> i, ts.VGG_DIMS[i])
        _close_scaled(a, b)
    back = js.convert_normalized_vgg(port.state_dict())["params"]
    for name, leaf in params["params"].items():
        for k in leaf:
            np.testing.assert_array_equal(back[name][k], leaf[k])


def test_mlp1d_matches_jax(data):
    x = data["feats"][64]
    for act in ("relu", "leaky"):
        jmod = js.MLP1d((32, 48, 16), act=act)
        params = flax_params(jmod, jnp.asarray(x), seed=2)
        port = ts.MLP1d(64, (32, 48, 16), act=act)
        # MLP1d alone: its keys are the Sequential's (0, 2, 4).
        sd = {k.split(".", 1)[1]: v for k, v in from_jax_params({"zipper": params["params"]},
                                                               model="stylizer3d").items()}
        port.load_state_dict(sd)
        with torch.no_grad():
            _close_scaled(port(torch.from_numpy(x)), jax.jit(jmod.apply)(params, jnp.asarray(x)))
        back = js._convert_conv1d_chain({f"m.{k}": v for k, v in port.state_dict().items()}, "m", 3)
        jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params["params"]))


def test_lst_matches_jax(data):
    content = data["feats"][64]
    style = np.random.default_rng(3).normal(0, 1, (2, 8, 8, 64)).astype(np.float32)
    jmod = js.LST(in_dim=64, embed_dim=16)
    params = flax_params(jmod, jnp.asarray(content), jnp.asarray(style), seed=3)
    port = ts.LST(64, embed_dim=16)
    port.load_state_dict(from_jax_params(params, model="lst"))
    with torch.no_grad():
        _close_scaled(port(torch.from_numpy(content), torch.from_numpy(style)),
                      jax.jit(jmod.apply)(params, jnp.asarray(content), jnp.asarray(style)))
    back = js.convert_lst({f"lst.{k}": v for k, v in port.state_dict().items()})
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params["params"]))


STYLIZERS = {
    "linear3d": (lambda: js.Linear3DStylizer(vgg_layer=3), lambda: ts.Linear3DStylizer(vgg_layer=3), 256),
    "adain3d": (lambda: js.AdaIN3DStylizer(vgg_layer=3), lambda: ts.AdaIN3DStylizer(vgg_layer=3, feats_in_dim=64),
                64),
    "adaattn3d": (lambda: js.AdaAttN3DStylizer(feats_in_dim=64, vgg_layer=3),
                  lambda: ts.AdaAttN3DStylizer(feats_in_dim=64, vgg_layer=3), 64),
}


@pytest.mark.parametrize("name", list(STYLIZERS))
def test_stylizer3d_matches_jax(data, name):
    """Each stylizer at vgg_layer 3 (256 channels over the 8x8 style
    positions of a 32x32 style image), 64 points; the round trip through
    the JAX converters of its parts."""
    make_jax, make_port, feats_dim = STYLIZERS[name]
    style, feats = jnp.asarray(data["style"]), data["feats"][feats_dim]
    jmod = make_jax()
    params = flax_params(jmod, style, jnp.asarray(feats), seed=4)
    port = port_with(make_port(), params, "stylizer3d")
    ours = close_to_jax(port, (data["style"], feats), jax.jit(jmod.apply)(params, style, jnp.asarray(feats)))
    assert ours.shape == (2, N_POINTS, 256)
    sd = port.state_dict()
    p = jax.tree.map(np.asarray, params["params"])
    if "lst" in p:
        jax.tree.map(np.testing.assert_array_equal, js.convert_lst(sd), p["lst"])
    for chain in [k for k in p if k.endswith("zipper")]:
        jax.tree.map(np.testing.assert_array_equal, js._convert_conv1d_chain(sd, chain, len(p[chain])), p[chain])
    vgg = js.convert_normalized_vgg({k[len("vgg."):]: v for k, v in sd.items() if k.startswith("vgg.")})["params"]
    jax.tree.map(np.testing.assert_array_equal, {k: vgg[k] for k in p["vgg"]}, p["vgg"])


def test_attention_moments_match_the_materialized_softmax():
    """The fused form (one scaled_dot_product_attention over [se, se^2],
    scale 1) against softmax(qe ke^T) materialized, in float64."""
    g = torch.Generator().manual_seed(5)
    qe, ke, se = (torch.randn(2, n, d, generator=g, dtype=torch.float64) for n, d in ((64, 16), (40, 16), (40, 24)))
    mean, second = ts.attention_moments(qe, ke, se)
    attn = torch.softmax(qe @ ke.transpose(1, 2), dim=-1)
    torch.testing.assert_close(mean, attn @ se, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(second, attn @ (se * se), rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module")
def vgg19():
    x = jnp.zeros((1, STYLE_HW, STYLE_HW, 3))
    jmod = JVGG19()
    params = flax_params(jmod, x, seed=6)
    port = TVGG19()
    port.load_state_dict(from_jax_params(params, model="vgg19"))
    return jmod, params, port


@pytest.mark.parametrize("norm", ["adain", "adaattn"])
def test_adaattn_loss_matches_jax(vgg19, norm):
    """Content layers 3 and 4, style layers 1-3, all three statistics."""
    jmod, params, port = vgg19
    rng = np.random.default_rng(7)
    pred, target = (rng.uniform(0, 1, (1, 2, STYLE_HW, STYLE_HW, 3)).astype(np.float32) for _ in range(2))
    style = rng.uniform(0, 1, (1, STYLE_HW, STYLE_HW, 3)).astype(np.float32)
    kw = dict(style_stats=("mean", "std", "gram"), lam=2.0, norm=norm)
    with torch.no_grad():
        loss, parts = tadaattn.adaattn_loss(port, *(torch.from_numpy(x) for x in (pred, target, style)), **kw)
    ref, ref_parts = jax.jit(lambda *images: jadaattn.adaattn_loss(lambda x: jmod.apply(params, x), *images, **kw))(
        *(jnp.asarray(x) for x in (pred, target, style)))
    for a, b in ((loss, ref), *((parts[k], ref_parts[k]) for k in ref_parts)):
        assert float(b) > 0
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_adaattn_transform_and_gram_match_jax():
    rng = np.random.default_rng(8)
    c, s = rng.normal(0, 1, (2, 6, 5, 16)).astype(np.float32), rng.normal(1, 2, (2, 4, 7, 16)).astype(np.float32)
    ours = tadaattn.adaattn_transform(*(torch.from_numpy(x) for x in (c, s, c, s)))
    _close_scaled(ours, jax.jit(jadaattn.adaattn_transform)(*(jnp.asarray(x) for x in (c, s, c, s))), tol=1e-5)
    _close_scaled(tadaattn.gram_matrix(torch.from_numpy(s)), jadaattn.gram_matrix(jnp.asarray(s)), tol=1e-5)


@pytest.mark.parametrize("with_image", [False, True], ids=["plain", "bilateral"])
def test_depth_smoothness_loss_matches_jax(with_image):
    rng = np.random.default_rng(9)
    depth = rng.uniform(1, 5, (2, 3, 12, 10)).astype(np.float32)
    image = rng.uniform(0, 1, (2, 3, 12, 10, 3)).astype(np.float32) if with_image else None
    kw = dict(weight=0.5, sigma=4.0)
    ours = tdepth.depth_smoothness_loss(torch.from_numpy(depth), None if image is None else torch.from_numpy(image),
                                        **kw)
    ref = jax.jit(lambda *x: jdepth.depth_smoothness_loss(*x, **kw))(
        jnp.asarray(depth), None if image is None else jnp.asarray(image))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
