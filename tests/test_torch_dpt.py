"""Port parity: styl3r_tpu_torch DPT heads vs the flax heads of styl3r_tpu,
at tiny widths (feature 16, last 16, layer dims (8, 8, 16, 16)) on a 2x3
token grid, whose stride-32 level exercises refinenet4's crop.

Flax params are perturbed on every leaf with seeded numpy noise (a
PatchExpand bias keeps its k*k tiles equal, as a ConvTranspose2d bias must)
and carried across with the port's converter. Tolerance 1e-5 in f32: the
convs and resizes sum in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.models import dpt as jd
from styl3r_tpu_torch.models import dpt as td
from styl3r_tpu_torch.utils import convert

TOL = dict(rtol=1e-5, atol=1e-5)
HOOKS = (0, 2, 3, 4)
HOOK_DIMS = (32, 16, 16, 16)
HEAD = dict(feature_dim=16, hooks=HOOKS, layer_dims=(8, 8, 16, 16))
H, W = 32, 48


def perturb(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)

    def go(path, x):
        x = np.asarray(x, np.float32)
        names = [getattr(p, "key", None) for p in path]
        k = 4 if "act_0_up" in names else 2 if "act_1_up" in names else 1
        if k > 1 and names[-1] == "bias":
            noise = np.tile(rng.standard_normal(x.shape[0] // (k * k)), k * k)
        else:
            noise = rng.standard_normal(x.shape)
        return x + scale * noise.astype(np.float32)

    return jax.tree_util.tree_map_with_path(go, params)


def load(module, fill, params):
    sd = {}
    fill(params["params"], sd, "m")
    module.load_state_dict(
        {k[2:]: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}
    )
    return module.eval()


def _tokens(rng, b=2):
    l = (H // 16) * (W // 16)
    return [
        rng.normal(size=(b, l, HOOK_DIMS[0] if i == 0 else HOOK_DIMS[1])).astype(np.float32)
        for i in range(5)
    ]


def test_pts3d_head():
    rng = np.random.default_rng(0)
    tokens = _tokens(rng)
    jm = jd.DPTPts3dHead(last_dim=16, **HEAD)
    jt = [jnp.asarray(t) for t in tokens]
    p = perturb(jm.init(jax.random.key(0), jt, (H, W)), 1)
    tm = load(td.DPTPts3dHead(HOOK_DIMS, last_dim=16, **HEAD), convert._pts3d_head, p)
    with torch.no_grad():
        out = tm([torch.from_numpy(t) for t in tokens], (H, W))
    assert out.shape == (2, H, W, 3) and out.dtype == torch.float32
    ref = np.asarray(jm.apply(p, jt, (H, W)))
    # expm1 of the raw norm spreads the points over three decades (up to
    # ~1e3 here); against a float64 evaluation of the same head both
    # packages are off by ~2.5e-6 of the largest value, so the absolute
    # tolerance scales with it.
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("merger", [True, False], ids=["dpt_gs", "dpt_gs_sh"])
def test_gs_heads(merger):
    rng = np.random.default_rng(2)
    tokens = _tokens(rng)
    jt = [jnp.asarray(t) for t in tokens]
    images = rng.uniform(-1, 1, size=(2, H, W, 3)).astype(np.float32)
    if merger:
        jm = jd.DPTGSHead(out_channels=8, **HEAD)
        args = (jt, jnp.asarray(images), (H, W))
        tm = td.DPTGSHead(HOOK_DIMS, out_channels=8, **HEAD)
        targs = ([torch.from_numpy(t) for t in tokens], torch.from_numpy(images), (H, W))
    else:
        jm = jd.DPTGSSHHead(out_channels=3, **HEAD)
        args = (jt, (H, W))
        tm = td.DPTGSSHHead(HOOK_DIMS, out_channels=3, **HEAD)
        targs = ([torch.from_numpy(t) for t in tokens], (H, W))
    p = perturb(jm.init(jax.random.key(3), *args), 4)
    tm = load(tm, convert._gs_head, p)
    with torch.no_grad():
        out = tm(*targs)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply(p, *args)), **TOL)


def test_reg_dense_pts3d_with_and_without_bound():
    rng = np.random.default_rng(5)
    raw = rng.normal(scale=2.0, size=(4, 7, 3)).astype(np.float32)
    raw[0, 0] = 0.0
    for bound in (None, 5.0):
        np.testing.assert_allclose(
            td.reg_dense_pts3d(torch.from_numpy(raw), bound=bound).numpy(),
            np.asarray(jd.reg_dense_pts3d(jnp.asarray(raw), bound=bound)),
            **TOL,
        )


def test_bf16_trunk_keeps_f32_outputs():
    """head_trunk_dtype: the trunk runs bf16, the last convs and expm1 f32."""
    rng = np.random.default_rng(6)
    tokens = [torch.from_numpy(t) for t in _tokens(rng)]
    head = td.DPTPts3dHead(HOOK_DIMS, last_dim=16, **HEAD).eval()
    with torch.no_grad():
        ref = head(tokens, (H, W))
        head.cast_trunk(torch.bfloat16)
        out = head(tokens, (H, W))
    assert head.dpt.scratch.layer1_rn.weight.dtype == torch.bfloat16
    assert head.dpt.head["2"].weight.dtype == torch.float32
    assert out.dtype == torch.float32
    # bf16 keeps 8 mantissa bits: agreement to a few percent of the scale.
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=0.05 * float(ref.abs().max()))


# -- ops/conv.py::conv3x3, the route of the heads' 3x3 stride-1 convs -------

from styl3r_tpu_torch.ops import conv as tconv  # noqa: E402
from styl3r_tpu_torch.utils import trace  # noqa: E402


def _conv(cin, cout, bias, dtype, seed=0):
    torch.manual_seed(seed)
    return torch.nn.Conv2d(cin, cout, 3, padding=1, bias=bias).to(dtype)


@pytest.mark.parametrize("relu", [False, True], ids=["conv", "conv_relu"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("case", ["cpu_f32", "cpu_bf16", "cpu_tf32_allowed"])
def test_conv3x3_off_the_kernel_is_exactly_the_module(case, bias, relu, monkeypatch):
    """On CPU tensors, in bfloat16 and with cuDNN's TF32 allowed, conv3x3
    is F.conv2d (then F.relu) bit for bit, and launches nothing."""
    dtype = torch.bfloat16 if case == "cpu_bf16" else torch.float32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", case == "cpu_tf32_allowed")
    conv = _conv(6, 5, bias, dtype)
    x = torch.randn(2, 6, 7, 9, generator=torch.Generator().manual_seed(1)).to(dtype)
    before = trace.counters()["conv3x3_f32"]
    assert not tconv.routed(x, conv)
    with torch.no_grad():
        got = tconv.conv3x3(x, conv, relu=relu)
        want = torch.nn.functional.conv2d(x, conv.weight, conv.bias, padding=1)
    if relu:
        want = torch.relu(want)
    assert got.dtype == dtype and torch.equal(got, want)
    assert trace.counters()["conv3x3_f32"] == before


def test_conv3x3_off_the_kernel_keeps_the_modules_gradient():
    conv = _conv(4, 3, True, torch.float32)
    x = torch.randn(1, 4, 5, 6, generator=torch.Generator().manual_seed(2), requires_grad=True)
    g = torch.randn(1, 3, 5, 6, generator=torch.Generator().manual_seed(3))
    got = torch.autograd.grad(tconv.conv3x3(x, conv, relu=True), (x, conv.weight, conv.bias), g)
    want = torch.autograd.grad(torch.relu(conv(x)), (x, conv.weight, conv.bias), g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("shape", [
    (6, 768, 256, 8, 8), (18, 256, 256, 8, 8), (6, 384, 256, 16, 16), (12, 256, 256, 32, 32),
    (6, 256, 256, 64, 64), (18, 256, 256, 256, 256), (1, 128, 128, 256, 256), (8, 128, 128, 256, 256),
    (3, 5, 96, 17, 23),
])
def test_plan_covers_every_chunk_once(shape):
    """A launch's plan on a 132-SM card: the wide tile where its tiles fill
    the SMs one and a half times, else the narrow one; K split only where
    its tiles leave SMs idle, every split non-empty, the splits' chunks
    exactly K's."""
    n, cin, cout, h, w = shape
    tile, splits, per = tconv.plan(n * h * w, cout, cin, 132)
    chunks = -(-cin // tconv.CHUNK_CHANNELS)
    assert (splits - 1) * per < chunks <= splits * per and 1 <= splits <= tconv.MAX_SPLITS
    if 2 * tconv.tiles(n * h * w, cout, tconv.WIDE[0]) >= 3 * 132 * tconv.WIDE[1]:
        assert (tile, splits) == (tconv.WIDE[0], 1)
    else:
        assert tile == tconv.NARROW[0]
    if splits > 1:
        assert per >= tconv.MIN_CHUNKS_PER_SPLIT
        assert tconv.tiles(n * h * w, cout, tile) * splits <= 132 * tconv.NARROW[1]
    if shape == (6, 768, 256, 8, 8):
        assert splits > 1  # layer4_rn at b = 6: 6 tiles alone would leave 126 SMs idle
    if shape in ((1, 128, 128, 256, 256), (18, 256, 256, 256, 256)):
        assert (tile, splits) == (256, 1)


@pytest.mark.parametrize("head", ["pts3d", "gs", "gs_merger"])
def test_heads_route_every_3x3_conv_and_keep_their_keys(head, monkeypatch):
    """Every stride-1 3x3 conv of a head goes through conv3x3 (20 a pts3d
    head, 19 a gs head), and the heads' state-dict keys are the converter's
    (the flax loader is untouched)."""
    rng = np.random.default_rng(7)
    tokens = [torch.from_numpy(t) for t in _tokens(rng)]
    jt = [jnp.asarray(t.numpy()) for t in tokens]
    if head == "pts3d":
        jm, tm, fill = jd.DPTPts3dHead(last_dim=16, **HEAD), td.DPTPts3dHead(HOOK_DIMS, last_dim=16, **HEAD), \
            convert._pts3d_head
        args, jargs, want = (tokens, (H, W)), (jt, (H, W)), 20
    else:
        merger = head == "gs_merger"
        cls = td.DPTGSHead if merger else td.DPTGSSHHead
        jm = (jd.DPTGSHead if merger else jd.DPTGSSHHead)(out_channels=7, **HEAD)
        tm, fill = cls(HOOK_DIMS, 7, **HEAD), convert._gs_head
        imgs = torch.from_numpy(rng.normal(size=(2, H, W, 3)).astype(np.float32))
        args = (tokens, imgs, (H, W)) if merger else (tokens, (H, W))
        jargs = (jt, jnp.asarray(imgs.numpy()), (H, W)) if merger else (jt, (H, W))
        want = 19
    sd = {}
    fill(jm.init(jax.random.key(0), *jargs)["params"], sd, "m")
    assert sorted(k[2:] for k in sd) == sorted(tm.state_dict())
    calls = []
    route = tconv.conv3x3

    def counted(x, conv, relu=False):
        calls.append((conv.kernel_size, conv.stride, relu))
        return route(x, conv, relu)

    monkeypatch.setattr(td, "conv3x3", counted)
    with torch.no_grad():
        tm.eval()(*args)
    assert len(calls) == want and {c[:2] for c in calls} == {((3, 3), (1, 1))}
    # The ReLUs that follow a conv are fused into it: the 7 units' conv1 and
    # the tower's last 3x3.
    assert sum(c[2] for c in calls) == 8
