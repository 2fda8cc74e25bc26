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
