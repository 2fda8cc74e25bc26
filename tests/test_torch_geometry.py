"""Port parity: styl3r_tpu_torch geometry + Gaussian adapter vs styl3r_tpu.

Inputs are made with numpy from a seed and fed to both packages. Tolerance
1e-5: both sides compute the same f32 expressions, so differences are a
few ulp of values of order 1 (transcendentals and summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.geometry import gaussians as jg
from styl3r_tpu.geometry import projection as jp
from styl3r_tpu.geometry import se3 as jse3
from styl3r_tpu.models import adapter as ja
from styl3r_tpu_torch.geometry import gaussians as tg
from styl3r_tpu_torch.geometry import projection as tp
from styl3r_tpu_torch.geometry import se3 as tse3
from styl3r_tpu_torch.models import adapter as ta

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(torch_out, jax_out, **tol):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out), **(tol or TOL))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[0] = 0.0  # zero quaternion row
    return q


def test_quat_to_rotmat_and_covariance():
    rng = np.random.default_rng(0)
    q = _quats(rng, 64)
    s = np.abs(rng.normal(size=(64, 3))).astype(np.float32)
    _close(tg.quat_to_rotmat(_t(q)), jg.quat_to_rotmat(jnp.asarray(q)))
    for a, b in zip(
        tg.covariance_components(_t(s), _t(q)), jg.covariance_components(jnp.asarray(s), jnp.asarray(q))
    ):
        _close(a, b)
    _close(tg.build_covariance(_t(s), _t(q)), jg.build_covariance(jnp.asarray(s), jnp.asarray(q)))


def test_se3_exp_matches_and_is_identity_at_zero():
    rng = np.random.default_rng(1)
    tau = rng.normal(scale=0.5, size=(2, 5, 6)).astype(np.float32)
    tau[0, 0, 3:] = 1e-7  # small-angle (Taylor) branch
    _close(tse3.se3_exp(_t(tau)), jse3.se3_exp(jnp.asarray(tau)))
    _close(tse3.so3_exp(_t(tau[..., 3:])), jse3.so3_exp(jnp.asarray(tau[..., 3:])))
    _close(tse3.skew(_t(tau[..., :3])), jse3.skew(jnp.asarray(tau[..., :3])))
    # render_gaussians passes zero deltas on every render: exact identity.
    zero = torch.zeros(3, 6)
    assert torch.equal(tse3.se3_exp(zero), torch.eye(4).expand(3, 4, 4))


def test_invert_se3_and_get_fov():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(4, 4)).astype(np.float32)
    rot = np.asarray(jg.quat_to_rotmat(jnp.asarray(q)))
    ext = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    ext[:, :3, :3] = rot
    ext[:, :3, 3] = rng.normal(size=(4, 3))
    _close(tp.invert_se3(_t(ext)), jp.invert_se3(jnp.asarray(ext)))
    k = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    k[:, 0, 0] = rng.uniform(0.5, 1.5, 4)
    k[:, 1, 1] = rng.uniform(0.5, 1.5, 4)
    k[:, :2, 2] = rng.uniform(0.4, 0.6, (4, 2))
    _close(tp.get_fov(_t(k)), jp.get_fov(jnp.asarray(k)))


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_unified_gaussian_adapter(sh_degree):
    rng = np.random.default_rng(3 + sh_degree)
    n = 50
    raw = rng.normal(scale=3.0, size=(2, n, ta.raw_gaussian_channels(sh_degree))).astype(np.float32)
    raw[0, 0, 3:7] = 0.0  # zero quaternion row
    raw[0, 1, 0:3] = 30.0  # softplus above F.softplus's threshold of 20
    means = rng.normal(size=(2, n, 3)).astype(np.float32)
    pdf = rng.uniform(size=(2, n)).astype(np.float32)
    g_t = ta.unified_gaussian_adapter(_t(means), _t(pdf), _t(raw), sh_degree)
    g_j = ja.unified_gaussian_adapter(jnp.asarray(means), jnp.asarray(pdf), jnp.asarray(raw), sh_degree)
    for name in g_j._fields:
        _close(getattr(g_t, name), getattr(g_j, name))
    assert torch.equal(g_t.rotations[0, 0], torch.zeros(4))
    _close(ta.sh_degree_mask(sh_degree), ja.sh_degree_mask(sh_degree))


def test_map_pdf_to_opacity_and_safe_normalize():
    rng = np.random.default_rng(4)
    pdf = rng.uniform(size=(100,)).astype(np.float32)
    for step in (0, 3, 100):
        _close(
            ta.map_pdf_to_opacity(_t(pdf), step, 0.0, 1.0, 10),
            ja.map_pdf_to_opacity(jnp.asarray(pdf), step, 0.0, 1.0, 10),
        )
    x = rng.normal(size=(10, 4)).astype(np.float32)
    x[0] = 0.0
    _close(ta.safe_normalize(_t(x)), ja.safe_normalize(jnp.asarray(x)))
