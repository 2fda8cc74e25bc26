"""Port parity for the posed Gaussian adapter and its geometry helpers:
styl3r_tpu_torch.models.adapter.{get_scale_multiplier,
posed_gaussian_adapter} and geometry/gaussians.py's quat_mul_xyzw,
rotmat_to_quat_xyzw, covariance_to_upper_triangle and
upper_triangle_to_covariance against styl3r_tpu's on the same seeded numpy
arrays, on one torch thread.

  * The helpers: 1e-6 absolute in f32, sign included, on random rotations,
    a rotation in each of rotmat_to_quat_xyzw's four branches, 90° rotations
    about x, y and z (from integers two seeds tie, and the first wins on
    both sides; from f32 cos/sin they tie or not by the rounding of each
    seed's sum in its order) and 180° ones.
  * The adapter: each output within 1e-5 of its largest magnitude (f32
    elementwise math and a 2x2 inverse, rounded in other orders), at
    sh_degree 0 and 3, with one shared camera and one camera a Gaussian.
  * The JAX tests' properties (tests/test_encoder.py): a finite gradient at
    an exactly-zero quaternion row, means that reproject to their
    coordinates within 1e-4, positive definite covariances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.geometry import gaussians as jg
from styl3r_tpu.models import adapter as ja
from styl3r_tpu_torch.geometry import gaussians as tg
from styl3r_tpu_torch.geometry.projection import project
from styl3r_tpu_torch.models import adapter as ta

HELPER_TOL = 1e-6
ADAPTER_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _random_rotations(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def _axis_rotation(axis, angle):
    c, s = np.cos(np.float32(angle)), np.sin(np.float32(angle))
    i, j = [k for k in range(3) if k != axis]
    rot = np.eye(3, dtype=np.float32)
    rot[i, i], rot[i, j], rot[j, i], rot[j, j] = c, -s, s, c
    return rot


def _branch_rotations(rng):
    """Rotations that reach each branch of rotmat_to_quat_xyzw, and its
    ties: (name, (k, 3, 3) f32)."""
    exact_90 = np.stack([
        np.asarray([[1, 0, 0], [0, 0, -1], [0, 1, 0]]),
        np.asarray([[0, 0, 1], [0, 1, 0], [-1, 0, 0]]),
        np.asarray([[0, -1, 0], [1, 0, 0], [0, 0, 1]]),
    ]).astype(np.float32)
    near = lambda axis, angle: np.stack([_axis_rotation(axis, angle + d) for d in (-0.2, 0.0, 0.2)])  # noqa: E731
    return [
        ("random", _random_rotations(rng, 32)),
        ("w", near(0, 0.3)), ("x", near(0, np.pi)), ("y", near(1, np.pi)), ("z", near(2, np.pi)),
        ("90_exact", exact_90),
        ("90_f32", np.stack([_axis_rotation(a, np.pi / 2) for a in range(3)])),
        ("180", np.stack([np.diag(d).astype(np.float32) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])])),
    ]


def _seeds(rot):
    """rotmat_to_quat_xyzw's seeds [tx, ty, tz, tw], summed as both sides sum them."""
    m = [[rot[..., i, j] for j in range(3)] for i in range(3)]
    one = np.float32(1.0)
    return np.stack([one + m[0][0] - m[1][1] - m[2][2], one - m[0][0] + m[1][1] - m[2][2],
                     one - m[0][0] - m[1][1] + m[2][2], one + m[0][0] + m[1][1] + m[2][2]], -1)


def test_rotmat_to_quat_matches_jax_in_every_branch():
    groups = _branch_rotations(np.random.default_rng(0))
    # One JAX call on all the groups: one trace.
    refs = np.split(np.asarray(jax.jit(jg.rotmat_to_quat_xyzw)(jnp.asarray(np.concatenate([r for _, r in groups])))),
                    np.cumsum([len(r) for _, r in groups])[:-1])
    reached = set()
    for (name, rot), ref in zip(groups, refs):
        ours = tg.rotmat_to_quat_xyzw(_t(rot)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=HELPER_TOL, err_msg=name)
        seeds = _seeds(rot)
        reached |= set(np.argmax(seeds, -1).tolist())
        if name == "90_exact":
            # Two seeds tie at 2; the first (x, y or z, before w) wins. From
            # f32 cos/sin they tie or not by the rounding of each sum in its
            # order (tz > tw about z), which both sides share.
            top = np.sort(seeds, -1)
            assert (top[:, -1] == top[:, -2]).all() and (np.argmax(seeds, -1) == [0, 1, 2]).all(), name
        # The quaternion rotates as the matrix does.
        np.testing.assert_allclose(tg.quat_to_rotmat(_t(ours)).numpy(), rot, atol=1e-5, err_msg=name)
    assert reached == {0, 1, 2, 3}


def test_quaternion_and_covariance_helpers_match_jax():
    rng = np.random.default_rng(1)
    q1, q2 = (rng.normal(size=(16, 4)).astype(np.float32) for _ in range(2))
    a = rng.normal(size=(2, 8, 3, 3)).astype(np.float32)
    cov = a @ np.swapaxes(a, -1, -2)

    @jax.jit
    def reference(q1, q2, cov):
        tri = jg.covariance_to_upper_triangle(cov)
        return jg.quat_mul_xyzw(q1, q2), tri, jg.upper_triangle_to_covariance(tri)

    ref_q, ref_tri, ref_back = (np.asarray(x) for x in reference(q1, q2, cov))
    ours = tg.quat_mul_xyzw(_t(q1), _t(q2)).numpy()
    np.testing.assert_allclose(ours, ref_q, rtol=0, atol=HELPER_TOL)
    # Composition: R(q1 ⊗ q2) = R(q1) R(q2).
    np.testing.assert_allclose(tg.quat_to_rotmat(_t(ours)).numpy(),
                               tg.quat_to_rotmat(_t(q1)).numpy() @ tg.quat_to_rotmat(_t(q2)).numpy(), atol=1e-5)

    tri = tg.covariance_to_upper_triangle(_t(cov))
    np.testing.assert_array_equal(tri.numpy(), ref_tri)
    back = tg.upper_triangle_to_covariance(tri).numpy()
    np.testing.assert_array_equal(back, ref_back)
    np.testing.assert_array_equal(back, cov)


def _cameras(rng, n):
    """n c2w cameras, the first three turned 90° about x, y and z (ties in
    rotmat_to_quat_xyzw), and their normalized intrinsics."""
    ext = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ext[:, :3, :3] = _random_rotations(rng, n)
    ext[:3, :3, :3] = np.stack([_axis_rotation(a, np.pi / 2) for a in range(3)])
    ext[:, :3, 3] = rng.normal(scale=0.5, size=(n, 3))
    k = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    k[:, 0, 0], k[:, 1, 1] = rng.uniform(0.7, 1.3, n), rng.uniform(0.7, 1.3, n)
    k[:, 0, 1] = rng.uniform(-0.05, 0.05, n)
    k[:, :2, 2] = rng.uniform(0.4, 0.6, (n, 2))
    return ext, k


def _adapter_inputs(seed, sh_degree, n=48, per_gaussian=True):
    rng = np.random.default_rng(seed)
    ext, k = _cameras(rng, n)
    if not per_gaussian:
        ext, k = ext[5], k[5]
    return dict(
        extrinsics=ext, intrinsics=k,
        coordinates=rng.uniform(0.05, 0.95, (n, 2)).astype(np.float32),
        depths=rng.uniform(0.5, 6.0, n).astype(np.float32),
        opacities=rng.uniform(0, 1, n).astype(np.float32),
        raw=rng.normal(scale=1.5, size=(n, ta.raw_gaussian_channels(sh_degree))).astype(np.float32),
    )


ADAPTER_CASES = [(sh, per_gaussian) for sh in (0, 3) for per_gaussian in (False, True)]
SHAPE = (48, 64)


@pytest.fixture(scope="module")
def jax_adapter_outputs():
    """JAX's posed adapter and scale multiplier on every case's inputs, in
    one traced call."""
    cases = [_adapter_inputs(2 + sh, sh, per_gaussian=pg) for sh, pg in ADAPTER_CASES]
    pixel_size = np.asarray([1 / SHAPE[1], 1 / SHAPE[0]], np.float32)

    @jax.jit
    def reference(cases):
        return [(ja.posed_gaussian_adapter(**c, image_shape=SHAPE, sh_degree=sh),
                 ja.get_scale_multiplier(c["intrinsics"], pixel_size)) for c, (sh, _) in zip(cases, ADAPTER_CASES)]

    return dict(zip(ADAPTER_CASES, ((c, *r) for c, r in zip(cases, reference(cases)))))


@pytest.mark.parametrize("sh_degree", [0, 3])
@pytest.mark.parametrize("per_gaussian", [False, True], ids=["shared_camera", "camera_per_gaussian"])
def test_posed_adapter_matches_jax(jax_adapter_outputs, sh_degree, per_gaussian):
    inputs, ref, ref_mult = jax_adapter_outputs[(sh_degree, per_gaussian)]
    ours = ta.posed_gaussian_adapter(**{k: _t(v) for k, v in inputs.items()}, image_shape=SHAPE, sh_degree=sh_degree)
    for name in ("means", "covariances", "harmonics", "opacities", "scales", "rotations"):
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        scale = float(np.abs(b).max())
        assert np.abs(a - b).max() <= ADAPTER_TOL * scale, (name, float(np.abs(a - b).max()), scale)
    mult = ta.get_scale_multiplier(_t(inputs["intrinsics"]), _t([1 / SHAPE[1], 1 / SHAPE[0]])).numpy()
    np.testing.assert_allclose(mult, np.asarray(ref_mult), rtol=ADAPTER_TOL)


def test_posed_adapter_gradient_is_finite_at_a_zero_quaternion():
    """An exactly-zero raw quaternion row (a dead-ReLU pixel) leaves every
    gradient finite (tests/test_encoder.py's regression)."""
    raw = _t(np.random.default_rng(0).normal(size=(4, ta.raw_gaussian_channels(0))))
    raw[1, 3:7] = 0.0
    raw.requires_grad_()
    k = _t([[0.8, 0.0, 0.5], [0.0, 0.8, 0.5], [0.0, 0.0, 1.0]])
    g = ta.posed_gaussian_adapter(torch.eye(4).expand(4, 4, 4), k.expand(4, 3, 3), torch.full((4, 2), 0.5),
                                  torch.ones(4), torch.full((4,), 0.7), raw, (8, 8), sh_degree=0)
    loss = sum((x**2).sum() for x in (g.covariances, g.rotations, g.scales, g.means))
    (grad,) = torch.autograd.grad(loss, raw)
    assert bool(torch.isfinite(grad).all())


def test_posed_means_reproject_and_covariances_are_positive_definite():
    inputs = _adapter_inputs(5, 0, n=64, per_gaussian=False)
    t = {k: _t(v) for k, v in inputs.items()}
    g = ta.posed_gaussian_adapter(**t, image_shape=(64, 64), sh_degree=0)
    xy, front = project(g.means, t["extrinsics"], t["intrinsics"])
    assert bool(front.all())
    np.testing.assert_allclose(xy.numpy(), inputs["coordinates"], atol=1e-4)
    assert float(g.scales.min()) > 0
    assert np.linalg.eigvalsh(g.covariances.double().numpy()).min() > 0
    # Rotations and covariances are both world-frame: R S² Rᵀ rebuilds them.
    np.testing.assert_allclose(tg.build_covariance(g.scales, g.rotations).numpy(), g.covariances.numpy(), atol=1e-9)
