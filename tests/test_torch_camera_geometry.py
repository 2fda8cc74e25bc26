"""The camera embedding and the epipolar-line geometry:
styl3r_tpu_torch.geometry.{camera_emb,epipolar_lines} against
styl3r_tpu.geometry's on the same numpy inputs.

Tolerances: 1e-5 (relative and absolute), f32 on both sides;
`overlaps_image` exactly, on rays that cross the image, miss it and start
behind the camera, and the segment's values where it is true. lift_to_3d
and get_depth solve a 3x3 least-squares system per point, whose f32
solution each side gets only to ~1e-7 times the system's condition number
(near-parallel rays reach 1e3-1e4; the JAX package's own error against a
float64 solve is of that size): 1e-5 times that condition number.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.geometry import camera_emb as jemb
from styl3r_tpu.geometry import epipolar_lines as jepi
from styl3r_tpu_torch.geometry import camera_emb as temb
from styl3r_tpu_torch.geometry import epipolar_lines as tepi
from styl3r_tpu_torch.geometry.projection import get_world_rays

TOL = 1e-5
# One trace a shape: XLA compiles the whole function once, where eager JAX
# compiles each of its few hundred operations.
J_PROJECT_RAYS = jax.jit(jepi.project_rays)


def _close(ours, ref, where=None):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape
    if where is not None:
        ours, ref = ours[where], ref[where]
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def _unit(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("degree", range(9))
def test_rsh_cart_matches_jax(degree):
    dirs = _unit(np.random.default_rng(degree), 50)
    ours = temb.rsh_cart(torch.from_numpy(dirs), degree)
    assert ours.shape == (50, (degree + 1) ** 2)
    _close(ours, jax.jit(jemb.rsh_cart, static_argnums=1)(jnp.asarray(dirs), degree))


@pytest.mark.parametrize("degree", [0, 4, 8])
def test_intrinsic_embedding_matches_jax(degree):
    k = np.asarray([[[0.9, 0, 0.5], [0, 1.1, 0.45], [0, 0, 1]], [[1.2, 0, 0.55], [0, 1.0, 0.5], [0, 0, 1]]],
                   np.float32)
    ours = temb.get_intrinsic_embedding(torch.from_numpy(k), (6, 10), degree)
    assert ours.shape == (2, 6, 10, 3 if degree == 0 else (degree + 1) ** 2)
    _close(ours, jax.jit(jemb.get_intrinsic_embedding, static_argnums=(1, 2))(jnp.asarray(k), (6, 10), degree))


def _pose(angle, axis, t):
    c, s = np.cos(angle), np.sin(angle)
    rot = {"y": [[c, 0, s], [0, 1, 0], [-s, 0, c]], "x": [[1, 0, 0], [0, c, -s], [0, s, c]]}[axis]
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = rot
    ext[:3, 3] = t
    return ext


@pytest.fixture(scope="module")
def rays():
    """World rays seen by a second camera (c2w `ext`, normalized `k`), 4 x
    96: from the first camera's center (the stereo case), from points in
    front of the second camera, from points behind it (camera-space z < 0),
    and from its center exactly. Directions are random, so some segments
    cross the image and others miss it."""
    rng = np.random.default_rng(0)
    ext = _pose(0.2, "y", [0.4, -0.1, 0.05]) @ _pose(-0.1, "x", [0, 0, 0])
    k = np.asarray([[0.9, 0, 0.5], [0, 1.05, 0.48], [0, 0, 1]], np.float32)
    n = 96
    cam = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(0.5, 3, n), np.ones(n)], -1)
    behind = cam * np.asarray([1, 1, -1, 1])
    to_world = lambda p: (p @ ext.T)[:, :3]  # noqa: E731
    origins = np.concatenate([np.zeros((n, 3)), to_world(cam), to_world(behind), np.tile(ext[:3, 3], (n, 1))])
    directions = _unit(rng, 4 * n)
    # Half the rays aim near the second camera's view: rays that cross it.
    directions[::2] = (ext[:3, :3] @ _unit(rng, 2 * n).T).T * 0.3 + ext[:3, 2] * np.asarray(1.0)
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    return origins.astype(np.float32), directions.astype(np.float32), ext, k


@pytest.mark.parametrize("planes", ["none", "near_far"])
def test_project_rays_matches_jax(rays, planes):
    """Without planes on one batch axis; with a near and a far plane on a
    (4, 96) batch of rays whose cameras broadcast from (4, 1)."""
    origins, directions, ext, k = rays
    kw = {}
    if planes == "near_far":
        origins, directions = origins.reshape(4, 96, 3), directions.reshape(4, 96, 3)
        ext, k = np.tile(ext, (4, 1, 1, 1)), np.tile(k, (4, 1, 1, 1))
        kw = {"near": np.float32(0.3), "far": np.full((4, 96), 4.0, np.float32)}
    ours = tepi.project_rays(*(torch.from_numpy(np.asarray(x)) for x in (origins, directions, ext, k)),
                             **{key: torch.tensor(v) for key, v in kw.items()})
    ref = J_PROJECT_RAYS(*(jnp.asarray(x) for x in (origins, directions, ext, k)),
                            **{key: jnp.asarray(v) for key, v in kw.items()})
    overlaps = np.asarray(ref.overlaps_image)
    np.testing.assert_array_equal(ours.overlaps_image.numpy(), overlaps)
    # Every kind of ray occurs: segments that overlap the image and ones
    # that do not, among the rays from behind the camera too.
    assert 0 < overlaps.sum() < overlaps.size
    assert 0 < overlaps.reshape(4, 96)[2].sum() < 96
    for name in ("t_min", "t_max", "xy_min", "xy_max"):
        _close(getattr(ours, name), getattr(ref, name), where=overlaps)


def test_lift_to_3d_and_depth_match_jax(rays):
    origins, directions, ext, k = rays
    ref_seg = J_PROJECT_RAYS(*(jnp.asarray(x) for x in (origins, directions, ext, k)))
    keep = np.asarray(ref_seg.overlaps_image)
    xy = (0.5 * (np.asarray(ref_seg.xy_min) + np.asarray(ref_seg.xy_max)))[keep]
    args = (origins[keep], directions[keep], xy, ext, k)
    # Each point's least-squares system, sum over both rays of d d^T - I.
    _, xy_dirs = get_world_rays(*(torch.from_numpy(np.asarray(x, np.float64)) for x in (xy, ext, k)))
    eye = np.eye(3)
    lhs = sum(np.einsum("ni,nj->nij", d, d) - eye for d in (directions[keep].astype(np.float64), xy_dirs.numpy()))
    cond = np.linalg.cond(lhs)
    assert cond.max() > 100  # near-parallel pairs are among them
    for fn in ("lift_to_3d", "get_depth"):
        ours = getattr(tepi, fn)(*(torch.from_numpy(np.asarray(x)) for x in args)).numpy()
        ref = np.asarray(jax.jit(getattr(jepi, fn))(*(jnp.asarray(x) for x in args)))
        assert ours.shape == ref.shape
        err = np.abs(ours - ref).reshape(len(cond), -1).max(-1)
        scale = np.maximum(1.0, np.abs(ref).reshape(len(cond), -1).max(-1))
        assert (err <= TOL * cond * scale).all(), fn


def test_project_camera_space_matches_jax():
    rng = np.random.default_rng(3)
    points = rng.uniform(-2, 2, (2, 20, 3)).astype(np.float32)
    points[0, :3, 2] = 0.0  # the perspective divide's clamp to +-1e8
    k = np.asarray([[0.9, 0, 0.5], [0, 1.05, 0.48], [0, 0, 1]], np.float32)
    _close(tepi.project_camera_space(torch.from_numpy(points), torch.from_numpy(k)),
           jepi.project_camera_space(jnp.asarray(points), jnp.asarray(k)))
