"""Port parity for the geometry and data that evaluation uses:
styl3r_tpu_torch.geometry.projection, losses.ssim.ms_ssim,
eval.index_generator and data.scannet_pose against styl3r_tpu's, on the same
numpy inputs.

Tolerances, each with its reason:
  * projection functions: 1e-6 absolute on values of order 1 (the same f32
    expressions; a matmul sums in another order), and 1e-6 relative for
    projections, which grow as points near the image plane.
  * intersect_rays: 1e-5 absolute on points about 3 from the origin. Each
    is a 3x3 f32 solve whose condition grows as the two rays close in (~5
    for rays 40 degrees apart, ~1e2 at 7 degrees), and LAPACK's and XLA's
    solvers pivot and sum differently; the port is held to the f64 solution
    within the same bound.
  * ms_ssim: 1e-5 relative (f32 convolutions summed in another order, and a
    product of five powers).
  * view_overlap: 1e-6 (a mean of booleans, equal unless a probe point lies
    on an image edge, where the two packages' rounding could put it on
    either side; the test keeps pairs with no probe within 1e-6 of an edge).
  * the evaluation index: the same JSON (the same numpy draws and the same
    overlaps).
  * ScanNet examples: images, intrinsics and extrinsics within 1e-6 (the
    same numpy and PIL code on the same files).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from styl3r_tpu.data import scannet_pose as jscannet
from styl3r_tpu.eval import index_generator as jindex
from styl3r_tpu.geometry import projection as jproj
from styl3r_tpu.geometry.se3 import se3_exp as jse3_exp
from styl3r_tpu.losses.ssim import ms_ssim as j_ms_ssim
from styl3r_tpu_torch.data import scannet_pose as tscannet
from styl3r_tpu_torch.eval import index_generator as tindex
from styl3r_tpu_torch.geometry import projection as tproj
from styl3r_tpu_torch.losses.ssim import ms_ssim as t_ms_ssim


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(ours, ref, rtol=0.0, atol=1e-6):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _poses(rng, n, rot=0.4, trans=0.5):
    tau = np.concatenate([rng.normal(0, trans, (n, 3)), rng.normal(0, rot, (n, 3))], -1)
    return np.asarray(jse3_exp(jnp.asarray(tau, jnp.float32)))


def _intrinsics(rng, n):
    k = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    k[:, 0, 0], k[:, 1, 1] = rng.uniform(0.7, 1.3, n), rng.uniform(0.7, 1.3, n)
    k[:, 0, 2], k[:, 1, 2] = rng.uniform(0.4, 0.6, n), rng.uniform(0.4, 0.6, n)
    return k


def test_projection_functions_match_jax():
    rng = np.random.default_rng(0)
    n = 5
    ext, k = _poses(rng, n), _intrinsics(rng, n)
    pts = rng.normal(0, 2, (n, 40, 3)).astype(np.float32)
    vec = rng.normal(0, 1, (n, 40, 3)).astype(np.float32)
    _close(tproj.homogenize_points(_t(pts)), jproj.homogenize_points(jnp.asarray(pts)))
    _close(tproj.homogenize_vectors(_t(vec)), jproj.homogenize_vectors(jnp.asarray(vec)))
    hp = tproj.homogenize_points(_t(pts))
    _close(tproj.transform_rigid(hp, _t(ext)[:, None]),
           jproj.transform_rigid(jnp.asarray(hp.numpy()), jnp.asarray(ext)[:, None]), atol=1e-5)
    _close(tproj.invert_se3(_t(ext)), jproj.invert_se3(jnp.asarray(ext)))

    # Points given in each camera's frame, in front (z in [0.5, 4]) and
    # behind it, then taken to the world.
    cam = rng.uniform(-2, 2, (n, 40, 3))
    cam[..., 2] = rng.uniform(0.5, 4, (n, 40)) * np.where(np.arange(40) % 4 == 0, -1, 1)
    world = (np.einsum("nij,npj->npi", ext[:, :3, :3].astype(np.float64), cam) + ext[:, None, :3, 3]).astype(np.float32)
    xy, front = tproj.project(_t(world), _t(ext)[:, None], _t(k)[:, None])
    jxy, jfront = jproj.project(jnp.asarray(world), jnp.asarray(ext)[:, None], jnp.asarray(k)[:, None])
    np.testing.assert_array_equal(front.numpy(), np.asarray(jfront))
    _close(xy, jxy, rtol=1e-6)
    # On the image plane of the identity camera: the epsilon, and the
    # +-1e8 clamp where z = -epsilon makes the division infinite.
    plane = np.asarray([[1.0, 2.0, 0.0], [0.0, 0.0, 0.0], [1.0, -1.0, -1.1920929e-07]], np.float32)
    xy, front = tproj.project(_t(plane), torch.eye(4), _t(k[0]))
    jxy, jfront = jproj.project(jnp.asarray(plane), jnp.eye(4), jnp.asarray(k[0]))
    np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(front.numpy(), np.asarray(jfront))
    assert float(xy.abs().max()) >= 1e8

    coords, idx = tproj.sample_image_grid((6, 9))
    jcoords, jidx = jproj.sample_image_grid((6, 9))
    assert coords.shape == (6, 9, 2) and idx.shape == (6, 9, 2)
    _close(coords, jcoords)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))

    z = rng.uniform(0.5, 3, (n, 6, 9)).astype(np.float32)
    cb = coords.expand(n, 6, 9, 2)
    _close(tproj.unproject(cb, _t(z), _t(k)[:, None, None]),
           jproj.unproject(jnp.asarray(cb.numpy()), jnp.asarray(z), jnp.asarray(k)[:, None, None]), rtol=1e-6)
    origins, dirs = tproj.get_world_rays(cb, _t(ext)[:, None, None], _t(k)[:, None, None])
    jorigins, jdirs = jproj.get_world_rays(jnp.asarray(cb.numpy()), jnp.asarray(ext)[:, None, None],
                                           jnp.asarray(k)[:, None, None])
    _close(origins, jorigins)
    _close(dirs, jdirs)
    _close(tproj.get_local_rays_basis(cb, _t(k)[:, None, None]),
           jproj.get_local_rays_basis(jnp.asarray(cb.numpy()), jnp.asarray(k)[:, None, None]))
    _close(tproj.get_fov(_t(k)), jproj.get_fov(jnp.asarray(k)))

    # Two bundles of rays from origins 4 apart through common points about 3
    # away (40-100 degrees between the rays of a pair), and one pair of
    # parallel rays, which gives `inf`.
    target = rng.uniform(-1, 1, (n, 30, 3)) + np.asarray([0, 0, 3.0])
    o1 = rng.uniform(-0.5, 0.5, (n, 1, 3)) + np.asarray([-2.0, 0, 0])
    o2 = rng.uniform(-0.5, 0.5, (n, 1, 3)) + np.asarray([2.0, 0, 0])
    d1, d2 = ((target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True) for o in (o1, o2))
    d2[0, 0] = d1[0, 0]
    args = [np.broadcast_to(x, target.shape).astype(np.float32) for x in (o1, d1, o2, d2)]
    hit = tproj.intersect_rays(*map(_t, args))
    jhit = jproj.intersect_rays(*map(jnp.asarray, args))
    assert float(hit[0, 0, 0]) == 1e10
    _close(hit, jhit, atol=1e-5)
    exact = tproj.intersect_rays(*(torch.from_numpy(x.astype(np.float64)) for x in args)).numpy()
    np.testing.assert_allclose(hit.numpy()[:, 1:], exact[:, 1:], atol=1e-5)


@pytest.mark.parametrize("shape, negated", [((2, 176, 176, 3), False), ((1, 171, 165, 3), False),
                                            ((1, 176, 176, 3), True)], ids=["batched", "odd_sizes", "negated"])
def test_ms_ssim_matches_jax(shape, negated):
    """Per image and averaged; an (h, w, 3) pair as one image. Against its
    negative an image has negative contrast terms, which the relu zeroes."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = 1 - a if negated else np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    ref = np.asarray(j_ms_ssim(jnp.asarray(a), jnp.asarray(b), size_average=False))
    ours = t_ms_ssim(_t(a), _t(b), size_average=False).numpy()
    assert ours.shape == ref.shape == (shape[0],)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    np.testing.assert_allclose(float(t_ms_ssim(_t(a), _t(b))), ref.mean(), rtol=1e-5)
    np.testing.assert_allclose(float(t_ms_ssim(_t(a[0]), _t(b[0]))), ref[0], rtol=1e-5)
    assert (ref.max() == 0) if negated else (0 < ref.min() < 1)
    assert float(t_ms_ssim(_t(a), _t(a))) == pytest.approx(1.0, abs=1e-5)


def test_ms_ssim_rejects_images_too_small():
    x = np.zeros((1, 160, 200, 3), np.float32)
    with pytest.raises(ValueError, match="too small"):
        t_ms_ssim(_t(x), _t(x))
    with pytest.raises(ValueError, match="too small"):
        j_ms_ssim(jnp.asarray(x), jnp.asarray(x))


def _probe_edge_distance(ext_a, ext_b, k_a, k_b):
    """The smallest distance of view_overlap's probe points (projected into
    view B, in f64) to the edges 0 and 1."""
    ext_a, ext_b, k_a, k_b = (torch.tensor(np.asarray(x), dtype=torch.float64) for x in (ext_a, ext_b, k_a, k_b))
    coords, _ = tproj.sample_image_grid((8, 8))
    origins, dirs = tproj.get_world_rays(coords.double(), ext_a, k_a)
    worst = np.inf
    for d in (0.5, 1.0, 2.0, 4.0):
        xy, _ = tproj.project(origins + dirs * d, ext_b, k_b)
        worst = min(worst, float(torch.minimum(xy.abs(), (xy - 1).abs()).min()))
    return worst


def test_view_overlap_matches_jax():
    rng = np.random.default_rng(2)
    kept = 0
    for i in range(40):
        ext = _poses(rng, 2, rot=0.3 * (i % 4), trans=0.6)
        k = _intrinsics(rng, 2)
        if _probe_edge_distance(ext[0], ext[1], k[0], k[1]) <= 1e-6:
            continue
        ours = tindex.view_overlap(ext[0], ext[1], k[0], k[1])
        ref = jindex.view_overlap(ext[0], ext[1], k[0], k[1])
        assert abs(ours - ref) <= 1e-6, (i, ours, ref)
        kept += 1
    assert kept >= 36


def _trajectory(rng, n):
    """A camera walking along x and turning slowly about y, with jitter."""
    t = np.arange(n)
    tau = np.zeros((n, 6), np.float32)
    tau[:, 0] = 0.015 * t + rng.normal(0, 0.003, n)
    tau[:, 2] = rng.normal(0, 0.003, n)
    tau[:, 4] = 0.004 * t + rng.normal(0, 0.002, n)
    return np.asarray(jse3_exp(jnp.asarray(tau))), _intrinsics(rng, 1).repeat(n, 0)


def test_evaluation_index_matches_jax(tmp_path):
    """Three trajectories (one too short for the band), the default band
    and a narrow one: the same index, written as the same JSON."""
    rng = np.random.default_rng(3)
    scenes = {}
    for key, n in (("walk_a", 160), ("walk_b", 200), ("short", 30)):
        ext, k = _trajectory(rng, n)
        scenes[key] = {"extrinsics": ext, "intrinsics": k}
    for kwargs in ({}, dict(min_overlap=0.4, max_overlap=0.5, num_targets=2)):
        ours = tindex.generate_evaluation_index(scenes, tmp_path / "port.json", seed=5, **kwargs)
        ref = jindex.generate_evaluation_index(scenes, tmp_path / "jax.json", seed=5, **kwargs)
        assert ours == ref
        assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
        assert any(v is not None for v in ours.values())
    assert json.loads((tmp_path / "port.json").read_text())["short"] is None


def _scannet_root(tmp_path, rng):
    """Two ScanNet scenes in the reference layout: test.npz pairs, JPEG
    frames and intrinsic_color.txt (principal points left/above and
    right/below the image center); the third pair names a frame that is
    not there."""
    h, w = 120, 160
    for scene, cx, cy, frames in (("0707", 70.0, 68.0, (10, 40)), ("0708", 88.0, 52.0, (5,))):
        d = tmp_path / "scans_test" / f"scene{scene}_00"
        (d / "color").mkdir(parents=True)
        (d / "intrinsic").mkdir(parents=True)
        for fid in frames:
            arr = (rng.uniform(0, 1, (h, w, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / "color" / f"{fid}.jpg")
        k = np.asarray([[140.0, 0, cx, 0], [0, 142.0, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
        (d / "intrinsic" / "intrinsic_color.txt").write_text("\n".join(" ".join(str(x) for x in row) for row in k))
    rel = np.stack([np.asarray(jse3_exp(jnp.asarray(rng.normal(0, 0.2, 6), jnp.float32)))[:3].reshape(-1)
                    for _ in range(3)])
    np.savez(tmp_path / "test.npz", name=np.asarray([[707, 0, 10, 40], [708, 0, 5, 6], [708, 0, 5, 5]]), rel_pose=rel)
    return tmp_path


def test_scannet_pose_dataset_matches_jax(tmp_path):
    root = _scannet_root(tmp_path, np.random.default_rng(4))
    ours = list(tscannet.ScannetPoseDataset(root, input_image_shape=(64, 80)))
    ref = list(jscannet.ScannetPoseDataset(root, input_image_shape=(64, 80)))
    assert len(tscannet.ScannetPoseDataset(root)) == 3
    assert [e.scene for e in ours] == [e.scene for e in ref] == ["scene0707_00", "scene0708_00"]
    for a, b in zip(ours, ref):
        assert a.context.image.shape == (2, 64, 80, 3)
        for name in ("image", "intrinsics", "extrinsics"):
            np.testing.assert_allclose(getattr(a.context, name), getattr(b.context, name), atol=1e-6, err_msg=name)
        for name in ("near", "far", "index", "overlap"):
            np.testing.assert_array_equal(getattr(a.context, name), getattr(b.context, name))
        np.testing.assert_allclose(a.style_image, b.style_image, atol=1e-6)
        assert a.target is a.context
    for cx, cy in ((3.0, 7.0), (8.0, 5.0), (6.0, 5.0)):
        imgs = np.random.default_rng(5).uniform(0, 1, (2, 10, 12, 3)).astype(np.float32)
        out, ncx, ncy = tscannet.center_principal_point(imgs, cx, cy)
        jout, jcx, jcy = jscannet.center_principal_point(imgs, cx, cy)
        np.testing.assert_array_equal(out, jout)
        assert (ncx, ncy) == (jcx, jcy)
