"""Port parity for pose evaluation: styl3r_tpu_torch.eval.pose (PnP with
RANSAC, the pose error metrics and AUC, the photometric refinement) against
styl3r_tpu.eval.pose on the same numpy inputs.

Tolerances, each with its reason:
  * PnP, the error metrics and the AUC: equal. The port's PnP is the same
    numpy code drawing from the same np.random.default_rng(seed), so the
    same float64 arithmetic runs in the same order.
  * the refinement's first-step camera-delta gradients: 1e-4 of their
    largest component (the plain compositor's gradient against autodiff of
    the jnp one, as tests/test_torch_backward.py holds it; the SSIM term's
    filter sums in another order).
  * the extrinsics after 5 refinement steps: 1e-5, as the alignment's in
    tests/test_torch_infer.py (Adam moves each component by about lr a
    step whatever the gradient's size, so a gradient's relative error e
    moves it by about e * lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.eval import pose as jpose
from styl3r_tpu.geometry.gaussians import Gaussians as JGaussians
from styl3r_tpu.geometry.gaussians import build_covariance
from styl3r_tpu.geometry.se3 import se3_exp as jse3_exp
from styl3r_tpu.losses.ssim import ssim as jssim
from styl3r_tpu.models.decoder import render_gaussians as j_render
from styl3r_tpu_torch.eval import pose as tpose
from styl3r_tpu_torch.geometry.gaussians import Gaussians as TGaussians
from styl3r_tpu_torch.geometry.se3 import se3_exp as tse3_exp
from styl3r_tpu_torch.models.decoder import render_gaussians as t_render
from tests.test_pose import make_correspondences

K_PIX = np.asarray([[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]])


@pytest.mark.parametrize("noise, outliers, iterations", [(0.0, 0, 100), (1.0, 40, 60), (2.0, 80, 100)],
                         ids=["exact", "noisy", "outliers"])
def test_pnp_ransac_equals_jax(noise, outliers, iterations):
    rng = np.random.default_rng(int(10 * noise) + outliers)
    w2c = np.asarray(jse3_exp(jnp.asarray(rng.uniform(-0.3, 0.3, 6))), np.float64)
    world, proj = make_correspondences(rng, 200, w2c, K_PIX, noise=noise, outliers=outliers)
    ours = tpose.pnp_ransac(world, proj, K_PIX, iterations=iterations, seed=7)
    ref = jpose.pnp_ransac(world, proj, K_PIX, iterations=iterations, seed=7)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[0].dtype == np.float32
    # The DLT alone, and on too few points.
    norm2d = proj[:8] / 300.0
    np.testing.assert_array_equal(tpose._pnp_dlt(world[:8], norm2d), jpose._pnp_dlt(world[:8], norm2d))
    assert tpose._pnp_dlt(world[:5], norm2d[:5]) is None


@pytest.mark.parametrize("h, w, threshold", [(24, 32, 0.3), (80, 64, 0.3), (16, 16, 0.99)],
                         ids=["small", "subsampled", "all_below_threshold"])
def test_pnp_pose_from_gaussians_equals_jax(h, w, threshold):
    """Per-pixel means of a known camera with noisy opacities: above
    max_points (4096) the points are subsampled from the seed's generator;
    with fewer than 6 points over the threshold all of them are used."""
    rng = np.random.default_rng(h + w)
    k_norm = np.asarray([[0.9, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]], np.float32)
    c2w = np.asarray(jse3_exp(jnp.asarray([0.05, -0.1, 0.02, 0.3, -0.1, 0.05])), np.float64)
    ys, xs = np.mgrid[0:h, 0:w]
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3).astype(np.float64)
    k = k_norm.astype(np.float64) * np.asarray([[w], [h], [1]])
    depth = rng.uniform(2, 6, h * w)
    cam = (np.linalg.inv(k) @ pix.T).T * depth[:, None]
    pts3d = ((c2w[:3, :3] @ cam.T).T + c2w[:3, 3]).reshape(h, w, 3).astype(np.float32)
    pts3d += rng.normal(0, 0.002, pts3d.shape).astype(np.float32)
    opacity = rng.uniform(0, 1, (h, w)).astype(np.float32)
    ours = tpose.pnp_pose_from_gaussians(pts3d, opacity, k_norm, opacity_threshold=threshold)
    ref = jpose.pnp_pose_from_gaussians(pts3d, opacity, k_norm, opacity_threshold=threshold)
    np.testing.assert_array_equal(ours, ref)
    if threshold < 0.5:
        r_err, _ = tpose.pose_error_deg(ours, c2w)
        assert r_err < 1.0


def test_pose_metrics_and_auc_equal_jax():
    rng = np.random.default_rng(3)
    poses = [np.asarray(jse3_exp(jnp.asarray(rng.normal(0, 0.4, 6))), np.float64) for _ in range(6)]
    poses[1][:3, 3] = 0.0  # a zero translation gives a 0 angle
    for a in poses:
        for b in poses:
            assert tpose.pose_error_deg(a, b) == jpose.pose_error_deg(a, b)
            assert tpose.rotation_angle_deg(a[:3, :3], b[:3, :3]) == jpose.rotation_angle_deg(a[:3, :3], b[:3, :3])
            assert tpose.translation_angle_deg(a[:3, 3], -b[:3, 3]) == jpose.translation_angle_deg(a[:3, 3], -b[:3, 3])
    for errors in (rng.uniform(0, 30, 17), [0.0, 5.0, 5.0, 10.0, 25.0], [40.0, 50.0], [1.0]):
        ours, ref = tpose.pose_auc(errors), jpose.pose_auc(errors)
        assert ours == ref and sorted(ours) == [5, 10, 20]
    assert tpose.pose_auc([0.0, 0.0])[5] == 1.0 and tpose.pose_auc([30.0])[20] == 0.0


H = W = 64
K_NORM = np.asarray([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], np.float32)
RENDER = dict(max_per_tile=256, max_tiles_per_gaussian=8)
NEAR, FAR = 0.5, 50.0
# tests/test_pose.py::test_photometric_refinement_recovers_pnp_error's
# perturbation: about 2 degrees and 2% of translation.
PERTURBATION = [0.02, -0.015, 0.01, 0.02, -0.025, 0.015]


def _cloud(seed=29, g=600):
    """tests/test_pose.py's 600-Gaussian cloud, as numpy arrays."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.2, 1.2, g), rng.uniform(-1.2, 1.2, g), rng.uniform(2.5, 5.0, g)], -1)
    scales = np.full((g, 3), 0.05)
    quats = np.tile([1.0, 0, 0, 0], (g, 1))
    sh = rng.uniform(-0.5, 0.5, (g, 3, 1))
    opacities = np.full((g,), 0.8)
    return [np.asarray(x, np.float32)[None] for x in (means, sh, opacities, scales, quats)]


def _gaussians(arrays, pkg):
    means, sh, op, scales, quats = arrays
    if pkg == "jax":
        cov = build_covariance(jnp.asarray(scales), jnp.asarray(quats))
        return JGaussians(jnp.asarray(means), cov, jnp.asarray(sh), jnp.asarray(op), jnp.asarray(scales),
                          jnp.asarray(quats))
    t = [torch.from_numpy(x) for x in arrays]
    return TGaussians(t[0], None, t[1], t[2], t[3], t[4])


def _target_and_start(gaussians):
    """The render at the identity and the perturbed start pose."""
    k = torch.from_numpy(K_NORM)[None, None]
    target = t_render(gaussians, torch.eye(4)[None, None], k, torch.full((1, 1), NEAR), torch.full((1, 1), FAR),
                      (H, W), **RENDER).color[0, 0]
    return target, tse3_exp(torch.tensor(PERTURBATION))


def test_refinement_matches_jax():
    """refine_pose_photometric on the same cloud, target and start: the
    first step's camera-delta gradients, then the pose after 5 steps."""
    arrays = _cloud()
    target, start = _target_and_start(_gaussians(arrays, "torch"))
    k = jnp.asarray(K_NORM)

    def j_loss(deltas):
        out = j_render(_gaussians(arrays, "jax"), jnp.asarray(start.numpy())[None, None], k[None, None],
                       jnp.full((1, 1), NEAR), jnp.full((1, 1), FAR), (H, W), cam_rot_delta=deltas["rot"],
                       cam_trans_delta=deltas["trans"], impl="jnp", **RENDER)
        pred = out.color[0, 0]
        tgt = jnp.asarray(target.numpy())
        return jnp.mean((pred - tgt) ** 2) + 0.2 * (1.0 - jssim(pred, tgt))

    ref = jax.jit(jax.grad(j_loss))({"rot": jnp.zeros((1, 1, 3)), "trans": jnp.zeros((1, 1, 3))})
    rot = torch.zeros(1, 1, 3, requires_grad=True)
    trans = torch.zeros(1, 1, 3, requires_grad=True)
    out = t_render(_gaussians(arrays, "torch"), start[None, None], torch.from_numpy(K_NORM)[None, None],
                   torch.full((1, 1), NEAR), torch.full((1, 1), FAR), (H, W), cam_rot_delta=rot,
                   cam_trans_delta=trans, **RENDER)
    ours = torch.autograd.grad(tpose.photometric_loss(out.color[0, 0], target), (rot, trans))
    for name, g in zip(("rot", "trans"), ours):
        r = np.asarray(ref[name])
        scale = np.abs(r).max()
        assert scale > 0
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * scale, err_msg=name)

    refined = tpose.refine_pose_photometric(_gaussians(arrays, "torch"), start, torch.from_numpy(K_NORM), target,
                                            NEAR, FAR, steps=5, **RENDER)
    j_refined = jpose.refine_pose_photometric(_gaussians(arrays, "jax"), jnp.asarray(start.numpy()), k,
                                              jnp.asarray(target.numpy()), NEAR, FAR, steps=5, impl="jnp", **RENDER)
    assert refined.shape == (4, 4)
    np.testing.assert_allclose(refined.numpy(), np.asarray(j_refined), atol=1e-5)
    assert float((refined - start).abs().max()) > 1e-3  # the steps moved the camera


def test_refinement_recovers_the_perturbation():
    """tests/test_pose.py::test_photometric_refinement_recovers_pnp_error in
    the port, cut from its 150 steps to 30 (a slow test there; a refinement
    step is a few hundred small CPU ops, which the parallel test workers
    slow down many times over): from about 2 degrees off the rotation error
    falls below a third of its start (to 0.19x of it here; 0.11x after 150
    steps)."""
    gaussians = _gaussians(_cloud(), "torch")
    target, start = _target_and_start(gaussians)
    r0, _ = tpose.pose_error_deg(start.numpy(), np.eye(4))
    assert r0 > 1.0
    refined = tpose.refine_pose_photometric(gaussians, start, torch.from_numpy(K_NORM), target, NEAR, FAR,
                                            steps=30, **RENDER).numpy()
    r1, _ = tpose.pose_error_deg(refined, np.eye(4))
    assert r1 < r0 / 3 and r1 < 0.6, (r0, r1)
    assert float(np.linalg.norm(refined[:3, 3])) < float(np.linalg.norm(start[:3, 3].numpy())), refined[:3, 3]
