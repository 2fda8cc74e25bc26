"""Port parity for evaluation: styl3r_tpu_torch.eval (PSNR, SSIM, the
overlap-bucketed tracker, the Benchmarker and EvalHarness.test_step) against
styl3r_tpu.eval on the same arrays and carried-across weights.

Tolerances: PSNR and SSIM of the same images 1e-5 (f32 means and
convolutions summed in another order); the harness's PSNR and SSIM 1e-4,
as tests/test_torch_model.py holds the whole model (its renders may differ
by rounding, and by 1/255 where a pair's alpha lies on the 1/255 cutoff);
the tracker's means exactly (the same float sums in the same order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styl3r_tpu.eval import harness as jharness
from styl3r_tpu.eval import metrics as jmetrics
from styl3r_tpu.models.styl3r import Batch as JBatch
from styl3r_tpu.models.styl3r import Styl3rModel as JModel
from styl3r_tpu_torch.eval import harness as tharness
from styl3r_tpu_torch.eval import metrics as tmetrics
from styl3r_tpu_torch.eval.benchmarker import Benchmarker
from styl3r_tpu_torch.models.styl3r import Styl3rModel as TModel
from styl3r_tpu_torch.models.styl3r import batch_to
from styl3r_tpu_torch.utils.convert import from_jax_params
from tests.test_torch_model import TINY, draw_params


def _pair(rng, shape):
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, shape), -0.2, 1.2).astype(np.float32)
    return gt, pred


@pytest.mark.parametrize("shape", [(3, 32, 48, 3), (24, 20, 3)], ids=["batched", "single"])
def test_psnr_and_ssim_match_jax(shape):
    gt, pred = _pair(np.random.default_rng(0), shape)
    for fn in ("compute_psnr", "compute_ssim"):
        ours = getattr(tmetrics, fn)(torch.from_numpy(gt), torch.from_numpy(pred)).numpy()
        ref = np.asarray(getattr(jmetrics, fn)(jnp.asarray(gt), jnp.asarray(pred)))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5, err_msg=fn)
    from styl3r_tpu.losses.ssim import ssim as jssim
    from styl3r_tpu_torch.losses.ssim import ssim as tssim

    ours = tssim(torch.from_numpy(gt), torch.from_numpy(pred), return_map=True).numpy()
    np.testing.assert_allclose(ours, np.asarray(jssim(jnp.asarray(gt), jnp.asarray(pred), return_map=True)),
                               atol=1e-5)


def test_metric_tracker_matches_jax():
    rng = np.random.default_rng(1)
    ours, ref = tmetrics.MetricTracker(), jmetrics.MetricTracker()
    for overlap in (None, 0.1, 0.3, 0.55, 0.56, 0.9):
        m = {"psnr": float(rng.uniform(10, 30)), "ssim": float(rng.uniform(0, 1))}
        ours.update(m, overlap)
        ref.update(m, overlap)
    assert ours.means() == ref.means()
    assert ours.table() == ref.table()
    for overlap in (0.0, 0.29, 0.3, 0.55, 0.551, 1.0):
        assert tmetrics.overlap_tag(overlap) == jmetrics.overlap_tag(overlap)


def test_benchmarker_records_and_dumps(tmp_path):
    bench = Benchmarker("cpu")
    for n in (4, 2, 2):
        with bench.time("decoder", num_calls=n):
            sum(range(10000))
    bench.record("decoder_unpadded", bench.last_elapsed, num_calls=2)
    summary = bench.summarize()
    times = bench.execution_times["decoder"]
    assert len(times) == 8 and bench.last_elapsed > 0
    assert summary["decoder"] == pytest.approx(sum(times) / 8)
    assert summary["decoder_steady"] == pytest.approx(sum(times[4:]) / 4)
    assert summary["decoder_unpadded"] == pytest.approx(bench.last_elapsed / 2)
    bench.dump(tmp_path / "benchmark.json")
    bench.dump_memory(tmp_path / "peak_memory.json")
    assert json.loads((tmp_path / "benchmark.json").read_text()) == pytest.approx(summary)
    assert json.loads((tmp_path / "peak_memory.json").read_text()) == {"cpu": None}


H = W = 32
RENDER = dict(max_per_tile=256, max_tiles_per_gaussian=8)


def _batch(rng, t=2):
    k = np.asarray([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1.0]], np.float32)
    ext = np.tile(np.eye(4, dtype=np.float32), (1, t, 1, 1))
    ext[0, :, 0, 3] = 0.03 * np.arange(t)
    return JBatch(
        context_images=rng.uniform(0, 1, (1, 2, H, W, 3)).astype(np.float32),
        context_intrinsics=np.tile(k, (1, 2, 1, 1)),
        target_extrinsics=ext,
        target_intrinsics=np.tile(k, (1, t, 1, 1)),
        target_near=np.full((1, t), 0.1, np.float32),
        target_far=np.full((1, t), 100.0, np.float32),
        style_image=rng.uniform(0, 1, (1, 256, 256, 3)).astype(np.float32),
        target_images=rng.uniform(0, 1, (1, t, H, W, 3)).astype(np.float32),
    )


@pytest.mark.parametrize("align_pose", [False, True], ids=["plain", "aligned"])
def test_harness_test_step_matches_jax(tmp_path, align_pose):
    """The identity-style protocol on carried-across weights: the style
    image (256^2, not the context's size) is replaced by context view 0 in
    both."""
    batch = _batch(np.random.default_rng(2))
    jb = jax.tree.map(jnp.asarray, batch)
    jm = JModel(sh_degree=0, **TINY)
    params = draw_params(jm, jb, seed=3)
    tm = TModel(sh_degree=0, device="cpu", **TINY)
    tm.load_state_dict(from_jax_params(params))
    kwargs = dict(image_shape=(H, W), align_pose=align_pose, pose_align_steps=2, render_kwargs=RENDER)
    ref = jharness.EvalHarness(jm, params, **kwargs)
    ours = tharness.EvalHarness(tm, output_path=tmp_path, save_images=True, save_videos=True, video_frames=4,
                                **kwargs)
    jmets, jout = ref.test_step(jb, scene="s0", overlap=0.2)
    tmets, tout = ours.test_step(batch_to(batch, "cpu"), scene="s0", overlap=0.2)
    assert sorted(tmets) == sorted(jmets) == ["psnr", "ssim"]
    for name in jmets:
        assert tmets[name] == pytest.approx(jmets[name], abs=1e-4), name
    assert tout.color.shape == (1, 2, H, W, 3)
    assert (tmp_path / "images" / "s0" / "0001.png").exists()
    assert len(list((tmp_path / "videos" / "s0").glob("*.png"))) == 4

    ours.test_step(batch_to(batch, "cpu"), scene="s1", overlap=0.9)
    means = ours.finish()
    assert {"psnr/all", "psnr/small", "psnr/large", "ssim/medium"} - set(means) == {"ssim/medium"}
    bench = json.loads((tmp_path / "benchmark.json").read_text())
    expected = {"encoder", "decoder", "decoder_unpadded"} | ({"optimize"} if align_pose else set())
    assert expected | {f"{k}_steady" for k in expected} == set(bench)
    assert bench["decoder"] == pytest.approx(bench["decoder_unpadded"])
    assert json.loads((tmp_path / "scores.json").read_text()) == pytest.approx(means)
