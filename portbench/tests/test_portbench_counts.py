"""The frozen counts equal the originals they were copied from
(styl3r_tpu_torch/utils/flops.py, chip_smoke.py's compositor counts) on
the same shapes, and the roofline's count takes no figure from the kernel."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.counts import composite as counts
from portbench.counts import flops

SHAPES = [
    dict(b=1, v=2, h=256, w=256, style_hw=256, n_targets=1, pair_cap_per_gaussian=2),
    dict(b=8, v=2, h=256, w=256, style_hw=256, n_targets=1, pair_cap_per_gaussian=2),
    dict(b=2, v=3, h=256, w=256, style_hw=256, n_targets=4, pair_cap_per_gaussian=0, enc_depth=2, dec_depth=4,
         enc_dim=32, dec_dim=16),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_flops_equal_the_programs_today(shape):
    from styl3r_tpu_torch.utils import flops as original

    assert flops.styl3r_forward_flops(**shape) == original.styl3r_forward_flops(**shape)


def test_training_flops_count_three_forwards_of_the_student_and_one_of_the_teacher():
    dims = dict(enc_depth=24, dec_depth=12, enc_dim=1024, dec_dim=768)
    step = flops.distill_step_flops(2, 2, 256, 256, dims, dims)
    assert step == 3 * flops.student_points_flops(2, 2, 256, 256, **dims) + flops.teacher_forward_flops(2, 256, 256)
    # The student's points path is the forward without the stylizer, the
    # Gaussian heads and the render: less than the whole forward.
    whole = flops.styl3r_forward_flops(b=2, v=2, h=256, w=256, n_targets=1)
    assert flops.student_points_flops(2, 2, 256, 256) < whole["total"]


def compositor_inputs(seed=0, g=600, hw=(64, 64), max_per_tile=512):
    """Compositor inputs of a random cloud through the program's
    projection, binning and sort (on the CPU)."""
    from styl3r_tpu_torch.ops.rasterizer.camera import make_raster_camera
    from styl3r_tpu_torch.ops.rasterizer.render import composite_inputs

    gen = torch.Generator().manual_seed(seed)
    means = torch.randn(1, g, 3, generator=gen) * 0.5 + torch.tensor([0.0, 0.0, 3.0])
    scales = torch.rand(1, g, 3, generator=gen) * 0.05 + 0.01
    rotations = torch.nn.functional.normalize(torch.randn(1, g, 4, generator=gen), dim=-1)
    harmonics = torch.rand(1, g, 3, 1, generator=gen)
    opacities = torch.rand(1, g, generator=gen)
    k = torch.tensor([[[1.1, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1.0]]])
    cams = make_raster_camera(torch.eye(4)[None], k, torch.tensor([1.0]), torch.tensor([100.0]), hw)
    inputs = composite_inputs(cams, means, None, harmonics, opacities, hw, scales=scales, rotations=rotations,
                              max_tiles_per_gaussian=16, max_per_tile=max_per_tile)
    return inputs, max_per_tile


def test_compositor_counts_equal_chip_smokes_on_the_same_walk():
    import chip_smoke
    from styl3r_tpu_torch.ops.rasterizer import composite

    inputs, mpt = compositor_inputs()
    args = (inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds, inputs.grid, mpt, inputs.n_views)
    program_walk = composite.composite_tiles_plain(*args).n_done
    walk = counts.windows_walked(*args)
    assert torch.equal(walk, program_walk) and int(walk.sum()) > 0
    assert counts.forward_work(inputs.starts, inputs.counts, walk, inputs.n_views) == \
        chip_smoke.composite_work(inputs, walk)
    assert counts.backward_work(inputs.starts, inputs.counts, walk, inputs.n_views) == \
        chip_smoke.composite_bwd_work(inputs, walk)
    assert (counts.OPS_PER_EVAL, counts.BWD_OPS_PER_EVAL, counts.PEAK_F32_FLOPS, counts.PEAK_BYTES) == (
        chip_smoke.COMPOSITE_OPS_PER_EVAL, chip_smoke.COMPOSITE_BWD_OPS_PER_EVAL, chip_smoke.PEAK_F32_FLOPS,
        chip_smoke.PEAK_BYTES)


def test_the_roofline_count_takes_no_figure_from_the_kernel(monkeypatch):
    """The bound is counted from the call's arguments alone: the program's
    compositor (kernel or plain) is never called, and the result does not
    depend on what a kernel would report."""
    from styl3r_tpu_torch.ops.rasterizer import composite

    inputs, mpt = compositor_inputs(seed=1)
    args = (inputs.attrs, inputs.starts, inputs.counts, inputs.backgrounds, inputs.grid, mpt, inputs.n_views)

    def refuse(*a, **k):
        raise AssertionError("the count called the program's compositor")

    for name in ("composite_tiles", "composite_tiles_plain", "composite_tiles_diff"):
        monkeypatch.setattr(composite, name, refuse)
    bound, kind = counts.forward_bound(args)
    walk = counts.windows_walked(*args)
    evals, nbytes = counts.forward_work(inputs.starts, inputs.counts, walk, inputs.n_views)
    assert np.isclose(bound, max(evals * counts.OPS_PER_EVAL / counts.PEAK_F32_FLOPS, nbytes / counts.PEAK_BYTES))
    assert kind in ("operations", "bytes")
