"""The renderer's binning, sort and tile ranges a step
(ops/rasterizer/render.py::composite_inputs, every render of the step):
the `sort` span of styl3r_tpu_torch/utils/trace.py (CUDA events) summed
over the profiled slice and divided by its calls, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "sort")
