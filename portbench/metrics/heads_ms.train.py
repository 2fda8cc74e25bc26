"""The DPT heads' time a step, forward only (models/encoder.py: each model
forward of the step): the `heads` span of styl3r_tpu_torch/utils/trace.py
(CUDA events) summed over the profiled slice and divided by its calls, in
ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "heads")
