"""A train step's forward (train/step.py: from the batch to the scalar loss,
with every model forward, the teacher and the losses): the `forward` span
of styl3r_tpu_torch/utils/trace.py (CUDA events) summed over the profiled
slice and divided by its calls, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "forward")
