"""The optimizer's clip a step (train/step.py::GroupedAdamW.step: the
zero-fill of gradients the loss did not reach and the clip by the global
norm): the `clip` span of styl3r_tpu_torch/utils/trace.py (CUDA events)
summed over the profiled slice and divided by its calls, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "clip")
