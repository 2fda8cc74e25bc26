"""A train step's backward (train/step.py: loss.backward(), the compositor's
backward kernel among it): the `backward` span of
styl3r_tpu_torch/utils/trace.py (CUDA events) summed over the profiled
slice and divided by its calls, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "backward")
