"""The CroCo backbone's time a request (models/encoder.py: the multiview
encoder and decoder blocks over the context views): the `backbone` span of
styl3r_tpu_torch/utils/trace.py (CUDA events) summed over the profiled
slice and divided by its calls, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "backbone")
