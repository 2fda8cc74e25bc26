"""The Gaussian adapter's time a request (models/encoder.py::_adapt: the raw
head outputs to Gaussians): the `adapter` span of
styl3r_tpu_torch/utils/trace.py (CUDA events) summed over the profiled
slice and divided by its calls, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "adapter")
