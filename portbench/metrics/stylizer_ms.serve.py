"""The token stylizer's time a request (models/encoder.py: the style image's
encoder and the stylizer's decoder over the content tokens): the
`stylizer` span of styl3r_tpu_torch/utils/trace.py (CUDA events) summed
over the profiled slice and divided by its calls, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "stylizer")
