"""The median time of predict_gaussians a request (the encoder: backbone,
stylizer, DPT heads and adapter), from CUDA events around it over the
window, in ms."""

from portbench.readers import span_median


def read(record):
    return span_median(record, "encoder")
