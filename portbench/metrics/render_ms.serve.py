"""The median time of render_gaussians a request (projection, binning,
sort and the compositor kernel), from CUDA events around it over the
window, in ms."""

from portbench.readers import span_median


def read(record):
    return span_median(record, "renderer")
