"""VGGT's RoPE2D time a request: the `rope` span of
styl3r_tpu_torch/utils/trace.py (CUDA events) around the q/k rotation of
each of the aggregator's attentions, summed over the profiled slice and
divided by its requests, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "rope")
