"""VGGT's frame-attention blocks, their time a request: the `frame_blocks`
span of styl3r_tpu_torch/utils/trace.py (CUDA events, one entry a block)
summed over the profiled slice and divided by its requests, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "frame_blocks")
