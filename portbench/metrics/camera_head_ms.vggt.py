"""VGGT's camera head, its time a request: the `camera_head` span of
styl3r_tpu_torch/utils/trace.py (CUDA events; the 4 refinements together)
summed over the profiled slice and divided by its requests, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "camera_head")
