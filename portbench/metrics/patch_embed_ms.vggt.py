"""VGGT's DINOv2 patch embedding, its time a request: the `patch_embed`
span of styl3r_tpu_torch/utils/trace.py (CUDA events) summed over the
profiled slice and divided by its requests, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "patch_embed")
