"""RoPE2D's time a request, summed over every attention that applies it
(models/vit.py: the q/k pair of each): the `rope` span of
styl3r_tpu_torch/utils/trace.py (CUDA events) summed over the profiled
slice and divided by its calls, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "rope")
