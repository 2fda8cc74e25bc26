"""The five DPT heads' time a forward of the batch's scenes
(models/encoder.py): the `heads` span of styl3r_tpu_torch/utils/trace.py
(CUDA events) summed over the profiled slice and divided by its calls, in
ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "heads")
