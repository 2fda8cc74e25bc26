"""The data-parallel gradient all-reduce's time a step on rank 0: the
`allreduce` span of styl3r_tpu_torch/train/step.py (CUDA events, waiting
for the other ranks included) summed over the profiled slice and divided by
its steps, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "allreduce")
