"""The optimizer's update a step (train/step.py::GroupedAdamW.step: AdamW and
the schedule): the `adamw` span of styl3r_tpu_torch/utils/trace.py (CUDA
events) summed over the profiled slice and divided by its calls, in ms."""

from portbench.spans import span_ms


def read(record):
    return span_ms(record, "adamw")
