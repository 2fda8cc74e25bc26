"""The median time of the optimizer's step (GroupedAdamW: the clip by
the global norm and AdamW), from CUDA events around it over the window, in
ms."""

from portbench.readers import span_median


def read(record):
    return span_median(record, "optimizer")
