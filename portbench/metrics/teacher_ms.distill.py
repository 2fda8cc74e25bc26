"""The median time of the distillation teacher's forward a step (models/
distiller.py), from CUDA events at its forward hooks over the window, in
ms."""

from portbench.readers import span_median


def read(record):
    return span_median(record, "teacher")
