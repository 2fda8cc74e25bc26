"""The median time of the loss a step (train/losses.py's LossBundle: the
VGG19 style loss and the identity branch's loss), from CUDA events around
the loss function the driver hands to the step, over the window, in ms."""

from portbench.readers import span_median


def read(record):
    return span_median(record, "loss")
