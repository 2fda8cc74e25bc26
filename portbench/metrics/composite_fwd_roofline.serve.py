"""The compositor forward kernel's share of its roofline in the profiled
slice, in %: the bound counted from each call's inputs by
portbench/counts/composite.py over the kernel's device time."""

from portbench.counts.composite import forward_bound
from portbench.readers import kernel_roofline


def read(record):
    return kernel_roofline(record, "composite_fwd", "composite_inputs", forward_bound)
