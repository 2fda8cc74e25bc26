"""The compositor backward kernels' share of their roofline in the
profiled slice, in %: the bound counted from each call's inputs by
portbench/counts/composite.py (the windows walked as the reference walks
them, never the forward kernel's count) over the device time of both
kernels (bwd_sums_kernel, bwd_grad_kernel) summed."""

from portbench.counts.composite import backward_bound
from portbench.readers import kernel_roofline


def read(record):
    return kernel_roofline(record, ("bwd_sums_kernel", "bwd_grad_kernel"), "composite_bwd_inputs", backward_bound)
