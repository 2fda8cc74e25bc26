"""SDPA's fused attention kernels' share of the card's dense bf16 peak in
the profiled slice, in %: the FLOPs of the slice's attention calls
(portbench/counts/vggt.py, 4 * batch * heads * tokens^2 * head_dim a call)
over the device time of the kernels whose names are the fused backends'
(flash, memory-efficient, cuDNN)."""

from portbench.core import BF16_PEAK_FLOPS
from portbench.counts.vggt import attention_flops
from portbench.readers import kernel_roofline

KERNELS = ("flash", "fmha", "sdpa", "attention")


def bound(call):
    return attention_flops(call) / BF16_PEAK_FLOPS, "operations"


def read(record):
    return kernel_roofline(record, KERNELS, "attention_calls", bound)
