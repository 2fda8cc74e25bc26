"""The whole step's share of the card's dense bf16 peak over the window:
portbench/counts/flops.py's FLOPs of a training step (each module's
forward, twice more for each the backward passes through) times the steps,
over the window's seconds, in %. The distillation teacher's float32 runs
under the card's 67 TFLOP/s float32 rate, not this peak."""

from portbench.readers import mfu


def read(record):
    return mfu(record)
