"""The whole forward's share of the card's dense bf16 peak over the
window: portbench/counts/vggt.py's FLOPs of a request (the float32 heads'
included) times the requests, over the window's seconds, in %."""

from portbench.readers import mfu


def read(record):
    return mfu(record)
