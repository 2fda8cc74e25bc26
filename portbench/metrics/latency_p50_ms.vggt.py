"""The median request latency of the window, on the host clock, in ms."""

from portbench.core import median


def read(record):
    lat = record.get("latencies_ms")
    return median(lat) if lat else None
