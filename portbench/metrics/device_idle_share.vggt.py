"""The share of the profiled slice in which no kernel ran, in %."""

from portbench.readers import idle_share


def read(record):
    return idle_share(record)
