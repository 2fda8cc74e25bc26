"""Kernels launched a request (32 frames) in the profiled slice of whole
requests."""


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    return trace["kernels"] / record["trace_calls"]
