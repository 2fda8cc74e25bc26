"""The peak of memory allocated on the card over the window, in GiB."""


def read(record):
    peak = record.get("window_peak_bytes")
    return peak / 2**30 if peak else None
