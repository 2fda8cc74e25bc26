"""The share of the Styl3r encoder's forwards on the card (one a request)
that replayed its CUDA graphs, over the whole run: 100 x the program's
counter `encoder_replays` over `encoder_calls`
(styl3r_tpu_torch/utils/trace.py), in %. None where the program keeps no
such counters, or ran no encoder forward on the card."""


def read(record):
    try:
        from styl3r_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()
    if not counts.get("encoder_calls") or "encoder_replays" not in counts:
        return None
    return 100.0 * counts["encoder_replays"] / counts["encoder_calls"]
