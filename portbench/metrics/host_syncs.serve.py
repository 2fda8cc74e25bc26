"""The host's synchronisations with the card in one request
(torch.cuda.set_sync_debug_mode), a count."""


def read(record):
    syncs = record.get("host_syncs")
    return None if syncs is None else float(syncs["count"])
