"""Host syncs torch reports over one frame (``set_sync_debug_mode``),
less the mode's own."""


def read(trace):
    if trace.job != "frames" or trace.host_syncs is None:
        return None
    return float(trace.host_syncs)
