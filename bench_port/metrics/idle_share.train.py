"""Percent of the traced train steps' wall time in which no device op
ran."""


def read(trace):
    if trace.job != "train" or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
