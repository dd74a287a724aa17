"""Host syncs per traced frame that the program declares: its
``pc.sync.<site>`` spans (``compact_pairs``' ``nonzero``, the texture
kinds' read), to read beside ``host_syncs.frame``, which counts every
sync torch reports."""

from bench_port import spans


def read(trace):
    if not spans.framed(trace):
        return None
    return len(spans.spans(trace, "pc.sync.", prefix=True)) / trace.n
