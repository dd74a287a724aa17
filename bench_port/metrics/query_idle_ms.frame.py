"""Device-idle ms per traced frame inside the hit queries: the part of
the traced frames' idle stretches (no device op running) that falls
inside the program's ``pc.query.closest`` and ``pc.query.shadow`` spans,
where the packet query's compactions wait on the device."""

from bench_port import spans


def read(trace):
    if not spans.framed(trace):
        return None
    inside = spans.union(*(spans.spans(trace, n) for n in spans.QUERIES))
    return spans.idle_us(trace, inside) / 1e3 / trace.n
