"""Host ops per traced frame that launch the texture fetches' device
work: the host ops that start inside the program's ``pc.texture.<kind>``
spans and launch device work, the profiler's own events left out; what a
fused fetch would cut.  A host op that launches several kernels counts
once (``trace.launches`` holds one entry per host op), so this is not on
the scale of ``glue_launches.frame``, which counts device ops.  None where
the program opens none of those spans or no ``pc.frame``."""

from bench_port import spans


def read(trace):
    inside = spans.union(spans.spans(trace, "pc.texture.", prefix=True))
    if not inside or not spans.spans(trace, spans.FRAME):
        return None
    copies = {lo for n, lo, _ in trace.host_ops if n in spans.OVERHEAD}
    return sum(start not in copies and spans.covers(inside, start)
               for start, _ in trace.launches) / trace.n
