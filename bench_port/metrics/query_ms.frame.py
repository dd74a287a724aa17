"""Device ms per traced frame of what the hit queries launch: the kernels
of every host op that starts inside the program's ``pc.query.closest``
or ``pc.query.shadow`` spans (the coherence sort, the culls, the
compactions, the walk or pair kernels, the re-evaluation of the hit)."""

from bench_port import spans


def read(trace):
    return spans.launched_ms_per_frame(trace, spans.QUERIES)
