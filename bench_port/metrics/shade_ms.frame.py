"""Device ms per traced frame of the bounce loop's shading: the kernels of
every host op that starts inside the program's ``pc.bounce`` spans but
outside their ``pc.query.*`` and ``pc.surface`` spans (the BSDF, the
light sampling of NEE, Russian roulette, the carry)."""

from bench_port import spans


def read(trace):
    return spans.launched_ms_per_frame(
        trace, ("pc.bounce",), spans.QUERIES + ("pc.surface",))
