"""Device ms per traced frame of the texture fetches: the kernels of every
host op that starts inside the program's ``pc.texture.<kind>`` spans
(``render/integrator.py:_interpolate_surface``: the fetch of each bound
kind, diffuse, specular, emissive and bump, and its use at the hit).
None where the program opens none of them (an untextured scene, or a
program without the spans) or no ``pc.frame``."""

from bench_port import spans


def read(trace):
    inside = spans.union(spans.spans(trace, "pc.texture.", prefix=True))
    if not inside or not spans.spans(trace, spans.FRAME):
        return None
    return spans.launched_us(trace, inside) / 1e3 / trace.n
