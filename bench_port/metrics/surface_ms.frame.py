"""Device ms per traced frame of the surface interpolation: the kernels of
every host op that starts inside the program's ``pc.surface`` span
(``render/integrator.py:_interpolate_surface``: the soup's gathers at the
hit, the material lookup, the texture fetches)."""

from bench_port import spans


def read(trace):
    return spans.launched_ms_per_frame(trace, ("pc.surface",))
