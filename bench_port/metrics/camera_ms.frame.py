"""Device ms per traced frame of what the camera launches: the kernels of
every host op that starts inside the program's ``pc.camera`` span
(``render/integrator.py:primary_rays``: ``generate_rays`` and the
interlace mask)."""

from bench_port import spans


def read(trace):
    return spans.launched_ms_per_frame(trace, ("pc.camera",))
