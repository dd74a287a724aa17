"""Percent of a traced frame's surface interpolations (the program's
``pc.surface`` spans, ``render/integrator.py:_interpolate_surface``) that
hold a launch of the fused surface kernel (a ``pc.kernel.surface`` span
inside them, ``ops/surface.py:surface_fields``): 100 where every bounce
takes the kernel, 0 where every one takes the torch path.  None where the
program opens no ``pc.kernel.surface`` span at all (a program without the
kernel)."""

import bisect

from bench_port import spans


def read(trace):
    if not spans.framed(trace):
        return None
    fused = [lo for lo, _ in spans.spans(trace, "pc.kernel.surface")]
    surfaces = spans.spans(trace, "pc.surface")
    if not fused or not surfaces:
        return None
    held = sum(bisect.bisect_left(fused, lo) < bisect.bisect_right(fused, hi)
               for lo, hi in surfaces)
    return 100.0 * held / len(surfaces)
