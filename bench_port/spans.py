"""The program's own spans in a traced run: the arithmetic their readers
share.

While a profiler records, the port opens an op-scope profiler range for
each phase of a frame (``prismarine_core_tpu_torch/utils/profiling.py:
span``): ``pc.frame``, ``pc.camera``, ``pc.bounce``, ``pc.query.closest``,
``pc.query.shadow``, ``pc.surface``, ``pc.nee``, ``pc.env``,
``pc.image``, ``pc.sort``, ``pc.reeval``, one ``pc.sync.<site>`` a
deliberate host sync and one ``pc.kernel.<name>`` a launch of a
hand-written kernel.  They are host ranges of the main thread
(``Trace.host_ops``) on the profiler's clock, the device ops' clock; being
op-scope ranges, they hold the kernels launched directly inside them and
leave no device-side copy among ``Trace.ops``.

A span's device time is that of the kernels launched by the host ops that
start inside it (``Trace.launches``: each host op holds the kernels it
launched itself; the port's raw launches sit in their ``pc.kernel.*``
span), less the copies the profiler's own events hold (``OVERHEAD``).  A span's idle time is the part of the device's idle gaps that
falls inside it.  On a program that opens no span the readers find no
``pc.frame`` and return None.
"""

from __future__ import annotations

import bisect

FRAME = "pc.frame"
QUERIES = ("pc.query.closest", "pc.query.shadow")
#: the profiler's own host events: each takes the correlation id of the op
#: it interrupts, so the profiler hands it that op's kernels a second time
#: (up to ~0.8% of a "bvh" frame's kernel time, one ``sb_intersect`` launch
#: of a "pallas" run)
OVERHEAD = frozenset(("Command Buffer Full", "Activity Buffer Request",
                      "Buffer Flush"))


def spans(trace, name: str, prefix: bool = False) -> list:
    """(start, end) us of the main thread's ranges named ``name`` (with
    ``prefix``: whose name starts with it) that start inside a traced
    unit, ascending."""
    units = sorted(trace.units)
    out = []
    for n, lo, hi in trace.host_ops:
        if n == name or (prefix and n.startswith(name)):
            i = bisect.bisect_right(units, (lo, float("inf"))) - 1
            if i >= 0 and lo <= units[i][1]:
                out.append((lo, hi))
    return sorted(out)


def union(*lists) -> list:
    """The union of interval lists as disjoint ascending intervals."""
    out = []
    for lo, hi in sorted(iv for ivs in lists for iv in ivs):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def covers(ivs: list, t: float) -> bool:
    """``t`` lies in one of the disjoint ascending intervals ``ivs``."""
    i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
    return i >= 0 and t <= ivs[i][1]


def launched_us(trace, inside: list, outside: list = ()) -> float:
    """Device us of the kernels launched by host ops that start inside
    ``inside`` and not inside ``outside`` (disjoint ascending intervals),
    the profiler's ``OVERHEAD`` events left out."""
    copies = {lo for n, lo, _ in trace.host_ops if n in OVERHEAD}
    return sum(us for start, us in trace.launches
               if start not in copies and covers(inside, start)
               and not covers(outside, start))


def idle_gaps(trace) -> list:
    """(start, end) us of each stretch of a traced unit in which no
    device op ran."""
    ops = sorted(trace.ops, key=lambda op: op.start)
    gaps = []
    for lo, hi in trace.units:
        t = lo
        for op in ops:
            if op.start < lo or op.start > hi:
                continue
            if op.start > t:
                gaps.append((t, op.start))
            t = max(t, op.end)
        if hi > t:
            gaps.append((t, hi))
    return gaps


def idle_us(trace, inside: list) -> float:
    """Device-idle us of the traced units that falls inside ``inside``
    (disjoint ascending intervals)."""
    total = 0.0
    for g_lo, g_hi in idle_gaps(trace):
        i = max(bisect.bisect_right(inside, (g_lo, float("inf"))) - 1, 0)
        for lo, hi in inside[i:]:
            if lo >= g_hi:
                break
            total += max(0.0, min(hi, g_hi) - max(lo, g_lo))
    return total


def framed(trace) -> bool:
    """A traced frames run whose program opened ``pc.frame``."""
    return trace.job == "frames" and bool(spans(trace, FRAME))


def launched_ms_per_frame(trace, names: tuple, outside: tuple = ()):
    """Device ms a traced frame launched inside the spans ``names`` and
    outside the spans ``outside``; None without the program's spans."""
    if not framed(trace):
        return None
    inside = union(*(spans(trace, n) for n in names))
    out = union(*(spans(trace, n) for n in outside))
    return launched_us(trace, inside, out) / 1e3 / trace.n


def innermost_spans(trace, times: list) -> list:
    """For each of the ascending ``times`` the innermost ``pc.*`` span
    open at it ("outside pc.frame" where none is); the spans of one
    thread nest."""
    host = sorted(((n, lo, hi) for n, lo, hi in trace.host_ops
                   if n.startswith("pc.")), key=lambda e: (e[1], -e[2]))
    labels, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][1] <= t:
            while stack and stack[-1][2] < host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        labels.append(stack[-1][0] if stack else "outside pc.frame")
    return labels

