"""Reading a traced run: the device timeline from ``torch.profiler``, the
host syncs of one frame, and the program's kernel names.

The profiler's host cost inflates the wall and so the idle share of a
traced window; the end-to-end metrics come from untraced runs.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import warnings
from pathlib import Path

import torch

#: the profiler range the harness opens around each traced frame or step,
#: and around the train step's call of ``torch.autograd.grad``
UNIT_RANGE, BACKWARD_RANGE = "bench.unit", "bench.backward"
#: device ops and idle labels a breakdown lists
BREAKDOWN_ROWS = 10
NAME_CHARS = 120


def port_kernel_names(csrc: Path) -> frozenset:
    """The ``__global__`` functions of the program's CUDA sources."""
    names = set()
    for p in sorted(csrc.glob("*.cu*")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            p.read_text()))
    return frozenset(names)


def host_syncs(fn) -> collections.Counter:
    """Host syncs torch reports while ``fn()`` runs
    (``set_sync_debug_mode("warn")``), by the source line that issued
    them, less what switching the detection on and off reports by
    itself."""
    def count(f):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                f()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return collections.Counter(
            f"{'/'.join(Path(w.filename).parts[-2:])}:{w.lineno}"
            for w in caught if "synchroniz" in str(w.message))
    return count(fn) - count(lambda: None)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float            # us, the profiler's clock
    end: float

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-6


@dataclasses.dataclass
class Trace:
    """What a traced run gives the per-layer readers."""
    job: str                       # "frames" or "train"
    units: list                    # (start, end) us of each traced unit
    ops: list                      # DeviceOp of the traced units
    port_kernels: frozenset
    marks: list = dataclasses.field(default_factory=list)  # backward starts
    #: (start us, device us) of each host op that launched device work:
    #: the device time of the kernels it launched itself
    launches: list = dataclasses.field(default_factory=list)
    calls: dict = dataclasses.field(default_factory=dict)  # last unit's
    host_syncs: int | None = None  # per frame
    host_ops: list = dataclasses.field(default_factory=list)

    @property
    def n(self) -> int:
        return len(self.units)

    @property
    def window_s(self) -> float:
        return (self.units[-1][1] - self.units[0][0]) * 1e-6

    @property
    def busy_s(self) -> float:
        """Seconds in which some device op ran (overlaps counted once)."""
        total, reach = 0.0, None
        for op in sorted(self.ops, key=lambda e: e.start):
            if reach is None or op.start > reach:
                total += op.end - op.start
                reach = op.end
            elif op.end > reach:
                total += op.end - reach
                reach = op.end
        return total * 1e-6

    def is_port(self, op: DeviceOp) -> bool:
        return any(k in op.name for k in self.port_kernels)

    def unit_ops(self, i: int) -> list:
        lo, hi = self.units[i]
        return [op for op in self.ops if lo <= op.start and op.end <= hi]

    def breakdown(self) -> dict:
        """The device ops that took most time, and the idle time by what
        the host was doing (the innermost host op open at the middle of
        each gap, summed over the gaps), in seconds over the window."""
        by_name = collections.Counter()
        for op in self.ops:
            by_name[op.name[:NAME_CHARS]] += op.seconds
        gaps = []
        ops = sorted(self.ops, key=lambda e: e.start)
        for lo, hi in self.units:
            t = lo
            for op in ops:
                if op.start < lo or op.start > hi:
                    continue
                if op.start > t:
                    gaps.append(((t + op.start) / 2, op.start - t))
                t = max(t, op.end)
            if hi > t:
                gaps.append(((t + hi) / 2, hi - t))
        idle = collections.Counter()
        for (_, us), label in zip(sorted(gaps), self._host_labels(
                sorted(g[0] for g in gaps))):
            idle[label] += us * 1e-6
        return {"device_ops": [[k, v] for k, v in
                               by_name.most_common(BREAKDOWN_ROWS)],
                "idle_gaps": [[k, v] for k, v in
                              idle.most_common(BREAKDOWN_ROWS)]}

    def _host_labels(self, times: list) -> list:
        """For each of the ascending ``times``, the innermost host op of
        the main thread open at it (host ops of one thread nest)."""
        host = sorted(self.host_ops, key=lambda e: (e[1], -e[2]))
        labels, stack, i = [], [], 0
        for t in times:
            while i < len(host) and host[i][1] <= t:
                while stack and stack[-1][2] < host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            labels.append(stack[-1][0][:NAME_CHARS] if stack
                          else "host: python between ops")
        return labels


def read_profile(prof, job: str, port_kernels: frozenset) -> Trace:
    """The traced units, their device ops, the host ops that launched
    device work (with that work's device time) and the host ops of the
    main thread."""
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    units = sorted((e.time_range.start, e.time_range.end)
                   for e in host if e.name == UNIT_RANGE)
    marks = sorted(e.time_range.start for e in host
                   if e.name == BACKWARD_RANGE)
    main = collections.Counter(e.thread for e in host
                               if e.name == UNIT_RANGE).most_common(1)
    main_thread = main[0][0] if main else None
    ops = [DeviceOp(e.name, e.time_range.start, e.time_range.end)
           for e in events if e.device_type == cuda
           and e.name not in (UNIT_RANGE, BACKWARD_RANGE)]
    launches = [(e.time_range.start, sum(k.duration for k in e.kernels))
                for e in host if e.kernels]
    host_ops = [(e.name, e.time_range.start, e.time_range.end) for e in host
                if e.thread == main_thread and e.name != UNIT_RANGE]
    if units:
        lo, hi = units[0][0], units[-1][1]
        ops = [op for op in ops if lo <= op.start and op.end <= hi]
    return Trace(job=job, units=units, ops=ops, port_kernels=port_kernels,
                 marks=marks, launches=launches, host_ops=host_ops)
