"""Profiling and timing harness.

The counterpart of ``prismarine_core_tpu.utils.profiling``: wall timers
per stage that synchronise the device of a given tensor before they stop,
a mean-time helper, and ``torch.profiler`` traces (a chrome trace in the
log directory) for deep dives.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable

import torch


def _sync(x) -> None:
    """Wait for the device work that produced ``x`` (a tensor, or a
    tuple/list/dict of them); a CPU tensor needs no wait."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _sync(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _sync(v)


class StageTimers:
    """Accumulating per-stage wall timers (device-synced)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time the block; ``sync`` (a tensor or a container of them) is
        waited for before the clock stops."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _sync(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total*1e3:9.1f} ms total  "
                         f"{total/n*1e3:8.2f} ms/call  x{n}")
        return "\n".join(lines)


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3,
            **kw) -> float:
    """Mean seconds per call after ``warmup`` warm calls (the last
    result waited for inside the timed region)."""
    for _ in range(warmup):
        _sync(fn(*args, **kw))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args, **kw)
    _sync(out)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (CPU and, with a card, CUDA
    activity); the chrome trace is written to ``logdir/trace.json``.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
