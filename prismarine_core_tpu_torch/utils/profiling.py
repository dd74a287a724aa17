"""Profiling and timing harness.

The counterpart of ``prismarine_core_tpu.utils.profiling``: wall timers
per stage that synchronise the device of a given tensor before they stop,
a mean-time helper, and ``torch.profiler`` traces (a chrome trace in the
log directory) for deep dives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Callable

import torch


def _tensors(x):
    """The tensors in ``x``: a tensor, or a tuple/list/dict or dataclass
    of them (nested)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def _cuda_devices(x) -> set:
    return {t.device for t in _tensors(x) if t.device.type == "cuda"}


def wait_for(x) -> None:
    """Wait for the device work that produced ``x`` (a tensor, or a
    tuple/list/dict or dataclass of them); a CPU tensor needs no wait."""
    for device in _cuda_devices(x):
        torch.cuda.synchronize(device)


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
            wait_for(sync)
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
    """Mean seconds per call after ``warmup`` warm calls.  Each call is
    waited for (``wait_for`` of its result) before its clock stops: it runs
    between two CUDA events when the warm result lies on the card, and
    under the host clock otherwise."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
        wait_for(out)
    on_card = bool(_cuda_devices(out))
    total = 0.0
    for _ in range(iters):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            wait_for(out)
            end.synchronize()
            total += 1e-3 * start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            wait_for(fn(*args, **kw))
            total += time.perf_counter() - t0
    return total / iters


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
