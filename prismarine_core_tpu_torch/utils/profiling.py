"""Profiling and timing harness.

The counterpart of ``prismarine_core_tpu.utils.profiling``: the program's
spans (``span``) and their counts, a mean-time helper, and
``torch.profiler`` traces (a chrome trace in the log directory) for deep
dives.

A span names one phase of a frame (``pc.frame``, ``pc.camera``,
``pc.bounce``, ``pc.query.closest`` ...), one deliberate host sync
(``pc.sync.<site>``) or one launch of a hand-written kernel
(``pc.kernel.<name>``).  Every entry adds one to ``counts[name]``, which
is the port's one count of kernel launches and host syncs; only while a
profiler records does a span also open a profiler range, so the spans lie
on the profiler's clock beside the device's kernels and cost one counter
update and one check otherwise.  The range is an op-scope one
(``_RecordFunctionFast``), not ``record_function``'s user-scope one: the
profiler links the kernels launched directly inside it (the port's raw
launches) to it, and draws no device-side copy of it among the device's
ops.  To see them:

    with profiling.trace("logdir"):
        render(scene, camera, cfg, generator)

writes ``logdir/trace.json``, a chrome trace with the ``pc.*`` ranges.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
import time
from typing import Callable

import torch

#: entries of each span since the process started
counts: collections.Counter = collections.Counter()
#: what ``span`` returns while no profiler records
_NO_RANGE = contextlib.nullcontext()
#: the profiler range of a span: an op-scope range (see the module doc)
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """Context manager around one phase, sync or launch ``name``: counts
    it, and opens a profiler range while a profiler records.  Its parent
    is the span open around it."""
    counts[name] += 1
    if torch.autograd._profiler_enabled():
        return _range(name)
    return _NO_RANGE


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return run
    return wrap


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
    activity); the chrome trace, the program's ``pc.*`` spans beside the
    device's kernels, is written to ``logdir/trace.json``.  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
