"""``surface_fused_share.frame`` on hand-built traces: the share of the
``pc.surface`` spans that hold a ``pc.kernel.surface`` span, and nothing
to read on a program that opens no such span."""

import pytest
import torch

from bench_port import harness, trace
from bench_port.trace import DeviceOp, Trace

READ = harness.metric_reader("surface_fused_share.frame")


def frame(t0, fused):
    """One traced frame at ``t0`` us with four bounces, each a
    ``pc.surface`` span; bounce b's holds a ``pc.kernel.surface`` span
    where ``fused[b]``.  A ``pc.kernel.bvh_walk`` span sits in each
    bounce outside the surface."""
    host = [("pc.frame", t0 + 1, t0 + 95)]
    for b in range(4):
        lo = t0 + 2 + 20 * b
        host += [("pc.bounce", lo, lo + 19),
                 ("pc.kernel.bvh_walk", lo + 1, lo + 2),
                 ("pc.surface", lo + 5, lo + 10)]
        if fused[b]:
            host.append(("pc.kernel.surface", lo + 7, lo + 8))
    return (t0, t0 + 100), host


def hand_trace(fused, job="frames", with_frame=True):
    """Two frames, 200 us apart, of the same bounces."""
    parts = [frame(0, fused), frame(200, fused)]
    host = [h for _, hs in parts for h in hs
            if with_frame or h[0] != "pc.frame"]
    return Trace(job=job, units=[u for u, _ in parts],
                 ops=[DeviceOp("k", 3, 90), DeviceOp("k", 203, 290)],
                 port_kernels=frozenset(), host_ops=host)


@pytest.mark.parametrize("fused, share", [
    ((True, True, True, True), 100.0), ((True, False, True, True), 75.0),
    ((False, True, False, False), 25.0)])
def test_share_of_fused_surfaces(fused, share):
    assert READ(hand_trace(fused)) == pytest.approx(share, abs=1e-12)


def test_nothing_to_read():
    """No ``pc.kernel.surface`` anywhere (the parent's program), no
    ``pc.frame``, or a train run: None."""
    assert READ(hand_trace((False,) * 4)) is None
    assert READ(hand_trace((True,) * 4, with_frame=False)) is None
    assert READ(hand_trace((True,) * 4, job="train")) is None


def test_share_of_a_real_profile():
    """The port's spans, profiled on the CPU, reach the reader through
    ``trace.read_profile``: one fused surface of two a unit."""
    from torch.profiler import ProfilerActivity, profile
    from prismarine_core_tpu_torch.utils.profiling import span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with torch.profiler.record_function(trace.UNIT_RANGE):
                with span("pc.frame"):
                    with span("pc.surface"), span("pc.kernel.surface"):
                        torch.ones(4).sum()
                    with span("pc.surface"):
                        torch.ones(4).sum()
    tr = trace.read_profile(prof, "frames", frozenset())
    assert tr.n == 2
    assert READ(tr) == 50.0
