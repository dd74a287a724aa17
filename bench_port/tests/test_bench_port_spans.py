"""The readers of the program's spans (``spans.py``, ``metrics/*``) on
hand-built traces with hand-computed values, and on a trace of a program
that opens no span."""

import pytest
import torch

from bench_port import harness, spans, trace
from bench_port.trace import DeviceOp, Trace

SPAN_METRICS = ("camera_ms.frame", "query_ms.frame", "surface_ms.frame",
                "shade_ms.frame", "query_idle_ms.frame",
                "program_syncs.frame")


def frame(t0):
    """One traced frame at ``t0`` us: (unit, host ranges, launches, device
    ops).  Launches (start, device us): camera 5; closest query 10 and
    the walk's raw launch 20; surface 7; NEE light sampling 3; shadow
    query 4; the carry 6; env 2; image 1; after the frame 8.  The
    profiler's "Command Buffer Full" inside the sort holds the sort's 10
    again.  Two declared syncs.  Device ops leave idle 0-5, 28-50 and
    90-100."""
    host = [("pc.frame", 1, 94), ("pc.camera", 2, 10), ("aten::add", 3, 4),
            ("pc.bounce", 11, 80), ("pc.query.closest", 12, 30),
            ("aten::sort", 13, 14), ("Command Buffer Full", 13.5, 13.9),
            ("pc.kernel.bvh_walk", 20, 21),
            ("pc.sync.compact", 25, 28), ("pc.surface", 31, 40),
            ("aten::index_select", 32, 33), ("pc.nee", 41, 60),
            ("aten::mul", 42, 43), ("pc.query.shadow", 45, 55),
            ("aten::where", 46, 47), ("pc.sync.compact", 47, 48),
            ("aten::add", 70, 71), ("pc.env", 81, 85), ("aten::mul", 82, 83),
            ("pc.image", 86, 90), ("aten::mean", 87, 88),
            ("aten::index_select", 95, 96)]
    launches = [(3, 5), (13, 10), (13.5, 10), (20, 20), (32, 7), (42, 3),
                (46, 4), (70, 6), (82, 2), (87, 1), (95, 8)]
    ops = [(5, 15), (14, 28), (50, 90)]
    return ((t0, t0 + 100),
            [(n, t0 + lo, t0 + hi) for n, lo, hi in host],
            [(t0 + s, us) for s, us in launches],
            [DeviceOp("k", t0 + lo, t0 + hi) for lo, hi in ops])


def hand_trace(job="frames", with_spans=True):
    """Two identical frames, 200 us apart."""
    parts = [frame(0), frame(200)]
    host = [h for p in parts for h in p[1]
            if with_spans or not h[0].startswith("pc.")]
    return Trace(job=job, units=[p[0] for p in parts],
                 ops=[op for p in parts for op in p[3]],
                 port_kernels=frozenset(),
                 launches=[la for p in parts for la in p[2]],
                 host_ops=host)


#: per frame: camera 5 us; queries 10 + 20 + 4; surface 7; shading the
#: rest of the bounce, 3 + 6; idle inside the queries 28-30 and 45-50
EXPECTED = {"camera_ms.frame": 0.005, "query_ms.frame": 0.034,
            "surface_ms.frame": 0.007, "shade_ms.frame": 0.009,
            "query_idle_ms.frame": 0.007, "program_syncs.frame": 2.0}


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_reader_on_a_hand_built_trace(metric):
    value = harness.metric_reader(metric)(hand_trace())
    assert value == pytest.approx(EXPECTED[metric], abs=1e-12)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_reader_finds_nothing_without_spans(metric):
    """The parent commit's program opens no span: nothing to read."""
    read = harness.metric_reader(metric)
    assert read(hand_trace(with_spans=False)) is None
    assert read(hand_trace(job="train")) is None


def test_frame_parts_add_up():
    """Camera, the bounces, env and image hold what the frame launched."""
    tr = hand_trace()
    parts = sum(spans.launched_ms_per_frame(tr, (n,)) for n in
                ("pc.camera", "pc.bounce", "pc.env", "pc.image"))
    assert parts == pytest.approx(
        spans.launched_ms_per_frame(tr, (spans.FRAME,)))
    assert parts == pytest.approx(0.058)


def test_span_report():
    """Each idle stretch goes to the innermost span at its middle, and
    beside it to the innermost host op there."""
    from bench_port import span_report
    r = span_report.report(hand_trace())
    assert r["idle_s"] == pytest.approx({
        "pc.camera": 10e-6, "pc.surface": 44e-6, "outside pc.frame": 20e-6})
    assert r["idle_s_by_host_op"] == pytest.approx({
        "pc.camera / pc.camera": 10e-6, "pc.surface / pc.surface": 44e-6,
        "outside pc.frame / aten::index_select": 20e-6})
    assert r["entered"]["pc.sync.compact"] == 2.0


def test_intervals():
    assert spans.union([(5, 6), (1, 3)], [(2, 4), (8, 9)]) == [
        (1, 4), (5, 6), (8, 9)]
    assert spans.covers([(1, 4), (8, 9)], 4)
    assert not spans.covers([(1, 4), (8, 9)], 5)
    tr = hand_trace()
    assert spans.spans(tr, "pc.sync.", prefix=True) == [
        (25, 28), (47, 48), (225, 228), (247, 248)]


def test_spans_of_a_real_profile():
    """The port's spans, profiled on the CPU, reach the readers through
    ``trace.read_profile``: two units, one declared sync a unit."""
    from torch.profiler import ProfilerActivity, profile
    from prismarine_core_tpu_torch.utils.profiling import span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with torch.profiler.record_function(trace.UNIT_RANGE):
                with span("pc.frame"), span("pc.sync.compact"):
                    torch.nonzero(torch.ones(4))
    tr = trace.read_profile(prof, "frames", frozenset())
    assert tr.n == 2
    assert harness.metric_reader("program_syncs.frame")(tr) == 1.0
    assert harness.metric_reader("camera_ms.frame")(tr) == 0.0
