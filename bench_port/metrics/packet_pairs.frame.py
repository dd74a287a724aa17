"""(tile, superblock) pairs handed to ``sb_intersect`` over one frame:
the real pairs of every call's list in the last traced frame."""

from bench_port import roofline


def read(trace):
    calls = trace.calls.get("sb_intersect")
    if trace.job != "frames" or not calls:
        return None
    return float(sum(roofline.sb_intersect_work(*a, **kw)[2]
                     for a, kw in calls))
