"""Percent of the pair intersector's roofline over one frame: the least
time its inputs need (every live sub-block's 128 x 128 ray-triangle
tests at the fp32 peak, or its bytes at the memory rate, whichever is
larger, summed over the calls of the last traced frame) over the device
time of every ``sb_intersect_*`` kernel of that frame."""

from bench_port import roofline


def read(trace):
    calls = trace.calls.get("sb_intersect")
    if trace.job != "frames" or not calls:
        return None
    ops = [op for op in trace.unit_ops(trace.n - 1)
           if "sb_intersect_" in op.name]
    busy = sum(op.seconds for op in ops)
    if busy <= 0:
        return None
    least = sum(roofline.bound_s(*roofline.sb_intersect_work(*a, **kw)[:2])
                for a, kw in calls)
    return 100.0 * least / busy
