"""Percent of the BVH walk's roofline over one frame: the least time its
inputs need (the walk counter's node steps and leaf visits of each call's
walked rays at the fp32 peak, or the call's bytes at the memory rate,
whichever is larger, summed over the calls of the last traced frame) over
the device time of every ``bvh_walk_kernel`` of that frame."""

from bench_port import roofline


def read(trace):
    calls = trace.calls.get("bvh_walk")
    if trace.job != "frames" or not calls:
        return None
    ops = [op for op in trace.unit_ops(trace.n - 1)
           if "bvh_walk_kernel" in op.name]
    busy = sum(op.seconds for op in ops)
    if busy <= 0:
        return None
    least = sum(roofline.bound_s(*roofline.walk_work(*a, **kw))
                for a, kw in calls)
    return 100.0 * least / busy
