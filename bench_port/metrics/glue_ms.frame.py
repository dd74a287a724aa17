"""Device ms per traced frame of every device op that is not one of the
program's own CUDA kernels (``csrc/``): torch's elementwise ops,
reductions, gathers, sorts, copies."""


def read(trace):
    if trace.job != "frames" or not trace.ops:
        return None
    us = sum(op.end - op.start for op in trace.ops if not trace.is_port(op))
    return us / 1e3 / trace.n
