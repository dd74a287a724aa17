"""Device ops per traced frame that are not the program's own CUDA
kernels."""


def read(trace):
    if trace.job != "frames" or not trace.ops:
        return None
    return sum(not trace.is_port(op) for op in trace.ops) / trace.n
