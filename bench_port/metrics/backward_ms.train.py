"""Device ms per train step of what the backward and the update launch:
the device time of the kernels launched by every host op that started,
within a traced step, at or after the step's call of
``torch.autograd.grad`` (the harness marks it)."""


def read(trace):
    if trace.job != "train" or not trace.launches:
        return None
    total = 0.0
    for lo, hi in trace.units:
        mark = min((m for m in trace.marks if lo <= m <= hi), default=None)
        if mark is None:
            return None
        total += sum(us for start, us in trace.launches
                     if mark <= start <= hi)
    return total / 1e3 / trace.n
