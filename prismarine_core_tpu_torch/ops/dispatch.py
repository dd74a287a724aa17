"""The one seam between each hand-written kernel and its plain version.

Every kernel wrapper of ``ops/`` hands ``choose`` its launch
(``launch_<kernel>``) and its plain version, the torch code the kernel
computes bit for bit; ``choose`` picks by the tensors' device.  The
surface's and the shading's wrappers go through ``fused``, which keeps a
gradient through a launch by differentiating the plain version run again
(``_Fused``).  A parity check runs the plain versions on the card by
replacing ``choose`` alone (``lambda x, launch, plain: plain``).
"""

from __future__ import annotations

import functools

import torch


def choose(x, launch, plain):
    """``launch`` when the tensor ``x`` lies on a CUDA card, else
    ``plain``."""
    return launch if x.device.type == "cuda" else plain


@functools.lru_cache(maxsize=None)
def bind(launch, plain, *args):
    """``launch`` and ``plain`` with their leading ``args`` bound: one pair
    a kind of work, so that the plain one keys ``_graphs``."""
    return functools.partial(launch, *args), functools.partial(plain, *args)


#: (plain version, inputs that require grad) -> which of its outputs
#: require grad
_graphs: dict = {}


def _graph(plain, needs: tuple, xs) -> tuple:
    """For each output of ``plain``, does it require grad when the inputs
    flagged in ``needs`` do?  Read once from a run on meta tensors of
    ``xs``' shapes."""
    key = (plain, needs)
    if key not in _graphs:
        ms = [torch.empty(x.shape, dtype=x.dtype, device="meta")
              .requires_grad_(nd) for x, nd in zip(xs, needs)]
        with torch.enable_grad():
            out = plain(*ms)
        _graphs[key] = tuple(y is not None and y.requires_grad for y in out)
    return _graphs[key]


class _Fused(torch.autograd.Function):
    """A kernel's outputs as a function of its tensor inputs: the forward
    is one ``launch``; the backward runs ``plain`` again on the saved
    inputs and differentiates it, so a gradient through the kernel is the
    plain version's.  An output the plain version would not
    differentiate stays out of the graph, so nothing downstream of it is
    differentiated either."""

    @staticmethod
    def forward(ctx, launch, plain, *xs):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*xs)
        ctx.plain = plain
        outs = launch(*xs)
        graph = _graph(plain, tuple(ctx.needs_input_grad[2:]), xs)
        ctx.mark_non_differentiable(*(
            y for y, g in zip(outs, graph) if y is not None and not g))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        xs = [x.detach().requires_grad_(nd)
              for x, nd in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            outs = ctx.plain(*xs)
        pairs = [(y, g) for y, g in zip(outs, grads)
                 if g is not None and y is not None and y.requires_grad]
        wanted = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(
            [y for y, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(wanted))
        return (None, None,
                *(next(got) if x.requires_grad else None for x in xs))


def fused(launch, plain, *xs):
    """``plain(*xs)``'s outputs (a tuple): on a card as ``launch(*xs)``
    computes them, differentiable as the plain version is (``_Fused``).
    ``plain`` keys a cache: the same function for the same work."""
    run = choose(xs[0], launch, plain)
    if run is plain or not (torch.is_grad_enabled()
                            and any(x.requires_grad for x in xs)):
        # the plain version, or nothing to differentiate: the launch
        # without autograd's bookkeeping
        return run(*xs)
    return _Fused.apply(run, plain, *xs)
