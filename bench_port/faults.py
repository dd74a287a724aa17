"""Faults planted under the timed path, and the control, for showing that
the check fails them (``tests/test_bench_port_check.py`` on the CPU,
``calibrate.py`` on the card at the cells' own sizes).

Each fault is a context manager that swaps one of the program's module
attributes the timed path calls for a broken version, and puts it back:

* ``altered``: the image off by 1% where it is produced (frames; the train
  step's rendered image).
* ``half_batch``: half of the frame's rows left out (zero); in the train
  step, the loss's mean taken over the first half of the rows only.
* ``unchanged``: the state returned unchanged (frames: every frame the
  first frame's image; train: the parameters given back as they came).

There is no exchange between chips to leave out: every cell takes one.
"""

from __future__ import annotations

import contextlib

FRAME_FAULTS = ("altered", "half_batch", "unchanged")
TRAIN_FAULTS = ("altered", "half_batch", "unchanged")


@contextlib.contextmanager
def _swap(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def frame_fault(kind: str):
    """A broken ``render/integrator.py:render_with_samples``."""
    from prismarine_core_tpu_torch.render import integrator
    real = integrator.render_with_samples
    first = []

    def broken(*args, **kw):
        img = real(*args, **kw)
        if kind == "altered":
            return img * 1.01
        if kind == "half_batch":
            img = img.clone()
            img[img.shape[0] // 2:] = 0.0
            return img
        if kind == "unchanged":
            if not first:
                first.append(img)
            return first[0]
        raise ValueError(kind)
    return _swap(integrator, "render_with_samples", broken)


def train_fault(kind: str):
    """A broken train step (``parallel/mesh.py``)."""
    import torch
    from prismarine_core_tpu_torch.parallel import mesh
    if kind == "altered":
        real = mesh.render_with_samples
        return _swap(mesh, "render_with_samples",
                     lambda *a, **kw: real(*a, **kw) * 1.01)
    real_make = mesh.make_train_step

    def make(*args, **kw):
        step = real_make(*args, **kw)
        if kind == "unchanged":
            def unchanged(params, *a):
                _, loss = step(params, *a)
                return {k: v.detach() for k, v in params.items()}, loss
            return unchanged
        if kind != "half_batch":
            raise ValueError(kind)

        def half(params, scene, camera, cam_s, bounce_s, target):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            img = mesh.render_with_samples(
                mesh.apply_params(scene, leaves), camera, args[1], cam_s,
                bounce_s)
            rows = img.shape[0] // 2
            loss = torch.mean((img[:rows] - target[:rows]) ** 2)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            return step.update(params, grads), loss.detach()
        return half
    return _swap(mesh, "make_train_step", make)


def fault(job: str, kind: str):
    return frame_fault(kind) if job == "frames" else train_fault(kind)
