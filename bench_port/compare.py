"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each held to the limit its workload file states.

* Frames: ``mismatch_share``, the share of checked pixels where some
  channel of the program's radiance differs from the reference's by more
  than ``ATOL + RTOL * |reference|``.  A pixel's path is chaotic: a hit on
  the other side of an edge or a coin flipped by the last bit sends it
  elsewhere, so the number counts pixels and bounds their share; a
  systematic error in any layer moves nearly every pixel.
* Train: ``loss_gap``, the worst relative gap of the checked steps'
  losses; ``grad1_gap``, the worst leaf's gap between the norms of the
  first gradient as the update applies it, worked out from the
  parameters after one step ((p0 - p1) / (lr * lr_scale)); and
  ``change_gap``, the worst leaf's gap between the norms of the
  parameters' change over the checked steps (as the next step gets
  them).  A leaf's gap is
  |program's norm - reference's norm| over the larger of the reference's
  norm of that leaf and of the median leaf.  A leaf whose reference
  gradient norm is under ``NOUGHT`` of the median leaf's moves by
  round-off alone under a normalised step and is left out.
"""

from __future__ import annotations

import statistics

import torch

ATOL = RTOL = 1e-3
NOUGHT = 1e-3


def frames_numbers(got, want) -> dict:
    """got, want f32[P,3] on one device."""
    bad = ((got - want).abs() > ATOL + RTOL * want.abs()).any(-1)
    bad = bad | ~torch.isfinite(got).all(-1)
    return {"mismatch_share": float(bad.float().mean())}


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double().cpu()))


def _gap(prog: dict, ref: dict, leaves: list) -> float:
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves)


def train_numbers(prog: dict, ref: dict, train: dict) -> dict:
    """``prog`` / ``ref``: the losses of the checked steps and the
    parameters p0, p1 and pn (before them, after the first, after the
    last); ``ref`` also the raw gradients of its first step."""
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"])]
    gnorm = {k: _norm(g) for k, g in ref["grads1"].items()}
    med = statistics.median(gnorm.values())
    leaves = [k for k in gnorm if gnorm[k] >= NOUGHT * med]
    scale = train.get("lr_scale", {})

    def first_grad(side):
        return {k: _norm((side["p0"][k].cpu() - side["p1"][k].cpu())
                         / (train["lr"] * scale.get(k, 1.0)))
                for k in leaves}

    def change(side):
        return {k: _norm(side["pn"][k].cpu() - side["p0"][k].cpu())
                for k in leaves}
    return {"loss_gap": max(losses),
            "grad1_gap": _gap(first_grad(prog), first_grad(ref), leaves),
            "change_gap": _gap(change(prog), change(ref), leaves)}
