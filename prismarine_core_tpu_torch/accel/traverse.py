"""Stackless BVH traversal: the queries of ``intersector="bvh"``.

The counterpart of ``prismarine_core_tpu.accel.traverse``.  Every ray
walks the LBVH's left-child and skip (preorder escape) links from the
root: a slab test per node, a K-wide Moller-Trumbore test per intersected
leaf, no stack.  The walk itself is ``ops/bvh_walk.py:bvh_walk``: the
hand-written kernel ``csrc/bvh_walk.cu`` on the card, one lane per ray,
and the JAX package's lockstep walk in torch (``_traverse2``, the
kernel's plain version) on the CPU.  ``_traverse`` is the single-phase
lockstep walk, kept as the simplest statement of the same function.

Differentiability: the walk runs on detached inputs and yields only the
discrete slot; the chosen triangle's (t, u, v) are then re-evaluated from
the live soup (``packet._reeval_hit``), so gradients reach the vertices,
``o`` and ``d``.  The BVH only gates visibility.
"""

from __future__ import annotations

import dataclasses

import torch

from prismarine_core_tpu_torch.accel.lbvh import BVH
from prismarine_core_tpu_torch.accel.packet import _reeval_hit
from prismarine_core_tpu_torch.ops.bvh_walk import (
    bvh_walk, guarded_inv, leaf_test, slab)
from prismarine_core_tpu_torch.ops.bvh_walk import (  # noqa: F401
    bvh_walk_plain as _traverse2)
from prismarine_core_tpu_torch.ops.intersect import Hit, moller_trumbore
from prismarine_core_tpu_torch.ops.morton import morton30
from prismarine_core_tpu_torch.utils.config import INF_DIST, PZERO
from prismarine_core_tpu_torch.utils.profiling import span


def _traverse(bvh, o, d, t_cap, any_hit: bool):
    """Single-phase lockstep walk: every step pays the box test and the
    K-wide leaf test on all lanes.  Returns (t, slot, u, v) as
    ``_traverse2``."""
    r = o.shape[0]
    dev = o.device
    n = bvh.n_nodes
    first_leaf = bvh.first_leaf
    inv_d = guarded_inv(d)
    left, skip = bvh.left.long(), bvh.skip.long()
    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    bt = t_cap.to(torch.float32)
    bslot = torch.full((r,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((r,), dtype=torch.float32, device=dev)
    bv = torch.zeros((r,), dtype=torch.float32, device=dev)
    while bool((node < n).any()):
        active = node < n
        ni = torch.clamp(node, max=n - 1)
        tn, tf = slab(bvh.lo[ni], bvh.hi[ni], o, inv_d)
        box_hit = (tf >= torch.clamp(tn, min=PZERO)) & (tn < bt) & active
        is_leaf = ni >= first_leaf
        leaf = torch.clamp(ni - first_leaf, min=0)
        bt, bslot, bu, bv = leaf_test(bvh, o, d, leaf, is_leaf & box_hit,
                                      bt, bslot, bu, bv)
        nxt = torch.where(box_hit & ~is_leaf, left[ni], skip[ni])
        if any_hit:
            nxt = torch.where(bslot >= 0, n, nxt)   # out on the first hit
        node = torch.where(active, nxt, node)
    return bt, bslot, bu, bv


def _ray_sort_keys(bvh, o, d):
    """Coherence key (int64 holding a u32): 3-bit direction octant ++
    27-bit origin Morton code in the root box."""
    root_lo, root_hi = bvh.lo[0], bvh.hi[0]
    unit = torch.clamp((o - root_lo) / torch.clamp(root_hi - root_lo,
                                                   min=1e-6), 0.0, 1.0)
    m = morton30((unit * 511.0).to(torch.int64))    # 9 bits an axis
    octant = ((d[:, 0] >= 0).long() | ((d[:, 1] >= 0).long() << 1)
              | ((d[:, 2] >= 0).long() << 2))
    return (octant << 27) | m


def _run_traversal(bvh, o, d, t_cap, any_hit: bool, chunk: int = 0,
                   sort: bool = False):
    """The walk with an optional coherence sort of the rays (``sort``)
    and in optional chunks of ``chunk`` rays.  Returns (t f32[R],
    slot i32[R]) in the caller's ray order."""
    r = o.shape[0]
    if sort:
        with span("pc.sort"):
            perm = torch.sort(_ray_sort_keys(bvh, o, d), stable=True)[1]
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(r, device=perm.device)
        o, d, t_cap = o[perm], d[perm], t_cap[perm]
    o, d, t_cap = o.contiguous(), d.contiguous(), t_cap.contiguous()
    if chunk and r > chunk and r % chunk == 0:
        parts = [bvh_walk(bvh, o[i:i + chunk], d[i:i + chunk],
                          t_cap[i:i + chunk], any_hit)
                 for i in range(0, r, chunk)]
        t = torch.cat([p[0] for p in parts])
        slot = torch.cat([p[1] for p in parts])
    else:
        t, slot = bvh_walk(bvh, o, d, t_cap, any_hit)
    if sort:
        t, slot = t[inv], slot[inv]
    return t, slot


def _detached(bvh):
    return BVH(**{f.name: getattr(bvh, f.name).detach()
                  for f in dataclasses.fields(bvh)})


def intersect_closest_bvh(bvh, soup, o, d, chunk: int = 0,
                          sort: bool = False, t_cap=None) -> Hit:
    """Closest hit through the BVH; differentiable in the soup's vertices,
    ``o`` and ``d`` through the re-evaluation of the chosen triangle.
    ``t_cap`` f32[R] (optional, INF_DIST for every lane by default) is a
    per-lane far limit: only hits strictly below it count, and a lane
    whose cap is <= PZERO (a dead lane) ends at once with no hit."""
    if t_cap is None:
        t_cap = torch.full((o.shape[0],), INF_DIST, dtype=torch.float32,
                           device=o.device)
    else:
        t_cap = t_cap.detach().to(torch.float32)
    _, slot = _run_traversal(_detached(bvh), o.detach(), d.detach(), t_cap,
                             any_hit=False, chunk=chunk, sort=sort)
    return _reeval_hit(bvh, soup, o, d, slot)


def occluded_bvh(bvh, soup, o, d, t_max, chunk: int = 0,
                 sort: bool = False):
    """Any-hit query, each lane stopping at its first accepted hit: True
    where some triangle lies in (PZERO, t_max) (no gradient)."""
    _, slot = _run_traversal(_detached(bvh), o.detach(), d.detach(),
                             t_max.detach().to(torch.float32),
                             any_hit=True, chunk=chunk, sort=sort)
    return slot >= 0


def traversal_stats(bvh, o, d, t_cap=None, any_hit: bool = False) -> dict:
    """Tree-quality counts of the closest-hit walk (with ``any_hit``, of
    the walk that ends a ray at its first leaf with a hit), totals over
    all rays as Python ints: node steps, box tests passed, leaf visits."""
    r = o.shape[0]
    dev = o.device
    n = bvh.n_nodes
    first_leaf = bvh.first_leaf
    k = bvh.leaf_size
    if t_cap is None:
        t_cap = torch.full((r,), INF_DIST, dtype=torch.float32, device=dev)
    inv_d = guarded_inv(d)
    left, skip = bvh.left.long(), bvh.skip.long()
    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    bt = t_cap.to(torch.float32)
    counts = torch.zeros((3,), dtype=torch.int64, device=dev)
    while bool((node < n).any()):
        active = node < n
        ni = torch.clamp(node, max=n - 1)
        tn, tf = slab(bvh.lo[ni], bvh.hi[ni], o, inv_d)
        box_hit = (tf >= torch.clamp(tn, min=PZERO)) & (tn < bt) & active
        is_leaf = ni >= first_leaf
        leaf = torch.clamp(ni - first_leaf, min=0)
        slot = leaf[:, None] * k + torch.arange(k, device=dev)[None, :]
        tt, _, _, ok = moller_trumbore(o[:, None, :], d[:, None, :],
                                       bvh.tv0[slot], bvh.tv1[slot],
                                       bvh.tv2[slot])
        ok = ok & (bvh.orig[slot] >= 0) & (is_leaf & box_hit)[:, None]
        tt = torch.where(ok & (tt < bt[:, None]), tt, INF_DIST)
        # a leaf test takes a hit below bt, or any leaf at a cap above
        # INF_DIST (the plain walk's quirk: bt here is already INF_DIST)
        better = (((tt.amin(dim=1) < bt) | (t_cap > INF_DIST))
                  & is_leaf & box_hit)
        bt = torch.minimum(bt, tt.amin(dim=1))
        counts += torch.stack([active.sum(), box_hit.sum(),
                               (box_hit & is_leaf).sum()])
        nxt = torch.where(box_hit & ~is_leaf, left[ni], skip[ni])
        if any_hit:
            nxt = torch.where(better, n, nxt)
        node = torch.where(active, nxt, node)
    steps, box_pass, leaf_visits = counts.tolist()
    return {"steps": steps, "box_pass": box_pass, "leaf_visits": leaf_visits}
