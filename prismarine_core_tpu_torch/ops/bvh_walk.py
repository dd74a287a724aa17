"""The BVH walk: the kernel wrapper, its records and its plain version.

``bvh_walk`` answers a closest-hit or any-hit query over the LBVH's
left-child and skip links (``accel/lbvh.py``): per ray, the smallest t of a
triangle hit strictly below ``t_cap`` and its slot in the BVH's reordered
triangle arrays (-1 = none).  On a CUDA tensor it launches the
hand-written kernel ``csrc/bvh_walk.cu`` (persistent warps, each lane
walking one ray at a time over the skip links with no stack); on a CPU
tensor it runs ``bvh_walk_plain``.

The kernel reads the BVH as packed records (``pack_nodes``,
``pack_slots``): 32 bytes a node and 48 a triangle slot, the integer
fields stored as float bits, built here in torch from the BVH it is given
and kept for the last BVH walked (``walk_records``) under a key that sees
every source tensor's storage and version, so a refit or any in-place
change packs them anew.

The kernel is the port's own: the JAX package walks the BVH in XLA
(``prismarine_core_tpu/accel/traverse.py:_traverse2``), outside every
Pallas kernel.  ``bvh_walk_plain`` is that walk in torch, line for line:
every ray holds one node pointer, an inner loop advances the walking
lanes through box tests only until each is parked at an intersected leaf
(eight steps between host checks), then one K-wide Moller-Trumbore test
serves every parked lane, first minimum winning, strictly below the
running best.  The kernel computes the same (t, slot) bit for bit: each
ray visits the same nodes in the same order with the same running best.
"""

from __future__ import annotations

import torch

from prismarine_core_tpu_torch import _build
from prismarine_core_tpu_torch._build import check_tensor
from prismarine_core_tpu_torch.ops import dispatch
from prismarine_core_tpu_torch.ops.intersect import moller_trumbore
from prismarine_core_tpu_torch.utils.config import INF_DIST, PZERO
from prismarine_core_tpu_torch.utils.profiling import span

#: lockstep steps between two host checks of the plain walk
UNROLL = 8
#: int32 words of a packed node record (lo.xyz, link, hi.xyz, skip) and of
#: a packed slot record (v0.xyz, orig, v1.xyz, 0, v2.xyz, 0)
NODE_WORDS, SLOT_WORDS = 8, 12


def guarded_inv(d):
    """1 / d with |d| < 1e-12 replaced by +-1e-12 (the walk's ``inv_d``)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d < 0, -1e-12, 1e-12), d)


def slab(lo, hi, o, inv_d):
    """(tn, tf) of each ray against its box: the largest entry and the
    smallest exit distance over the three slabs."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    return (torch.minimum(t0, t1).amax(dim=-1),
            torch.maximum(t0, t1).amin(dim=-1))


def leaf_test(bvh, o, d, leaf, has_leaf, bt, bslot, bu, bv):
    """The K-wide triangle test of each lane's leaf (lanes without one
    test nothing): the first minimum of the hits strictly below ``bt``
    replaces the running best.  Returns (bt, bslot, bu, bv)."""
    k = bvh.leaf_size
    rows = torch.arange(o.shape[0], device=o.device)
    slot = leaf[:, None] * k + torch.arange(k, device=o.device)[None, :]
    tt, tu, tv, ok = moller_trumbore(o[:, None, :], d[:, None, :],
                                     bvh.tv0[slot], bvh.tv1[slot],
                                     bvh.tv2[slot])
    ok = ok & (bvh.orig[slot] >= 0) & has_leaf[:, None]
    tt = torch.where(ok & (tt < bt[:, None]), tt, INF_DIST)
    j = torch.argmin(tt, dim=1)
    tj = tt[rows, j]
    better = tj < bt
    return (torch.where(better, tj, bt),
            torch.where(better, slot[rows, j], bslot),
            torch.where(better, tu[rows, j], bu),
            torch.where(better, tv[rows, j], bv))


def bvh_walk_plain(bvh, o, d, t_cap, any_hit: bool = False):
    """The two-phase lockstep walk (``traverse.py:_traverse2`` of the JAX
    package).  Returns (t f32[R], slot i64[R], u f32[R], v f32[R])."""
    r = o.shape[0]
    dev = o.device
    n = bvh.n_nodes
    first_leaf = bvh.first_leaf
    inv_d = guarded_inv(d)
    left, skip = bvh.left.long(), bvh.skip.long()

    def walk_step(node, parked, bt):
        walking = (node < n) & (parked < 0)
        ni = torch.clamp(node, max=n - 1)
        tn, tf = slab(bvh.lo[ni], bvh.hi[ni], o, inv_d)
        box_hit = (tf >= torch.clamp(tn, min=PZERO)) & (tn < bt)
        is_leaf = ni >= first_leaf
        parked = torch.where(walking & box_hit & is_leaf, ni, parked)
        nxt = torch.where(box_hit & ~is_leaf, left[ni], skip[ni])
        return torch.where(walking, nxt, node), parked  # parked pre-advance

    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    parked = torch.full((r,), -1, dtype=torch.int64, device=dev)
    bt = t_cap.to(torch.float32)
    bslot = torch.full((r,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((r,), dtype=torch.float32, device=dev)
    bv = torch.zeros((r,), dtype=torch.float32, device=dev)
    while bool(((node < n) | (parked >= 0)).any()):
        while bool(((node < n) & (parked < 0)).any()):
            for _ in range(UNROLL):
                node, parked = walk_step(node, parked, bt)
        has_leaf = parked >= 0
        leaf = torch.where(has_leaf, parked - first_leaf, 0)
        bt, bslot, bu, bv = leaf_test(bvh, o, d, leaf, has_leaf, bt, bslot,
                                      bu, bv)
        parked = torch.full_like(parked, -1)
        if any_hit:
            node = torch.where(bslot >= 0, n, node)
    return bt, bslot, bu, bv


def bvh_walk_plain_hits(bvh, o, d, t_cap, any_hit: bool = False):
    """``bvh_walk_plain`` with the kernel's return, (t f32[R], slot
    i32[R]): the walk's plain version."""
    t, slot, _, _ = bvh_walk_plain(bvh, o, d, t_cap, any_hit)
    return t, slot.to(torch.int32)


def pack_nodes(bvh):
    """The kernel's node records, i32[N, 8]: (lo.xyz, link, hi.xyz, skip)
    with lo and hi as their float bits; ``link`` is the left child of an
    internal node and ~(first slot) = -(leaf * K) - 1 of a leaf (a node
    at or past ``first_leaf``, as the plain walk tells them)."""
    node = torch.arange(bvh.n_nodes, dtype=torch.int32,
                        device=bvh.lo.device)
    leaf = node - bvh.first_leaf
    link = torch.where(leaf >= 0, ~(leaf * bvh.leaf_size),
                       bvh.left.to(torch.int32))
    return torch.cat([bvh.lo.contiguous().view(torch.int32), link[:, None],
                      bvh.hi.contiguous().view(torch.int32),
                      bvh.skip.to(torch.int32)[:, None]], dim=1)


def pack_slots(bvh):
    """The kernel's slot records, i32[L*K, 12]: (v0.xyz, orig, v1.xyz, 0,
    v2.xyz, 0) with the vertices as their float bits, a leaf's K slots
    one after another."""
    zero = torch.zeros((bvh.tv0.shape[0], 1), dtype=torch.int32,
                       device=bvh.tv0.device)
    return torch.cat([bvh.tv0.contiguous().view(torch.int32),
                      bvh.orig.to(torch.int32)[:, None],
                      bvh.tv1.contiguous().view(torch.int32), zero,
                      bvh.tv2.contiguous().view(torch.int32), zero], dim=1)


#: the packed records of the last BVH walked
_records = _build.Records()


def walk_records(bvh):
    """(nodes, slots) of ``bvh``, packed at the first call and then reused
    while every source tensor keeps its storage, layout and version
    (``_build.Records``)."""
    return _records.get((bvh.lo, bvh.hi, bvh.left, bvh.skip, bvh.tv0,
                         bvh.tv1, bvh.tv2, bvh.orig),
                        lambda: (pack_nodes(bvh), pack_slots(bvh)))


def launch_bvh_walk(bvh, o, d, t_cap, any_hit: bool = False):
    """``bvh_walk_plain_hits``'s (t, slot) from one launch of
    ``csrc/bvh_walk.cu`` on the BVH's packed records."""
    dev = o.device
    r, n, s = o.shape[0], bvh.n_nodes, bvh.tv0.shape[0]
    for name, t, dtype, shape in (
            ("o", o, torch.float32, (r, 3)), ("d", d, torch.float32, (r, 3)),
            ("t_cap", t_cap, torch.float32, (r,)),
            ("bvh.lo", bvh.lo, torch.float32, (n, 3)),
            ("bvh.hi", bvh.hi, torch.float32, (n, 3)),
            ("bvh.left", bvh.left, torch.int32, (n,)),
            ("bvh.skip", bvh.skip, torch.int32, (n,)),
            ("bvh.tv0", bvh.tv0, torch.float32, (s, 3)),
            ("bvh.tv1", bvh.tv1, torch.float32, (s, 3)),
            ("bvh.tv2", bvh.tv2, torch.float32, (s, 3)),
            ("bvh.orig", bvh.orig, torch.int32, (s,))):
        check_tensor(t, dtype, shape, name, dev)
    if s != bvh.n_leaves * bvh.leaf_size:
        raise ValueError(f"{s} slots for {bvh.n_leaves} leaves")
    out_t = torch.empty((r,), dtype=torch.float32, device=dev)
    out_slot = torch.empty((r,), dtype=torch.int32, device=dev)
    if r == 0:
        return out_t, out_slot
    nodes, slots = walk_records(bvh)
    next_ray = torch.zeros((1,), dtype=torch.int32, device=dev)
    with span("pc.kernel.bvh_walk"):
        code = _build.library().bvh_walk_launch(
            nodes.data_ptr(), slots.data_ptr(), o.data_ptr(), d.data_ptr(),
            t_cap.data_ptr(), out_t.data_ptr(), out_slot.data_ptr(),
            next_ray.data_ptr(), r, n, bvh.leaf_size, int(any_hit),
            _build.stream_ptr(dev))
    _build.check(code, "bvh_walk_launch")
    return out_t, out_slot


def bvh_walk(bvh, o, d, t_cap, any_hit: bool = False):
    """Closest (or, with ``any_hit``, first accepted) hit per ray: ``o``,
    ``d`` f32[R,3], ``t_cap`` f32[R] (only t strictly below it counts).
    Returns (t f32[R], slot i32[R]); t is t_cap where there is no hit.
    CUDA tensors launch ``csrc/bvh_walk.cu`` on the BVH's packed records
    (``launch_bvh_walk``), CPU tensors run ``bvh_walk_plain_hits``
    (``ops/dispatch.py`` chooses)."""
    return dispatch.choose(o, launch_bvh_walk, bvh_walk_plain_hits)(
        bvh, o, d, t_cap, any_hit)
