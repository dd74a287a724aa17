"""The yardstick's roofline arithmetic: the card's peaks, the operations
and bytes each of the port's kernels needs for its inputs, and the least
time that allows.

Frozen copies of ``chip_smoke.py``'s ``bound``, ``FP32_PER_S`` /
``BYTES_PER_S``, ``SLAB_OPS`` / ``MT_OPS``, the ``sb_intersect`` bound
and the BVH walk's bound, and of ``accel/traverse.py:traversal_stats``
(the walk counter), so that a later change to the program cannot move
them.  Only the program's kernels' arguments and its BVH are read; no
kernel is called.
"""

from __future__ import annotations

import torch

from bench_port.reference.hits import moller_trumbore

#: NVIDIA H100 SXM data-sheet peaks at its 700 W limit: fp32 outside the
#: tensor cores, and HBM3 bandwidth
FP32_PER_S, BYTES_PER_S = 67e12, 3.35e12
#: fp32 operations of a ray-box slab test (6 sub, 6 mul, 11 min/max) and
#: of a Moller-Trumbore ray-triangle test (adds, subs, muls, the divide)
SLAB_OPS, MT_OPS = 23, 46
#: the walk's bytes: a walked ray reads o, d, t_cap and writes (t, slot);
#: a ray capped at or below PZERO reads t_cap and writes (t, slot); a node
#: record (lo, hi, left, skip); a triangle slot (three vertices, orig)
WALK_RAY_BYTES, WALK_DEAD_BYTES = 28 + 8, 4 + 8
WALK_NODE_BYTES, WALK_SLOT_BYTES = 32, 40
#: the pair intersector: a tile of 128 rays against a sub-block of 128
#: triangles per live sub-block; a ray row of 16 floats, (t, slot) out
TILE = BLOCK = 128
RAY_ROW_BYTES, RAY_OUT_BYTES = 16 * 4, 8
PZERO, INF_DIST = 0.0005, 10000.0
#: lockstep steps of the walk counter between two compactions
COUNT_UNROLL = 16


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of ``ops`` at the
    fp32 peak and ``nbytes`` at the memory rate, in seconds."""
    return max(ops / FP32_PER_S, nbytes / BYTES_PER_S)


def sb_intersect_work(pair_tile, pair_sb, pair_mask, n_real, rays, planes,
                      prior=None):
    """(ops, bytes, pairs) of one ``sb_intersect`` call from its
    arguments: a Moller-Trumbore test for every ray of a tile against
    every triangle of each live sub-block (the set bits of the real
    pairs' masks); every ray row, the pair list's three columns and the
    planes read once, (t, slot) written once."""
    n = int(n_real)
    mask = pair_mask[:n].to(torch.int64)
    bits = (mask[:, None] >> torch.arange(8, device=mask.device)) & 1
    n_sub = int(bits.sum())
    rows = rays.shape[0]
    nbytes = (rows * RAY_ROW_BYTES + 3 * n * 4 + planes.numel() * 4
              + rows * RAY_OUT_BYTES)
    return n_sub * TILE * BLOCK * MT_OPS, nbytes, n


def _inv(d):
    return 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d < 0, -1e-12, 1e-12), d)


def walk_counts(bvh, o, d, t_cap, any_hit: bool = False) -> dict:
    """Node steps, box tests passed and leaf visits of the skip-link walk
    over ``bvh`` (totals over the rays): every ray starts at the root, a
    node whose box it enters below its running best sends it to the left
    child (an inner node) or is a leaf visit (a K-wide test), and any
    other node to its skip link; with ``any_hit`` a ray ends at the first
    leaf with a hit.  Lanes that have ended are dropped from the lockstep
    every ``COUNT_UNROLL`` steps (the counts do not change)."""
    n = bvh.n_nodes
    first_leaf, k = bvh.first_leaf, bvh.leaf_size
    dev = o.device
    inv_d = _inv(d)
    left, skip = bvh.left.long(), bvh.skip.long()
    node = torch.zeros((o.shape[0],), dtype=torch.int64, device=dev)
    bt = t_cap.to(torch.float32).clone()
    counts = torch.zeros((3,), dtype=torch.int64, device=dev)
    lanes = torch.arange(k, device=dev)
    while node.numel():
        for _ in range(COUNT_UNROLL):
            active = node < n
            ni = torch.clamp(node, max=n - 1)
            t0 = (bvh.lo[ni] - o) * inv_d
            t1 = (bvh.hi[ni] - o) * inv_d
            tn = torch.minimum(t0, t1).amax(dim=-1)
            tf = torch.maximum(t0, t1).amin(dim=-1)
            box_hit = (tf >= torch.clamp(tn, min=PZERO)) & (tn < bt) & active
            is_leaf = ni >= first_leaf
            slot = torch.clamp(ni - first_leaf, min=0)[:, None] * k + lanes
            tt, _, _, ok = moller_trumbore(o[:, None, :], d[:, None, :],
                                           bvh.tv0[slot], bvh.tv1[slot],
                                           bvh.tv2[slot])
            ok = ok & (bvh.orig[slot] >= 0) & (is_leaf & box_hit)[:, None]
            tt = torch.where(ok & (tt < bt[:, None]), tt, INF_DIST)
            better = (tt.amin(dim=1) < bt) & is_leaf & box_hit
            bt = torch.minimum(bt, tt.amin(dim=1))
            counts += torch.stack([active.sum(), box_hit.sum(),
                                   (box_hit & is_leaf).sum()])
            nxt = torch.where(box_hit & ~is_leaf, left[ni], skip[ni])
            if any_hit:
                nxt = torch.where(better, n, nxt)
            node = torch.where(active, nxt, node)
        keep = node < n
        node, o, d, inv_d, bt = (node[keep], o[keep], d[keep], inv_d[keep],
                                 bt[keep])
    steps, box_pass, leaf_visits = counts.tolist()
    return {"steps": steps, "box_pass": box_pass, "leaf_visits": leaf_visits}


def walk_work(bvh, o, d, t_cap, any_hit: bool = False):
    """(ops, bytes) of one ``bvh_walk`` call: the counter's node steps
    (a slab test each) and leaf visits (K triangle tests each) over the
    lanes the walk walks (cap above PZERO); their rays and (t, slot), the
    other lanes' cap and (t, slot), and the tree read once."""
    walked = t_cap > PZERO
    c = walk_counts(bvh, o[walked], d[walked], t_cap[walked], any_hit)
    ops = SLAB_OPS * c["steps"] + MT_OPS * bvh.leaf_size * c["leaf_visits"]
    n_walked = int(walked.sum())
    nbytes = (n_walked * WALK_RAY_BYTES
              + (o.shape[0] - n_walked) * WALK_DEAD_BYTES
              + bvh.n_nodes * WALK_NODE_BYTES
              + bvh.tv0.shape[0] * WALK_SLOT_BYTES)
    return ops, nbytes
