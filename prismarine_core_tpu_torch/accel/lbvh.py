"""Morton-ordered LBVH: the build (two topologies) and the refit.

The counterpart of ``prismarine_core_tpu.accel.lbvh``: scene bounds, 30-bit
Morton codes of triangle centroids, one stable sort, leaf AABBs over K-slot
runs, then the internal topology: "karras" (default), a binary radix tree
over the leaf clusters' first codes (every internal node finds its range
and split independently), escape links by pointer jumping and internal
boxes by a bottom-up fix-point union; or "median", the complete tree with
heap children, static skip links and level-by-level box unions.
``refit_bvh`` re-unions every box over a frozen topology after the
vertices moved.  All integer key work is int64 with 32-bit masks (torch
has no uint32); every result equals the JAX package's array for array.

N = 2L-1 nodes for L leaves of ``leaf_size`` slots: internal nodes
[0, L-1) (root 0), leaves [L-1, 2L-1); leaf j covers slots [jK, (j+1)K).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from prismarine_core_tpu_torch.ops.morton import morton30, quantize_unit

#: padding AABB placed "at infinity" — always misses the slab test
EMPTY_BOX = 1.0e30
#: key length bound (30 Morton bits + index tie-break bits): radix-tree
#: depth and fix-point pass bound
_MAX_DEPTH = 52
_KEY_MAX = 0xFFFFFFFF


@dataclasses.dataclass
class BVH:
    lo: torch.Tensor     # f32[N,3] node AABB min
    hi: torch.Tensor     # f32[N,3] node AABB max
    left: torch.Tensor   # i32[N] left child (-1 for leaves)
    skip: torch.Tensor   # i32[N] preorder escape link; N == done
    tv0: torch.Tensor    # f32[L*K,3] Morton-ordered triangle vertices
    tv1: torch.Tensor
    tv2: torch.Tensor
    orig: torch.Tensor   # i32[L*K] slot -> original triangle id (-1 pad)

    @property
    def n_nodes(self) -> int:
        return self.lo.shape[0]

    @property
    def n_leaves(self) -> int:
        return (self.n_nodes + 1) // 2

    @property
    def leaf_size(self) -> int:
        return self.tv0.shape[0] // self.n_leaves

    @property
    def first_leaf(self) -> int:
        return self.n_leaves - 1


def _heap_links(depth: int):
    """Left-child and escape links (numpy i32) of the heap-indexed
    complete tree of ``depth`` (topology "median"): the escape of a left
    child is its right sibling, of a right child its parent's escape, of
    the root N (done); leaves have no left child (-1)."""
    n = 2 ** (depth + 1) - 1
    skip = np.full(n, n, np.int32)
    left = np.full(n, -1, np.int32)
    for dd in range(depth):
        idx = np.arange(2 ** dd - 1, 2 ** (dd + 1) - 1)
        left[idx] = (2 * idx + 1).astype(np.int32)
        skip[2 * idx + 1] = (2 * idx + 2).astype(np.int32)
        skip[2 * idx + 2] = skip[idx]
    return left, skip


def _tree_depth(n_tris: int, leaf_size: int) -> int:
    n_leaves_needed = max(-(-n_tris // leaf_size), 1)
    depth = max(int(np.ceil(np.log2(n_leaves_needed))), 0)
    # total slots stay a multiple of 512 (the packet set's block view)
    min_depth = max(int(np.ceil(np.log2(512 / leaf_size))), 0)
    return max(depth, min_depth)


def _clz32(x):
    """Leading zeros of int64 values in [0, 2^32) (32 where x == 0)."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - s))
        n = n + torch.where(small, s, 0)
        x = torch.where(small, x << s, x)
    return torch.where(x == 0, 32, n)


def _karras_topology(codes):
    """Karras 2012 radix tree over sorted int64 ``codes`` [C]; returns
    (left, right) child ids per internal node i in [0, C-2] (ids >= C-1
    are leaves, leaf j = C-1 + j)."""
    c = codes.shape[0]
    dev = codes.device
    first_leaf = c - 1
    i = torch.arange(c - 1, dtype=torch.int64, device=dev)
    n_steps = int(np.ceil(np.log2(max(c, 2)))) + 1

    def delta(a, b):
        """Common-prefix length of keys (code ++ index); -1 out of range."""
        valid = (b >= 0) & (b < c)
        bc = torch.clamp(b, 0, c - 1)
        x = codes[a] ^ codes[bc]
        pref = torch.where(x == 0, 32 + _clz32(a ^ bc), _clz32(x))
        return torch.where(valid, pref, -1)

    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, 1, d)
    dmin = delta(i, i - d)

    lmax = torch.full_like(i, 2)
    grow = torch.ones_like(i, dtype=torch.bool)
    for _ in range(n_steps):
        grow = grow & (delta(i, i + lmax * d) > dmin)
        lmax = torch.where(grow, lmax * 2, lmax)

    l = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(n_steps + 1):
        cond = (t >= 1) & (delta(i, i + (l + t) * d) > dmin)
        l = torch.where(cond, l + t, l)
        t = t // 2
    j = i + l * d

    dnode = delta(i, j)
    s = torch.zeros_like(i)
    t = l
    done = torch.zeros_like(i, dtype=torch.bool)
    for _ in range(n_steps + 1):
        t = (t + 1) // 2
        cond = (~done) & (delta(i, i + (s + t) * d) > dnode)
        s = torch.where(cond, s + t, s)
        done = done | (t <= 1)
    gamma = i + s * d + torch.clamp(d, max=0)

    lo_end = torch.minimum(i, j)
    hi_end = torch.maximum(i, j)
    left = torch.where(lo_end == gamma, first_leaf + gamma, gamma)
    right = torch.where(hi_end == gamma + 1, first_leaf + gamma + 1,
                        gamma + 1)
    return left, right


def _escape_links(left, right, n_nodes):
    """Preorder escape links by pointer jumping: esc(x) = right sibling of
    the first ancestor-or-self that is a left child; N if none."""
    c1 = left.shape[0]
    dev = left.device
    idx = torch.arange(c1, dtype=torch.int64, device=dev)
    parent = torch.zeros((n_nodes,), dtype=torch.int64, device=dev)
    parent[left] = idx
    parent[right] = idx
    is_left = torch.zeros((n_nodes,), dtype=torch.bool, device=dev)
    is_left[left] = True

    nodes = torch.arange(n_nodes, dtype=torch.int64, device=dev)
    stop = is_left | (nodes == 0)
    f = torch.where(stop, nodes, parent)
    for _ in range(int(np.ceil(np.log2(_MAX_DEPTH))) + 2):
        f = f[f]
    sibling = right[torch.clamp(parent, 0, c1 - 1)]
    return torch.where(is_left[f], sibling[f], n_nodes).to(torch.int32)


def _fixpoint_boxes(kleft, kright, leaf_lo, leaf_hi, n_nodes, first_leaf):
    """Bottom-up fix-point AABB union over the radix-tree topology; stops
    one pass after nothing changes (one host read per pass, build time
    only)."""
    dev = leaf_lo.device
    lo = torch.full((n_nodes, 3), EMPTY_BOX, dtype=torch.float32, device=dev)
    hi = torch.full((n_nodes, 3), -EMPTY_BOX, dtype=torch.float32,
                    device=dev)
    lo[first_leaf:] = leaf_lo
    hi[first_leaf:] = leaf_hi
    for _ in range(_MAX_DEPTH):
        nlo = torch.minimum(lo[kleft], lo[kright])
        nhi = torch.maximum(hi[kleft], hi[kright])
        changed = bool(((nlo != lo[:first_leaf])
                        | (nhi != hi[:first_leaf])).any())
        lo[:first_leaf] = nlo
        hi[:first_leaf] = nhi
        if not changed:
            break
    return lo, hi


def _empty_to_far(lo, hi):
    """Inverted (empty) boxes would pass the slab test: far point boxes."""
    empty = (lo > hi).any(dim=-1, keepdim=True)
    return (torch.where(empty, EMPTY_BOX, lo),
            torch.where(empty, EMPTY_BOX, hi))


def _leaf_boxes(tv0, tv1, tv2, orig, n_leaves, leaf_size):
    """Leaf AABBs over K-slot runs; empty slots get the inverted box (the
    neutral element of the union)."""
    big = EMPTY_BOX
    svm = (orig >= 0)[:, None]
    slo = torch.where(svm, torch.minimum(torch.minimum(tv0, tv1), tv2), big)
    shi = torch.where(svm, torch.maximum(torch.maximum(tv0, tv1), tv2), -big)
    return (slo.reshape(n_leaves, leaf_size, 3).amin(dim=1),
            shi.reshape(n_leaves, leaf_size, 3).amax(dim=1))


def build_bvh(soup, leaf_size: int = 4, topology: str = "karras") -> BVH:
    """Build the BVH from a (padded) triangle soup, on the soup's device.
    ``topology``: "karras" (the radix tree) or "median" (the complete
    tree)."""
    if leaf_size & (leaf_size - 1):
        raise ValueError("leaf_size must be a power of two")
    if topology not in ("karras", "median"):
        raise ValueError(f"unknown topology {topology!r}")
    dev = soup.device
    t = soup.capacity
    depth = _tree_depth(t, leaf_size)
    n_leaves = 2 ** depth
    n_slots = n_leaves * leaf_size
    n_nodes = 2 * n_leaves - 1
    first_leaf = n_leaves - 1
    big = EMPTY_BOX

    # 1. scene bounds over valid centroids
    centroid = (soup.v0 + soup.v1 + soup.v2) / 3.0
    vmask = soup.valid[:, None]
    cmin = torch.where(vmask, centroid, big).amin(dim=0)
    cmax = torch.where(vmask, centroid, -big).amax(dim=0)
    extent = torch.clamp(cmax - cmin, min=1e-6)

    # 2. Morton codes (invalid triangles get the max key, sorting last),
    #    then one stable sort of (code, index)
    codes = morton30(quantize_unit((centroid - cmin) / extent))
    codes = torch.where(soup.valid, codes, _KEY_MAX)
    codes_sorted, order = torch.sort(codes, stable=True)

    # 3. reorder triangles into leaf slots (pad with zeros)
    m = min(t, n_slots)

    def scatter_pad(src):
        out = torch.zeros((n_slots, 3), dtype=src.dtype, device=dev)
        out[:m] = src[order][:n_slots]
        return out

    tv0, tv1, tv2 = (scatter_pad(v) for v in (soup.v0, soup.v1, soup.v2))
    orig = torch.full((n_slots,), -1, dtype=torch.int32, device=dev)
    orig[:m] = torch.where(soup.valid[order][:n_slots],
                           order[:n_slots].to(torch.int32), -1)

    leaf_lo, leaf_hi = _leaf_boxes(tv0, tv1, tv2, orig, n_leaves,
                                   leaf_size)

    if topology == "median":
        # 4. the complete tree: heap links, level-by-level unions
        left_np, skip_np = _heap_links(depth)
        left = torch.as_tensor(left_np, device=dev)
        skip = torch.as_tensor(skip_np, device=dev)
        lo = torch.full((n_nodes, 3), big, dtype=torch.float32, device=dev)
        hi = torch.full((n_nodes, 3), -big, dtype=torch.float32, device=dev)
        lo[first_leaf:] = leaf_lo
        hi[first_leaf:] = leaf_hi
        for dd in range(depth - 1, -1, -1):
            child = slice(2 ** (dd + 1) - 1, 2 ** (dd + 2) - 1)
            level = slice(2 ** dd - 1, 2 ** (dd + 1) - 1)
            lo[level] = lo[child].reshape(-1, 2, 3).amin(dim=1)
            hi[level] = hi[child].reshape(-1, 2, 3).amax(dim=1)
    else:
        # 4. radix tree over the leaf clusters' first codes
        slot_codes = torch.full((n_slots,), _KEY_MAX, dtype=torch.int64,
                                device=dev)
        slot_codes[:m] = codes_sorted[:n_slots]
        cluster_codes = slot_codes.reshape(n_leaves, leaf_size)[:, 0]
        kleft, kright = _karras_topology(cluster_codes)
        skip = _escape_links(kleft, kright, n_nodes)
        left = torch.cat([kleft.to(torch.int32),
                          torch.full((n_leaves,), -1, dtype=torch.int32,
                                     device=dev)])
        lo, hi = _fixpoint_boxes(kleft, kright, leaf_lo, leaf_hi, n_nodes,
                                 first_leaf)

    lo, hi = _empty_to_far(lo, hi)
    return BVH(lo=lo, hi=hi, left=left, skip=skip, tv0=tv0, tv1=tv1,
               tv2=tv2, orig=orig)


def refit_bvh(bvh: BVH, soup) -> BVH:
    """Re-union every AABB over the BVH's frozen topology after the soup's
    vertices moved (same triangle count and identity): the slots gather
    their triangles' new vertices, and the fix-point union runs with the
    Morton sort and the topology passes skipped.  Both topologies: the
    right child of internal node i is ``skip[left[i]]`` (a left child's
    escape is its right sibling)."""
    first_leaf, n_nodes = bvh.first_leaf, bvh.n_nodes
    trix = torch.clamp(bvh.orig, min=0).long()
    valid = (bvh.orig >= 0)[:, None]
    tv0, tv1, tv2 = (torch.where(valid, v[trix], 0.0)
                     for v in (soup.v0, soup.v1, soup.v2))
    leaf_lo, leaf_hi = _leaf_boxes(tv0, tv1, tv2, bvh.orig, bvh.n_leaves,
                                   bvh.leaf_size)
    if first_leaf > 0:
        kleft = bvh.left[:first_leaf].long()
        kright = bvh.skip[kleft].long()
        lo, hi = _fixpoint_boxes(kleft, kright, leaf_lo, leaf_hi, n_nodes,
                                 first_leaf)
    else:
        lo, hi = leaf_lo, leaf_hi
    lo, hi = _empty_to_far(lo, hi)
    return BVH(lo=lo, hi=hi, left=bvh.left, skip=bvh.skip, tv0=tv0, tv1=tv1,
               tv2=tv2, orig=bvh.orig)
