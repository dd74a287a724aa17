"""Packet (ray tile x triangle superblock) queries on the hand-written kernels.

The counterpart of ``prismarine_core_tpu.accel.packet``: its
``intersector="pallas"`` query with every cull, sort and strategy knob, and
its ``intersector="packet"`` query.

1. rays sort by a coherence key (dead lanes last) and form tiles of 128;
   the kernel ray matrix is built unsorted and permuted with one row
   gather, then padded with dead rays and one all-zero sentinel tile;
   ``sort_mode`` "packed" sorts the key's top bits with the ray index in
   its low bits, "group" sorts 16-ray groups by their live centroid's key,
   and ``order="identity"`` skips the sort and the gather;
2. the BVH's Morton-sorted triangle slots form blocks of 128 and
   superblocks of 8 blocks, with AABBs and SoA planes (``PacketSet``);
3. ``block_cull`` gives every (tile, block) entry distance ("pallas", the
   default: ``derive_pair_tables`` turns them into superblock candidates,
   their least block distance and 8-bit block masks) or every (tile,
   superblock) entry distance ("pallas2" and "xla": the JAX package's XLA
   stages ``_per_ray_tile_overlap`` and ``_block_masks`` compute the
   functions of ``block_cull`` over the superblock rows and of
   ``pair_cull``);
4. candidate pairs compact tile-major (``compact_pairs``), each takes its
   8-bit block mask from the table ("pallas") or from ``pair_cull``
   ("pallas2", "xla", and the refreshed rounds of "rounds"), and the pair
   intersector of the chosen ``kernel_form`` runs the Moller-Trumbore of
   every live sub-block, keeping per-ray closest hits, all three forms on
   one balanced walk: "mt" (``sb_intersect``), "mt2" (``sb_intersect_mt2``,
   two sub-blocks of a tile a stage, the same result bit for bit) or
   "mxu" (``sb_intersect_mxu`` on coefficient planes built per query by
   ``mxu_planes_from_planes``);
5. "two_round" (the closest-hit default): each tile's K nearest
   superblocks first (or, with ``near_frac``, those whose entry distance
   lies within that fraction of the tile's candidate range), then one
   re-cull of the rest under the tightened caps (``recull``); "rounds"
   (the any-hit default): every tile's candidates front to back, K a
   round, each round's block masks refreshed under the caps so far, until
   no tile's next candidate can beat its cap; "single": every candidate
   pair at once.

``intersector="packet"`` (``_run_packet``) culls each tile's frustum, the
intervals of its rays' origins and inverse directions, against every block
box (``_interval_overlap``) and runs every overlapping block through
``sb_intersect`` in one "single" pass.

The JAX path pads pair lists to static lengths, aligns them to the TPU
kernel's pairs-per-step and runs them in while-loop windows (its
``_compact_*`` helpers are TPU-aligned layouts of ``compact_pairs``'s
function); here lists have their exact length (``nonzero``, one host sync
per compaction, the span ``pc.sync.compact``) and each runs in
one launch per kernel.  No gradient flows through the query: the entry
points detach every query input (the JAX package's ``stop_gradient``),
and ``_reeval_hit`` re-evaluates the winning triangle differentiably from
the soup and the caller's ``o`` and ``d``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from prismarine_core_tpu_torch.accel.lbvh import EMPTY_BOX
from prismarine_core_tpu_torch.ops.cull import (
    block_cull, box_rows_from_blocks, derive_pair_tables, pair_cull,
    sb_box_table)
from prismarine_core_tpu_torch.ops.intersect import Hit, moller_trumbore
from prismarine_core_tpu_torch.ops.morton import morton30
from prismarine_core_tpu_torch.ops.sb_intersect import (
    BLOCK, RAY_COLS, RC_CX, RC_ONE, RC_TCAP, SB, TILE,
    mxu_planes_from_planes, sb_intersect, sb_intersect_mt2,
    sb_intersect_mxu)
from prismarine_core_tpu_torch.utils.config import INF_DIST, check_query_knobs
from prismarine_core_tpu_torch.utils.math import cross, safe_rcp, take_rows
from prismarine_core_tpu_torch.utils.profiling import span, spanned

#: default per-round budget of "two_round" and "rounds": each tile's K
#: nearest (remaining) superblocks a round
K_FIRST = 8


@dataclasses.dataclass
class PacketSet:
    """Block/superblock view over the BVH's Morton-sorted slots."""

    block_lo: torch.Tensor  # f32[B,3]
    block_hi: torch.Tensor  # f32[B,3]
    sb_lo: torch.Tensor     # f32[B/SB,3]
    sb_hi: torch.Tensor     # f32[B/SB,3]
    #: f32[B/SB + 1, 16, SB*BLOCK] rows v0xyz, e1xyz, e2xyz, valid, 0...;
    #: sub-block k on lanes [128k, 128k+128); the trailing superblock is
    #: all zero (valid = 0)
    planes: torch.Tensor
    slot_orig: torch.Tensor  # i32[B*BLOCK] slot -> original triangle id

    @property
    def n_blocks(self) -> int:
        return self.block_lo.shape[0]

    @property
    def n_superblocks(self) -> int:
        return self.sb_lo.shape[0]


def build_packet_set(bvh) -> PacketSet:
    """Block/superblock AABBs + SoA triangle planes."""
    s = bvh.tv0.shape[0]
    if s % BLOCK:
        raise ValueError("slot count must be a multiple of BLOCK")
    nb = -(-(s // BLOCK) // SB) * SB
    nsb = nb // SB
    pad = nb * BLOCK - s
    big = EMPTY_BOX

    def padded(a, fill=0.0):
        if not pad:
            return a
        tail = torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, tail])

    tv0, tv1, tv2 = (padded(v) for v in (bvh.tv0, bvh.tv1, bvh.tv2))
    orig = padded(bvh.orig, -1)
    valid = (orig >= 0)[:, None]
    slo = torch.where(valid, torch.minimum(torch.minimum(tv0, tv1), tv2), big)
    shi = torch.where(valid, torch.maximum(torch.maximum(tv0, tv1), tv2),
                      -big)
    block_lo = slo.reshape(nb, BLOCK, 3).amin(dim=1)
    block_hi = shi.reshape(nb, BLOCK, 3).amax(dim=1)
    empty = (block_lo > block_hi).any(dim=-1, keepdim=True)
    block_lo = torch.where(empty, big, block_lo)
    block_hi = torch.where(empty, big, block_hi)
    sb_lo = block_lo.reshape(nsb, SB, 3).amin(dim=1)
    sb_hi = block_hi.reshape(nsb, SB, 3).amax(dim=1)

    e1 = tv1 - tv0
    e2 = tv2 - tv0
    rows = [tv0[:, 0], tv0[:, 1], tv0[:, 2], e1[:, 0], e1[:, 1], e1[:, 2],
            e2[:, 0], e2[:, 1], e2[:, 2], (orig >= 0).to(torch.float32)]
    rows += [torch.zeros_like(rows[0])] * (16 - len(rows))
    planes = torch.stack([x.reshape(nb, BLOCK) for x in rows], dim=1)
    planes = planes.reshape(nsb, SB, 16, BLOCK).transpose(1, 2)
    planes = planes.reshape(nsb, 16, SB * BLOCK)
    planes = torch.cat([planes, torch.zeros((1, 16, SB * BLOCK),
                                            dtype=torch.float32,
                                            device=planes.device)])
    return PacketSet(block_lo=block_lo, block_hi=block_hi, sb_lo=sb_lo,
                     sb_hi=sb_hi, planes=planes.contiguous(),
                     slot_orig=orig)


#: safe_rcp(0.0) in float32
_INV_EPS = float(np.float32(1.0) / np.float32(1e-12))


def _live_tile_bound(tct):
    """i32 scalar: 1 + index of the last tile holding a live lane (dead
    lanes sort last, so this is the live-tile prefix)."""
    live_t = (tct > 0.0).any(dim=1)
    idx = torch.arange(1, live_t.shape[0] + 1, device=tct.device)
    return torch.where(live_t, idx, 0).amax().to(torch.int32)


def _ray_sort_keys(root_lo, root_hi, o, d, t_cap=None):
    """Coherence key (int64 holding a u32): dead(1b) ++ octant(3b) ++
    origin Morton(15b) ++ direction Morton(12b); dead lanes (t_cap == 0)
    sort last."""
    unit = torch.clamp((o - root_lo) / torch.clamp(root_hi - root_lo,
                                                   min=1e-6), 0.0, 1.0)
    om = morton30((unit * 31.0).to(torch.int64))
    dm = morton30((torch.abs(d) * 15.0).to(torch.int64))
    octant = ((d[:, 0] >= 0).long() | ((d[:, 1] >= 0).long() << 1)
              | ((d[:, 2] >= 0).long() << 2))
    keys = (octant << 27) | (om << 12) | (dm & 0xFFF)
    if t_cap is not None:
        keys = keys | ((t_cap <= 0.0).long() << 31)
    return keys


def _coherence_perm(root_lo, root_hi, o, d, t_cap, mode: str = "full"):
    """(perm, inv_perm) of the coherence sort (stable sorts, as the JAX
    package's).  ``mode``: "full" sorts the whole key; "packed" sorts one
    word, the key's top ``32 - ceil(log2 R)`` bits over the ray index;
    "group" sorts 16-ray groups by the key of their live lanes' centroid
    (when R is a multiple of 16 and at least 2,048, else "full")."""
    r = o.shape[0]
    dev = o.device
    iota = torch.arange(r, device=dev)
    if mode == "group" and r % 16 == 0 and r >= 2048:
        g = 16
        ng = r // g
        live = t_cap.reshape(ng, g) > 0.0
        cnt = live.sum(dim=1)
        w = live[:, :, None].to(torch.float32)
        denom = torch.clamp(cnt, min=1).to(torch.float32)[:, None]
        oc = (o.reshape(ng, g, 3) * w).sum(dim=1) / denom
        dc = (d.reshape(ng, g, 3) * w).sum(dim=1) / denom
        keys_g = _ray_sort_keys(root_lo, root_hi, oc, dc,
                                torch.where(cnt > 0, 1.0, 0.0))
        perm_g = torch.sort(keys_g, stable=True)[1]
        perm = (perm_g[:, None] * g
                + torch.arange(g, device=dev)[None, :]).reshape(-1)
    elif mode == "packed":
        keys = _ray_sort_keys(root_lo, root_hi, o, d, t_cap)
        idx_bits = max(1, (r - 1).bit_length())
        packed = ((keys >> idx_bits) << idx_bits) | iota
        perm = torch.sort(packed)[0] & ((1 << idx_bits) - 1)
    else:
        keys = _ray_sort_keys(root_lo, root_hi, o, d, t_cap)
        perm = torch.sort(keys, stable=True)[1]
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = iota
    return perm, inv_perm


def _sorted_rays_matrix(root_lo, root_hi, o, d, t_cap, order=None,
                        mode: str = "full"):
    """Kernel ray matrix f32[(nt+1)*TILE, 16] in coherence order (columns
    o, d, t_cap, 1, inv d, c = (o - center) x d with center the middle of
    the root box; the last two feed only the "mxu" form), padded with
    dead rays (o = (0, 0, 1e8), d = (1, 0, 0), t_cap = 0, the constant
    and c columns 0) to a tile multiple plus one all-zero sentinel tile.
    ``order``: a (perm, inv_perm) to reuse, None to sort by ``mode``, or
    "identity": the caller's order, with no sort and no row gather (it is
    returned as given, so a shadow query reusing it skips them too).
    Returns (rays, order, n_rays)."""
    r = o.shape[0]
    dev = o.device
    identity = isinstance(order, str)
    if identity and order != "identity":
        raise ValueError(f"order={order!r}: a (perm, inv_perm) pair, None "
                         "or 'identity'")
    if order is None:
        with span("pc.sort"):
            order = _coherence_perm(root_lo, root_hi, o, d, t_cap, mode)
    nt = -(-r // TILE)
    rays = torch.zeros(((nt + 1) * TILE, RAY_COLS), dtype=torch.float32,
                       device=dev)
    cols = rays[:r] if identity else torch.zeros(
        (r, RAY_COLS), dtype=torch.float32, device=dev)
    cols[:, 0:3] = o
    cols[:, 3:6] = d
    cols[:, RC_TCAP] = t_cap
    cols[:, 8:11] = safe_rcp(d)
    cols[:, RC_ONE] = 1.0
    cols[:, RC_CX:RC_CX + 3] = cross(o - 0.5 * (root_lo + root_hi), d)
    if not identity:
        rays[:r] = cols[order[0]]               # the one row gather
    dead = rays[r:nt * TILE]
    dead[:, 2] = 1e8
    dead[:, 3] = 1.0
    dead[:, 8] = 1.0                            # safe_rcp((1, 0, 0)),
    dead[:, 9:11] = _INV_EPS                    # without a host copy
    return rays, order, r


def _unsorted(x, r: int, order):
    """Rows ``[:r]`` of a per-row kernel result in the caller's order."""
    return x[:r] if isinstance(order, str) else x[:r][order[1]]


def compact_pairs(mask, cols=None):
    """Tile-major pair list of a [nt, n] candidate mask: (pair_tile,
    pair_sb, n_real) as i32 tensors, in row-major order of the mask.  The
    superblock of entry (t, c) is ``c``, or ``cols[t, c]`` when given
    (the round-1 top-K table).  ``torch.nonzero`` sizes the list: one
    host sync, the span ``pc.sync.compact``."""
    n_real = mask.sum().to(torch.int32)
    with span("pc.sync.compact"):
        idx = torch.nonzero(mask.reshape(-1))[:, 0]
    width = mask.shape[1]
    pair_tile = (idx // width).to(torch.int32)
    if cols is None:
        pair_sb = (idx % width).to(torch.int32)
    else:
        pair_sb = cols.reshape(-1)[idx].to(torch.int32)
    return pair_tile, pair_sb, n_real


def _per_ray_tile_overlap(ot, inv, tct, box_lo, box_hi, chunk: int = 32,
                          return_tn: bool = False):
    """Per (tile, box): does some live ray of the tile pass the box's slab
    test under its cap (bool[nt, nbx]); with ``return_tn`` also the least
    entry distance over those rays (f32[nt, nbx], INF_DIST where none).
    The plain torch counterpart of the JAX package's
    ``accel/packet.py:_per_ray_tile_overlap``, ``chunk`` tiles at a time:
    ``block_cull``'s predicate, so the "sb" recull computes it as
    ``block_cull(...) < INF_DIST`` on the kernel."""
    nt, nbx = ot.shape[0], box_lo.shape[0]
    hits, tns = [], []
    for s in range(0, nt, chunk):
        o_c = ot[s:s + chunk, :, None]                   # [C, TILE, 1, 3]
        i_c = inv[s:s + chunk, :, None]
        tc = tct[s:s + chunk, :, None]
        t0 = (box_lo - o_c) * i_c                        # [C, TILE, nbx, 3]
        t1 = (box_hi - o_c) * i_c
        tn = torch.minimum(t0, t1).amax(dim=-1)
        tf = torch.maximum(t0, t1).amin(dim=-1)
        tn0 = torch.clamp(tn, min=0.0)
        hit = (tf >= tn0) & (tn <= tc) & (tc > 0.0)
        hits.append(hit.any(dim=1))
        if return_tn:
            tns.append(torch.where(hit, tn0, INF_DIST).amin(dim=1))
    hit = torch.cat(hits) if hits else torch.zeros(
        (0, nbx), dtype=torch.bool, device=ot.device)
    return (hit, torch.cat(tns)) if return_tn else hit


def _tables_with_cap(tn_blk, cap_tile, nsb: int):
    """(sb_mask, mask8) re-derived from the round-1 block entry distances
    under tightened per-tile caps (recull "tn", the JAX package's
    ``accel/packet.py:_tables_with_cap``): a block stays while its entry
    distance is within the tile's largest cap.  Tile-granular, so
    conservative: the hits do not change."""
    nt = tn_blk.shape[0]
    cap = cap_tile[:, None, None]
    blk = tn_blk[:, :nsb * SB].reshape(nt, nsb, SB)
    ok = (blk <= cap) & (cap > 0.0)
    bits = 1 << torch.arange(SB, device=tn_blk.device, dtype=torch.int32)
    mask8 = torch.where(ok, bits, 0).sum(dim=2, dtype=torch.int32)
    return mask8 != 0, mask8


def _run_packet_pallas(root_lo, root_hi, ps: PacketSet, o, d, t_cap,
                       any_hit: bool = False, order=None,
                       k_round: int | None = None,
                       strategy: str | None = None,
                       cull_impl: str = "pallas", sort_mode: str = "full",
                       recull: str = "sb", kernel_form: str = "mt",
                       near_frac: float = 0.0,
                       stale_round_masks: bool = False):
    """Sort + tile rays, cull, run the pairs, unsort.  Returns
    (t, slot, order): per ray in the caller's order the kernel's closest
    distance (t_cap on a miss) and slot (-1 = none), and the coherence
    sort.

    ``cull_impl``: "pallas" (the default, as in the JAX package) culls
    every (tile, block) densely and takes each pair's 8-bit block mask
    from that table; "pallas2" culls (tile, superblock) densely and
    refines each compacted pair's mask with ``pair_cull``; "xla" runs
    "pallas2"'s kernels (its stages compute their functions) but ignores
    ``near_frac`` and ``stale_round_masks``, as the JAX package's "xla"
    branches do.
    ``strategy``: "two_round" (default for closest-hit), "rounds"
    (default for any-hit) or "single"; scenes of at most ``k_round``
    superblocks run "single".  ``near_frac`` > 0 ("two_round" under
    "pallas" and "pallas2"): round 1 runs each tile's candidates whose
    entry distance lies within that fraction of the tile's candidate
    range, instead of its K nearest.  ``recull`` (two_round under
    "pallas"): round 2's candidates from a per-ray re-cull of the
    superblocks with the round-1 block masks ("sb"), a block re-cull under
    the per-ray caps ("kernel"), or the round-1 block distances under
    per-tile caps ("tn"); "pallas2" always re-culls its superblocks per
    ray.  ``stale_round_masks``: "rounds" takes every round's block masks
    from the round-0 rays instead of rays with the caps so far (the same
    hits; more blocks tested).  ``sort_mode``: the coherence sort's
    variant (``_coherence_perm``).  ``order`` reuses a closest query's
    (perm, inv_perm) for its shadow query, or is "identity" (no sort)."""
    if strategy is None:
        strategy = "rounds" if any_hit else "two_round"
    check_query_knobs(cull_impl=cull_impl, sort_mode=sort_mode,
                      kernel_form=kernel_form, recull=recull,
                      strategies=(strategy,))

    rays, order, r = _sorted_rays_matrix(root_lo, root_hi, o, d, t_cap,
                                         order, sort_mode)
    # the pair intersector of the kernel form (looked up per call, so a
    # caller may swap a module-level kernel for its plain version); "mxu"
    # runs on coefficient planes built from the packet set per query, as
    # in the JAX package
    if kernel_form == "mxu":
        intersect = sb_intersect_mxu
        planes = mxu_planes_from_planes(ps.planes, 0.5 * (root_lo + root_hi))
    else:
        intersect = sb_intersect_mt2 if kernel_form == "mt2" else sb_intersect
        planes = ps.planes
    nt = rays.shape[0] // TILE - 1
    nsb = ps.n_superblocks
    dev = rays.device
    tct = rays[:nt * TILE, RC_TCAP].reshape(nt, TILE)
    k_first = K_FIRST if k_round is None else k_round
    if nsb <= k_first:
        strategy = "single"
    # "xla" refreshes every round's masks and has no near_frac selection
    xla = cull_impl == "xla"
    stale = stale_round_masks and not xla

    # the dense cull: per (tile, block) under "pallas", its block masks
    # riding along; per (tile, superblock) under "pallas2" and "xla"
    blocks = cull_impl == "pallas"
    sb_rows = box_rows_from_blocks(ps.sb_lo, ps.sb_hi)
    if blocks:
        blk_rows = box_rows_from_blocks(ps.block_lo, ps.block_hi)
        tn_blk = block_cull(rays, blk_rows, _live_tile_bound(tct))
        sb_mask, tn_sb, mask8 = derive_pair_tables(tn_blk, nsb)
    else:
        tn_sb = block_cull(rays, sb_rows, _live_tile_bound(tct))[:, :nsb]
        sb_mask, mask8 = tn_sb < INF_DIST, None
    # pair_cull's box table, where some round refines its pairs' masks
    sbbox = (sb_box_table(ps.block_lo, ps.block_hi)
             if not blocks or strategy == "rounds" else None)

    def run(mask, cull_rays, prior=None, cols=None, m8=mask8):
        """Compact ``mask``'s pairs, take their block masks (from the
        table ``m8``, else ``pair_cull`` on ``cull_rays``) and run them."""
        pt, psb, n_real = compact_pairs(mask, cols)
        if m8 is None:
            pm = pair_cull(pt, psb, n_real, cull_rays, sbbox)
        else:
            pm = m8[pt.long(), psb.long()]
        return intersect(pt, psb, pm, n_real, rays, planes, prior)

    def caps_from(out):
        """Per-ray caps after ``out`` (any-hit: 0 once a lane has a hit;
        closest: its best t so far) and their per-tile maximum."""
        if any_hit:
            slot = out[1][:nt * TILE].reshape(nt, TILE)
            tct_eff = torch.where(slot >= 0, 0.0, tct)
        else:
            tct_eff = torch.minimum(tct, out[0][:nt * TILE].reshape(nt, TILE))
        return tct_eff, tct_eff.amax(dim=1)

    def rays_with_caps(tct_eff):
        out = rays.clone()
        out[:nt * TILE, RC_TCAP] = tct_eff.reshape(-1)
        return out

    if strategy == "single":
        out = run(sb_mask, rays)
    elif strategy == "rounds":
        # every tile's candidates front to back (stable: equal distances
        # keep superblock order), K a round; round 0 on the query's rays
        tn_sorted, sb_sorted = torch.sort(
            torch.where(sb_mask, tn_sb, INF_DIST), dim=1, stable=True)
        out = run(tn_sorted[:, :k_first] < INF_DIST, rays,
                  cols=sb_sorted[:, :k_first])
        for rr in range(1, -(-nsb // k_first)):
            tct_eff, tile_cap = caps_from(out)
            cols = slice(rr * k_first, (rr + 1) * k_first)
            ctn = tn_sorted[:, cols]
            ok = (ctn <= tile_cap[:, None]) & (ctn < INF_DIST)
            pt, psb, n_real = compact_pairs(ok, sb_sorted[:, cols])
            # candidates are distance-ascending per tile, so an empty
            # round leaves every later one empty too: the JAX loop's
            # exit test (no tile's next candidate within its cap), read
            # from the list length the compaction's host sync gives
            if pt.shape[0] == 0:
                break
            # the block masks under the caps so far (the JAX package's
            # _block_masks is pair_cull's function), or the round-0 ones
            if blocks and stale:
                pm = mask8[pt.long(), psb.long()]
            else:
                pm = pair_cull(pt, psb, n_real, rays if stale
                               else rays_with_caps(tct_eff), sbbox)
            out = intersect(pt, psb, pm, n_real, rays, planes, out)
    else:
        tn_cand = torch.where(sb_mask, tn_sb, INF_DIST)
        if near_frac > 0.0 and not xla:
            # round 1: the candidates within near_frac of each tile's
            # range of entry distances
            tmin = tn_cand.amin(dim=1, keepdim=True)
            tmax = torch.where(sb_mask, tn_sb, -INF_DIST).amax(dim=1,
                                                               keepdim=True)
            thr = tmin + float(np.float32(near_frac)) * torch.clamp(
                tmax - tmin, min=0.0)
            executed = sb_mask & (tn_sb <= thr)
            out = run(executed, rays)
        else:
            # round 1: the K nearest candidate superblocks of every tile
            # (stable sort: equal distances keep superblock order)
            tn_sorted, sb_sorted = torch.sort(tn_cand, dim=1, stable=True)
            cand = sb_sorted[:, :k_first]
            cand_ok = tn_sorted[:, :k_first] < INF_DIST
            out = run(cand_ok, rays, cols=cand)
            executed = torch.zeros((nt, nsb + 1), dtype=torch.bool,
                                   device=dev)
            executed.scatter_(1, torch.where(cand_ok, cand, nsb), True)
            executed = executed[:, :nsb]

        # round 2: re-cull the rest under the tightened per-ray caps
        tct2, _ = caps_from(out)
        rays2 = rays_with_caps(tct2)
        if not blocks or recull == "sb":
            # per-ray at superblock granularity (_per_ray_tile_overlap's
            # function); "pallas" keeps the round-1 block masks
            tn2 = block_cull(rays2, sb_rows, _live_tile_bound(tct2))[:, :nsb]
            sb_mask2, mask8_2 = tn2 < INF_DIST, mask8
        elif recull == "kernel":
            sb_mask2, _, mask8_2 = derive_pair_tables(
                block_cull(rays2, blk_rows, _live_tile_bound(tct2)), nsb)
        else:
            sb_mask2, mask8_2 = _tables_with_cap(tn_blk, tct2.amax(dim=1),
                                                 nsb)
        out = run(sb_mask2 & sb_mask & ~executed, rays2, prior=out,
                  m8=mask8_2)

    return _unsorted(out[0], r, order), _unsorted(out[1], r, order), order


#: ray tiles per chunk of the "packet" query's interval cull: each
#: [chunk, blocks, 3] f32 temporary holds chunk * blocks * 12 bytes (25 MB
#: at 2,048 blocks)
OVERLAP_CHUNK = 1024


def _interval_overlap(o_lo, o_hi, inv_lo, inv_hi, blk_lo, blk_hi, t_hi):
    """Conservative tile-frustum against box test (the JAX package's
    ``accel/packet.py:_interval_overlap``): tile intervals [T,1,3] of the
    origins and inverse directions, boxes [1,B,3], the tiles' largest caps
    [T,1]; True where some ray of the tile could pass, bool[T,B].  Entry
    and exit times are bounded by the products of the intervals' ends:
    min/max and single products only, so the table is the JAX one bit for
    bit."""
    def prods(a_lo, a_hi):
        p1, p2 = a_lo * inv_lo, a_lo * inv_hi
        p3, p4 = a_hi * inv_lo, a_hi * inv_hi
        return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

    lo1, hi1 = prods(blk_lo - o_hi, blk_lo - o_lo)
    lo2, hi2 = prods(blk_hi - o_hi, blk_hi - o_lo)
    tn = torch.minimum(lo1, lo2).amax(dim=-1)     # latest slab entry
    tf = torch.maximum(hi1, hi2).amin(dim=-1)     # earliest slab exit
    return (tf >= torch.clamp(tn, min=0.0)) & (tn <= t_hi)


def tile_block_overlap(rays, block_lo, block_hi, chunk: int = OVERLAP_CHUNK):
    """``_interval_overlap`` of every ray tile of the kernel ray matrix
    (dead padding lanes included, as the JAX package builds its tiles)
    against every block box, ``chunk`` tiles at a time: bool[nt, nb]."""
    nt = rays.shape[0] // TILE - 1
    body = rays[:nt * TILE]
    ot = body[:, 0:3].reshape(nt, TILE, 3)
    inv = body[:, 8:11].reshape(nt, TILE, 3)
    t_hi = body[:, RC_TCAP].reshape(nt, TILE).amax(dim=1)[:, None]
    o_lo, o_hi = ot.amin(dim=1)[:, None], ot.amax(dim=1)[:, None]
    i_lo, i_hi = inv.amin(dim=1)[:, None], inv.amax(dim=1)[:, None]
    out = torch.empty((nt, block_lo.shape[0]), dtype=torch.bool,
                      device=rays.device)
    for s in range(0, nt, chunk):
        c = slice(s, s + chunk)
        out[c] = _interval_overlap(o_lo[c], o_hi[c], i_lo[c], i_hi[c],
                                   block_lo[None], block_hi[None], t_hi[c])
    return out


def _run_packet(root_lo, root_hi, ps: PacketSet, o, d, t_cap):
    """The ``intersector="packet"`` query: sort + tile rays ("full"), cull
    each tile's frustum against every block (``tile_block_overlap``), run
    every overlapping block of every tile through ``sb_intersect`` (the
    pairs tile-major with superblocks ascending, each pair's mask its
    overlapping blocks: ties go to the earliest block, then the earliest
    slot, as in the JAX package's block loop), unsort.  Returns (t, slot)
    per ray in the caller's order (t_cap and -1 on a miss)."""
    rays, order, r = _sorted_rays_matrix(root_lo, root_hi, o, d, t_cap)
    nt = rays.shape[0] // TILE - 1
    overlap = tile_block_overlap(rays, ps.block_lo, ps.block_hi)
    bits = 1 << torch.arange(SB, device=rays.device, dtype=torch.int32)
    mask8 = torch.where(overlap.reshape(nt, ps.n_superblocks, SB), bits,
                        0).sum(dim=2, dtype=torch.int32)
    pt, psb, n_real = compact_pairs(mask8 != 0)
    t, slot = sb_intersect(pt, psb, mask8[pt.long(), psb.long()], n_real,
                           rays, ps.planes)
    return _unsorted(t, r, order), _unsorted(slot, r, order)


@spanned("pc.reeval")
def _reeval_hit(bvh, soup, o, d, slot) -> Hit:
    """Re-evaluate the winning triangle of each ray (barycentrics, t):
    differentiable in ``soup.v0/v1/v2`` and in ``o`` and ``d``; the slot
    is discrete."""
    tri = torch.where(slot >= 0, bvh.orig[torch.clamp(slot, min=0).long()],
                      -1)
    trix = torch.clamp(tri, min=0).long()
    t, u, v, _ = moller_trumbore(o, d, take_rows(soup.v0, trix),
                                 take_rows(soup.v1, trix),
                                 take_rows(soup.v2, trix))
    hitm = tri >= 0
    return Hit(t=torch.where(hitm, t, INF_DIST), tri=tri,
               u=torch.where(hitm, u, 0.0), v=torch.where(hitm, v, 0.0))


def _detached(bvh, ps: PacketSet, o, d, t_cap):
    """The query's inputs (root box, packet set, rays, caps) outside any
    autograd graph."""
    ps = PacketSet(**{f.name: getattr(ps, f.name).detach()
                      for f in dataclasses.fields(ps)})
    return (bvh.lo[0].detach(), bvh.hi[0].detach(), ps, o.detach(),
            d.detach(), t_cap.detach())


def intersect_closest_pallas(bvh, ps: PacketSet, soup, o, d, t_cap=None,
                             return_order=False, order=None, **kw):
    """Closest hit through the packet query.  ``t_cap`` f32[R] (optional)
    is a per-lane far limit; 0 removes a lane from every pair list.
    ``return_order`` also returns the coherence sort for reuse by the
    same bounce's shadow query.  ``**kw``: strategy knobs of
    ``_run_packet_pallas``.  The query runs on detached inputs; gradients
    reach ``o``, ``d`` and the soup through ``_reeval_hit``."""
    if t_cap is None:
        t_cap = torch.full((o.shape[0],), INF_DIST, device=o.device)
    _, slot, order = _run_packet_pallas(*_detached(bvh, ps, o, d, t_cap),
                                        order=order, **kw)
    hit = _reeval_hit(bvh, soup, o, d, slot)
    return (hit, order) if return_order else hit


def occluded_pallas(bvh, ps: PacketSet, soup, o, d, t_max, order=None,
                    **kw):
    """Any-hit query: True where some triangle lies in (PZERO, t_max)
    (no gradient)."""
    _, slot, _ = _run_packet_pallas(*_detached(bvh, ps, o, d, t_max),
                                    any_hit=True, order=order, **kw)
    return slot >= 0


def intersect_closest_packet(bvh, ps: PacketSet, soup, o, d) -> Hit:
    """Closest hit through the ``intersector="packet"`` query
    (``_run_packet``); every lane is capped at INF_DIST, as in the JAX
    package.  The query runs on detached inputs; gradients reach ``o``,
    ``d`` and the soup through ``_reeval_hit``."""
    t_cap = torch.full((o.shape[0],), INF_DIST, device=o.device)
    _, slot = _run_packet(*_detached(bvh, ps, o, d, t_cap))
    return _reeval_hit(bvh, soup, o, d, slot)


def occluded_packet(bvh, ps: PacketSet, soup, o, d, t_max):
    """Any-hit query through the ``intersector="packet"`` query: True
    where some triangle lies in (PZERO, t_max) (no gradient)."""
    _, slot = _run_packet(*_detached(bvh, ps, o, d, t_max))
    return slot >= 0
