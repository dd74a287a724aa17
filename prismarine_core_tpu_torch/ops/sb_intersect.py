"""The fused pair intersector in its three forms: wrappers, layouts, plain
versions.

Every form computes the same function of a tile-major pair list: for each
(tile, superblock) pair and each set bit k of the pair's 8-bit mask, a
128-ray x 128-triangle Moller-Trumbore of the tile's rays against
sub-block k.  A hit needs ``|det| >= 1e-10``, ``u, v >= 0``,
``u + v <= 1`` and ``t > PZERO`` (and, in the elementwise forms, the
slot's valid row).  Each ray keeps its closest (t, slot),
slot = sb*1024 + k*128 + lane, starting from ``prior`` or from
(t_cap, -1); only a t strictly below the running best replaces it, so a
hit at exactly t_cap is rejected.

* ``sb_intersect`` (form "mt"; CUDA ``csrc/sb_intersect.cu`` on the walk
  of ``csrc/sb_walk.cuh``, replacing
  ``prismarine_core_tpu/ops/pallas_intersect.py:_sb_kernel``): the
  elementwise Moller-Trumbore on the SoA planes.
* ``sb_intersect_mt2`` (form "mt2"; ``csrc/sb_intersect.cu`` on the same
  walk, replacing ``_sb_kernel_mt2``): each stage of the walk holds two
  live sub-blocks of one ray tile, tested as two independent chains;
  equal to "mt" bit for bit, so its plain version is
  ``sb_intersect_plain``.
* ``sb_intersect_mxu`` (form "mxu"; CUDA ``csrc/sb_intersect_mxu.cu`` on
  the same walk, replacing ``_sb_kernel_mxu``): det and the u, v, t
  numerators as linear forms of the ray row ``[o, d, 1, c]`` (c = (o -
  center) x d) against the coefficient planes of
  ``mxu_planes_from_planes``; plain version ``sb_intersect_mxu_plain``.

Tie rule: among equal t, the earliest (pair, k, lane) in list order wins.
The plain versions get it from a first-occurrence argmin over (k, lane)
per pair, then the earliest pair holding the minimum; the walk from
64-bit keys (bits of t, then the position in the tile's run) folded with
``atomicMin``, in "mt2" after a strict ``<`` fold per chain.
``work_units``, ``walk_stages``, ``keys_init``, ``keys_decode`` and
``sb_walk_emulation`` are that walk in plain torch.  (The JAX kernels
break ties by grid step, then lane, then (pair, k); that differs only
where two triangles give bit-equal t, such as on shared edges.)

The result is two tensors over all (nt+1)*128 rows: t f32 and slot i32
(the JAX kernel's int-in-float column is not carried over).
"""

from __future__ import annotations

import torch

from prismarine_core_tpu_torch import _build
from prismarine_core_tpu_torch._build import check_tensor
from prismarine_core_tpu_torch.ops import dispatch
from prismarine_core_tpu_torch.utils import math as pm
from prismarine_core_tpu_torch.utils.config import INF_DIST, PZERO
from prismarine_core_tpu_torch.utils.profiling import span

TILE = 128       # rays per tile
BLOCK = 128      # triangle slots per sub-block
SB = 8           # sub-blocks per superblock
RAY_COLS = 16
PLANE_ROWS = 16
# ray component columns (15 is unused); RC_ONE (constant 1) and
# RC_CX..RC_CZ (c = (o - center) x d) feed only the "mxu" form
(RC_OX, RC_OY, RC_OZ, RC_DX, RC_DY, RC_DZ, RC_TCAP, RC_ONE,
 RC_IVX, RC_IVY, RC_IVZ, RC_CX, RC_CY, RC_CZ) = range(14)
# triangle plane rows
(TC_V0X, TC_V0Y, TC_V0Z, TC_E1X, TC_E1Y, TC_E1Z,
 TC_E2X, TC_E2Y, TC_E2Z, TC_VALID) = range(10)
#: quantities of the "mxu" coefficient planes, per sub-block lane groups
#: [det | u_num | v_num | t_num] of BLOCK lanes each
MXU_Q = 4
#: the (ray column, quantity) coefficient rows that are not zero by
#: construction, in the order both "mxu" versions sum them
MXU_TERMS = (
    ((RC_DX, 0), (RC_DY, 0), (RC_DZ, 0)),                        # det
    ((RC_DX, 1), (RC_DY, 1), (RC_DZ, 1),
     (RC_CX, 1), (RC_CY, 1), (RC_CZ, 1)),                        # u_num
    ((RC_DX, 2), (RC_DY, 2), (RC_DZ, 2),
     (RC_CX, 2), (RC_CY, 2), (RC_CZ, 2)),                        # v_num
    ((RC_OX, 3), (RC_OY, 3), (RC_OZ, 3), (RC_ONE, 3)),           # t_num
)
_DET_EPS = 1e-10


def as_count(n, device):
    """A count (int or 1-element tensor) as a 0-d tensor on ``device``."""
    return torch.as_tensor(n, device=device).reshape(())


def mxu_planes_from_planes(planes, center):
    """Determinant-form coefficient planes of the "mxu" form (the
    counterpart of ``pallas_intersect.py:mxu_planes_from_planes``, plain
    torch there and here).

    Moller-Trumbore's four quantities are linear in the ray row
    ``[o, d, 1, c]``, c = (o - center) x d, v~0 = v0 - center,
    n = e1 x e2::

      det   = d.(e2 x e1)
      u_num = c.e2 + d.(v~0 x e2)
      v_num = -c.e1 + d.(e1 x v~0)
      t_num = o.n - v0.n

    ``planes`` f32[nsb+1, 16, SB*BLOCK] -> f32[nsb+1, 16, SB*MXU_Q*BLOCK];
    for sub-block k, lanes [512k, 512k+512) hold the groups
    [det | u_num | v_num | t_num] of its BLOCK slots.  Invalid and
    sentinel slots have all-zero columns (det = 0 rejects them)."""
    nsbp, _, s = planes.shape

    def vec(r0):
        return planes[:, r0:r0 + 3].transpose(1, 2)          # [nsbp, S, 3]

    v0, e1, e2 = vec(TC_V0X), vec(TC_E1X), vec(TC_E2X)
    valid = (planes[:, TC_VALID] > 0.5)[..., None]          # [nsbp, S, 1]
    n = pm.cross(e1, e2)
    vt = v0 - center
    coef = torch.zeros((nsbp, PLANE_ROWS, MXU_Q, s), dtype=torch.float32,
                       device=planes.device)

    def put(row, q, val):                                    # [nsbp, S, k]
        val = torch.where(valid, val, 0.0)
        coef[:, row:row + val.shape[-1], q] = val.transpose(1, 2)

    put(RC_DX, 0, pm.cross(e2, e1))
    put(RC_CX, 1, e2)
    put(RC_DX, 1, pm.cross(vt, e2))
    put(RC_CX, 2, -e1)
    put(RC_DX, 2, pm.cross(e1, vt))
    put(RC_OX, 3, n)
    put(RC_ONE, 3, -pm.dot(v0, n, keepdim=True))
    coef = coef.reshape(nsbp, PLANE_ROWS, MXU_Q, s // BLOCK, BLOCK)
    return coef.transpose(2, 3).reshape(
        nsbp, PLANE_ROWS, (s // BLOCK) * MXU_Q * BLOCK).contiguous()


def live_counts(pair_mask, n_real):
    """i32[L]: live sub-blocks of each pair (its mask's popcount; 0 at and
    beyond ``n_real``)."""
    dev = pair_mask.device
    bits = (pair_mask[:, None] >> torch.arange(SB, device=dev)) & 1
    real = torch.arange(pair_mask.shape[0], device=dev) < as_count(n_real,
                                                                   dev)
    return torch.where(real, bits.sum(1), 0).to(torch.int32)


def tile_work(pair_tile, pair_mask, n_real, n_tiles):
    """i64[n_tiles]: live sub-blocks in each ray tile's run of the list."""
    return torch.zeros((n_tiles,), dtype=torch.int64,
                       device=pair_mask.device).index_add_(
        0, pair_tile.long(), live_counts(pair_mask, n_real).long())


def tile_runs(pair_tile, n_rows):
    """i32[n_tiles + 1]: the tile-major list's run starts; tile t's pairs
    are [start[t], start[t+1])."""
    return torch.searchsorted(
        pair_tile, torch.arange(n_rows // TILE + 1, dtype=torch.int32,
                                device=pair_tile.device), out_int32=True)


def _init(rays, prior):
    if prior is not None:
        return prior
    t0 = rays[:, RC_TCAP].contiguous()
    s0 = torch.full((rays.shape[0],), -1, dtype=torch.int32,
                    device=rays.device)
    return t0, s0


def _mt_grid(r, pl):
    """Elementwise Moller-Trumbore: ray rows r [C, 128, 16] against
    planes pl [C, 16, n] -> t [C, 128, n] (INF_DIST on a miss)."""
    def rc(c):
        return r[:, :, c, None]                            # [C, 128, 1]

    def tr(c):
        return pl[:, None, c, :]                           # [C, 1, 1024]

    rox, roy, roz = rc(RC_OX), rc(RC_OY), rc(RC_OZ)
    rdx, rdy, rdz = rc(RC_DX), rc(RC_DY), rc(RC_DZ)
    e1x, e1y, e1z = tr(TC_E1X), tr(TC_E1Y), tr(TC_E1Z)
    e2x, e2y, e2z = tr(TC_E2X), tr(TC_E2Y), tr(TC_E2Z)
    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / torch.where(torch.abs(det) < _DET_EPS, _DET_EPS, det)
    sx = rox - tr(TC_V0X)
    sy = roy - tr(TC_V0Y)
    sz = roz - tr(TC_V0Z)
    uu = (sx * px + sy * py + sz * pz) * inv
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = (rdx * qx + rdy * qy + rdz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = ((torch.abs(det) >= _DET_EPS)
          & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt > PZERO) & (tr(TC_VALID) > 0.5))
    return torch.where(ok, tt, INF_DIST)


def _mxu_grid(r, pl):
    """Determinant form: ray rows r [C, 128, 16] against coefficient
    planes pl [C, 16, n*512] (n sub-blocks) -> t [C, 128, n*128]
    (INF_DIST on a miss).
    Each quantity sums the MXU_TERMS products left to right, written out
    elementwise (no matmul, so no TF32 and a fixed order)."""
    c = pl.shape[0]
    pl = pl.reshape(c, PLANE_ROWS, -1, MXU_Q, BLOCK)

    def quantity(terms):
        acc = None
        for col, q in terms:
            term = (r[:, :, col, None]
                    * pl[:, None, col, :, q, :].reshape(c, 1, -1))
            acc = term if acc is None else acc + term
        return acc

    det, un, vn, tn = (quantity(t) for t in MXU_TERMS)
    inv = 1.0 / torch.where(torch.abs(det) < _DET_EPS, _DET_EPS, det)
    uu = un * inv
    vv = vn * inv
    tt = tn * inv
    ok = ((torch.abs(det) >= _DET_EPS)
          & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > PZERO))
    return torch.where(ok, tt, INF_DIST)


def _plain(grid, pair_tile, pair_sb, pair_mask, n_real, rays, planes,
           prior, chunk):
    """The plain pair intersector around a per-chunk t ``grid``."""
    dev = rays.device
    n_rows = rays.shape[0]
    n_pairs = pair_tile.shape[0]
    t0, s0 = _init(rays, prior)
    if n_pairs == 0:
        return t0.clone(), s0.clone()
    tiles = rays.reshape(-1, TILE, RAY_COLS)
    sub_of_lane = torch.arange(SB * BLOCK, device=dev) // BLOCK
    pair_t = torch.empty((n_pairs, TILE), dtype=torch.float32, device=dev)
    pair_slot = torch.empty((n_pairs, TILE), dtype=torch.int64, device=dev)
    for s in range(0, n_pairs, chunk):
        psb = pair_sb[s:s + chunk].long()
        tt = grid(tiles[pair_tile[s:s + chunk].long()], planes[psb])
        # masked-off sub-blocks take no part at all (+inf, above INF_DIST)
        live = ((pair_mask[s:s + chunk, None] >> sub_of_lane) & 1) == 1
        tt = torch.where(live[:, None, :], tt, float("inf"))
        j = torch.argmin(tt, dim=2)                        # first minimum
        pair_t[s:s + chunk] = torch.gather(tt, 2, j[:, :, None])[:, :, 0]
        pair_slot[s:s + chunk] = psb[:, None] * (SB * BLOCK) + j

    # merge pairs per ray: the minimum, then the earliest pair holding it
    real = torch.arange(n_pairs, device=dev) < as_count(n_real, dev)
    pair_t = torch.where(real[:, None], pair_t, float("inf"))
    row = (pair_tile.long()[:, None] * TILE
           + torch.arange(TILE, device=dev)).reshape(-1)
    best = torch.full((n_rows,), float("inf"), device=dev).scatter_reduce(
        0, row, pair_t.reshape(-1), "amin")
    pid = torch.arange(n_pairs, device=dev)[:, None].expand(-1, TILE)
    holds = ((pair_t == best[row].reshape(n_pairs, TILE))
             & torch.isfinite(pair_t))
    first = torch.full((n_rows,), n_pairs, dtype=torch.int64,
                       device=dev).scatter_reduce(
        0, row, torch.where(holds, pid, n_pairs).reshape(-1), "amin")
    lanes = torch.arange(n_rows, device=dev) % TILE
    win_slot = pair_slot[first.clamp(max=n_pairs - 1), lanes]
    better = (first < n_pairs) & (best < t0)
    return (torch.where(better, best, t0),
            torch.where(better, win_slot.to(torch.int32), s0))


def sb_intersect_plain(pair_tile, pair_sb, pair_mask, n_real, rays, planes,
                       prior=None, chunk: int = 32):
    """Plain PyTorch pair intersector, forms "mt" and "mt2" -> (t
    f32[rows], slot i32[rows]).  ``chunk`` pairs at a time bound the
    [chunk, 128, 1024] intermediates."""
    return _plain(_mt_grid, pair_tile, pair_sb, pair_mask, n_real, rays,
                  planes, prior, chunk)


def sb_intersect_mxu_plain(pair_tile, pair_sb, pair_mask, n_real, rays,
                           planes, prior=None, chunk: int = 32):
    """Plain PyTorch pair intersector, form "mxu": ``planes`` are the
    coefficient planes f32[nsb+1, 16, 4096] (``mxu_planes_from_planes``)."""
    return _plain(_mxu_grid, pair_tile, pair_sb, pair_mask, n_real, rays,
                  planes, prior, chunk)


#: live sub-blocks per work unit of the walk: the CUDA walk
#: (csrc/sb_walk.cuh) takes it as an argument, its emulation below uses it
WALK_UNIT = 8


def work_units(pair_mask, n_real, unit: int = WALK_UNIT):
    """The walk's work units in plain torch: (csum i32[L], unit_pair
    i32[n_units]).  csum[p] counts the live sub-blocks of pairs 0..p (a
    pair at or beyond ``n_real`` counts 0); unit u holds the live
    sub-blocks [u*unit, (u+1)*unit) of the list, in list order, and starts
    in pair unit_pair[u].  (The CUDA plan kernel computes the same two
    arrays on the card.)"""
    csum = torch.cumsum(live_counts(pair_mask, n_real), 0,
                        dtype=torch.int32)
    total = int(csum[-1]) if csum.numel() else 0
    starts = torch.arange(0, total, unit, dtype=torch.int32,
                          device=pair_mask.device)
    return csum, torch.searchsorted(csum, starts, right=True,
                                    out_int32=True)


def keys_init(rays, prior=None):
    """i64[rows]: each row's starting key, (bits of the prior t or t_cap)
    << 32 with index 0 (an equal t never replaces it); a t <= 0 or NaN
    maps to 0, below every tested t."""
    t0, _ = _init(rays, prior)
    bits = t0.contiguous().view(torch.int32).long()
    return torch.where(t0 > 0, bits << 32, 0)


def keys_decode(keys, rays, prior, tile_start, pair_sb):
    """(t f32[rows], slot i32[rows]) of the folded keys: the prior where
    the index is 0, else t from the high word and the slot of index - 1 =
    (p - tile_start[tile]) * 1024 + k * 128 + lane."""
    t0, s0 = _init(rays, prior)
    if pair_sb.numel() == 0:
        return t0.clone(), s0.clone()
    low = keys & 0xFFFFFFFF
    idx = (low - 1).clamp(min=0)
    tile = torch.arange(keys.shape[0], device=keys.device) // TILE
    p = (tile_start.long()[tile] + (idx >> 10)).clamp(
        max=pair_sb.shape[0] - 1)
    slot = pair_sb.long()[p] * (SB * BLOCK) + (idx & (SB * BLOCK - 1))
    t = (keys >> 32).to(torch.int32).view(torch.float32)
    won = low != 0
    return torch.where(won, t, t0), torch.where(won, slot, s0).to(
        torch.int32)


def walk_stages(pair_tile, pair_mask, n_real, unit: int = WALK_UNIT):
    """The "mt2" walk's stages in plain torch: (items i64[n, 2], chain
    i64[n], stage i64[n]).  ``items`` are the live (pair, k) sub-blocks in
    list order, cut into units of ``unit``; within a unit each run of
    consecutive items of one ray tile is cut into stages of two (chain 0,
    then chain 1) and, where the run is odd, a lone last stage (chain 0
    only).  ``stage`` numbers the stages in list order.  (The CUDA walk
    forms the same stages as it goes: it pairs a sub-block with the next
    one of its unit when that lies in the same tile.)"""
    dev = pair_mask.device
    items = _live_items(pair_mask, n_real)
    n = items.shape[0]
    pos = torch.arange(n, device=dev)
    tile = pair_tile.long()[items[:, 0]]
    # a run starts at each item whose unit or tile is not the last one's
    new_run = torch.ones((n,), dtype=torch.bool, device=dev)
    new_run[1:] = (pos[1:] % unit == 0) | (tile[1:] != tile[:-1])
    run_start = torch.cummax(torch.where(new_run, pos, 0), 0)[0]
    chain = (pos - run_start) % 2
    return items, chain, torch.cumsum(chain == 0, 0) - 1


def _live_items(pair_mask, n_real):
    """i64[n, 2]: the live (pair, k) sub-blocks of the real pairs, in list
    order."""
    dev = pair_mask.device
    real = torch.arange(pair_mask.shape[0], device=dev) < as_count(n_real,
                                                                   dev)
    live = (((pair_mask[:, None] >> torch.arange(SB, device=dev)) & 1) == 1)
    return torch.nonzero(live & real[:, None])


def _emulate_chains(pair_tile, pair_sb, pair_mask, n_real, rays, planes,
                    prior, unit):
    """The "mt2" walk in plain torch: the stages of ``walk_stages`` in
    order; each chain keeps its own first-minimum (t, index) per ray of the
    current tile with a strict ``<`` in list order; at each tile change
    and at each unit's end the chains' keys meet (their minimum) and fold
    into the rows' keys."""
    dev = rays.device
    tile_start = tile_runs(pair_tile, rays.shape[0]).long()
    keys = keys_init(rays, prior)
    items, chain, _ = walk_stages(pair_tile, pair_mask, n_real, unit)
    tiles = rays.reshape(-1, TILE, RAY_COLS)
    lanes = torch.arange(TILE, device=dev)
    no_key = torch.iinfo(torch.int64).max
    best_t = best_i = cur = None                # cur: (unit, tile) folding

    def flush():
        k = torch.where(best_i != 0,
                        (best_t.view(torch.int32).long() << 32) | best_i,
                        no_key).amin(0)
        rows = cur[1] * TILE + lanes
        keys[rows] = torch.minimum(keys[rows], k)

    starts = torch.nonzero(chain == 0)[:, 0].tolist()
    for first, end in zip(starts, starts[1:] + [items.shape[0]]):
        p, k = items[first:end].T               # a stage: 1 or 2 chains
        tile = int(pair_tile[p[0]])
        if cur != (first // unit, tile):
            if cur is not None:
                flush()
            cur = (first // unit, tile)
            best_t = torch.full((2, TILE), float("inf"), device=dev)
            best_i = torch.zeros((2, TILE), dtype=torch.int64, device=dev)
        pl = planes[pair_sb[p].long()].reshape(-1, PLANE_ROWS, SB, BLOCK)
        tt = _mt_grid(tiles[tile].expand(end - first, -1, -1),
                      pl[torch.arange(end - first, device=dev), :, k])
        for c in range(end - first):            # chain c tests item c
            j = torch.argmin(tt[c], dim=1)      # first minimum over lanes
            t = torch.gather(tt[c], 1, j[:, None])[:, 0]
            idx = ((p[c] - tile_start[tile]) * (SB * BLOCK) + k[c] * BLOCK
                   + j + 1)
            better = t < best_t[c]
            best_t[c] = torch.where(better, t, best_t[c])
            best_i[c] = torch.where(better, idx, best_i[c])
    if cur is not None:
        flush()
    return keys_decode(keys, rays, prior, tile_start, pair_sb)


def sb_walk_emulation(form, pair_tile, pair_sb, pair_mask, n_real, rays,
                      planes, prior=None, unit: int = WALK_UNIT):
    """The CUDA walk in plain torch, then the decode.  ``form`` "mt"
    (planes f32[nsb+1, 16, 1024]) or "mxu" (coefficient planes f32[nsb+1,
    16, 4096]): work units of ``unit`` live sub-blocks in list order, each
    folding its tests' int64 keys into the rows' keys with
    ``scatter_reduce("amin")``.  "mt2" (the "mt" planes): the stages of
    ``walk_stages``, two chains each folded in order
    (``_emulate_chains``).  Equal to ``sb_intersect_plain`` /
    ``sb_intersect_mxu_plain`` bit for bit, ties included."""
    if form == "mt2":
        return _emulate_chains(pair_tile, pair_sb, pair_mask, n_real, rays,
                               planes, prior, unit)
    grid, width = ((_mt_grid, BLOCK) if form == "mt"
                   else (_mxu_grid, MXU_Q * BLOCK))
    dev = rays.device
    tile_start = tile_runs(pair_tile, rays.shape[0])
    keys = keys_init(rays, prior)
    csum, unit_pair = work_units(pair_mask, n_real, unit)
    items = _live_items(pair_mask, n_real)
    tiles = rays.reshape(-1, TILE, RAY_COLS)
    lanes = torch.arange(BLOCK, device=dev)
    for u in range(unit_pair.shape[0]):
        p, k = items[u * unit:(u + 1) * unit].T
        if int(p[0]) != int(unit_pair[u]):
            raise AssertionError(f"unit {u} starts in pair {int(p[0])}, "
                                 f"not {int(unit_pair[u])}")
        n = p.shape[0]
        tile = pair_tile[p].long()
        pl = planes[pair_sb[p].long()].reshape(n, PLANE_ROWS, SB, width)
        tt = grid(tiles[tile], pl[torch.arange(n, device=dev), :, k])
        idx = ((p - tile_start[tile].long()) * (SB * BLOCK)
               + k * BLOCK)[:, None] + lanes + 1             # [n, lanes]
        key = (tt.contiguous().view(torch.int32).long() << 32) | idx[:, None]
        rows = (tile[:, None] * TILE + torch.arange(TILE, device=dev))
        keys.scatter_reduce_(0, rows[:, :, None].expand(-1, -1, BLOCK)
                             .reshape(-1), key.reshape(-1), "amin")
    return keys_decode(keys, rays, prior, tile_start, pair_sb)


def _check(plane_w, pair_tile, pair_sb, pair_mask, n_real, rays, planes,
           prior):
    """Check the arguments of one pair-intersector kernel; returns the
    list's run starts (``tile_runs``)."""
    dev = rays.device
    n_rows = rays.shape[0]
    n_pairs = pair_tile.shape[0]
    check_tensor(rays, torch.float32, (n_rows, RAY_COLS), "rays")
    check_tensor(planes, torch.float32,
                 (planes.shape[0], PLANE_ROWS, plane_w), "planes", dev)
    for name, t in (("pair_tile", pair_tile), ("pair_sb", pair_sb),
                    ("pair_mask", pair_mask)):
        check_tensor(t, torch.int32, (n_pairs,), name, dev)
    check_tensor(n_real, torch.int32, None, "n_real", dev, numel=1)
    if n_rows % TILE:
        raise ValueError("rays rows must be a multiple of 128")
    if prior is not None:
        check_tensor(prior[0], torch.float32, (n_rows,), "prior t", dev)
        check_tensor(prior[1], torch.int32, (n_rows,), "prior slot", dev)
    return tile_runs(pair_tile, n_rows)


def _launch(entry, plane_w, pair_tile, pair_sb, pair_mask, n_real, rays,
            planes, prior):
    """Launch one pair-intersector kernel on the walk (C entry point
    ``entry``: plan, key init, walk, decode) after checking its
    arguments, inside the span ``pc.kernel.<kernel>`` (``entry`` less
    its ``_launch``)."""
    tile_start = _check(plane_w, pair_tile, pair_sb, pair_mask, n_real,
                        rays, planes, prior)
    lib = _build.library()
    dev = rays.device
    n_rows, n_pairs = rays.shape[0], pair_tile.shape[0]
    keys = torch.empty((n_rows + 1,), dtype=torch.int64, device=dev)
    csum = torch.empty((max(n_pairs, 1),), dtype=torch.int32, device=dev)
    unit_pair = torch.empty((max(-(-n_pairs * SB // WALK_UNIT), 1),),
                            dtype=torch.int32, device=dev)
    out_t = torch.empty((n_rows,), dtype=torch.float32, device=dev)
    out_slot = torch.empty((n_rows,), dtype=torch.int32, device=dev)
    with span("pc.kernel." + entry.removesuffix("_launch")):
        code = getattr(lib, entry)(
            tile_start.data_ptr(), pair_tile.data_ptr(), pair_sb.data_ptr(),
            pair_mask.data_ptr(), n_real.data_ptr(), rays.data_ptr(),
            planes.data_ptr(),
            prior[0].data_ptr() if prior is not None else None,
            prior[1].data_ptr() if prior is not None else None,
            keys.data_ptr(), csum.data_ptr(), unit_pair.data_ptr(),
            out_t.data_ptr(), out_slot.data_ptr(), n_rows, n_pairs,
            WALK_UNIT, _build.stream_ptr(dev))
    _build.check(code, entry)
    return out_t, out_slot


def launch_sb_intersect(*args):
    return _launch("sb_intersect_launch", SB * BLOCK, *args)


def launch_sb_intersect_mt2(*args):
    return _launch("sb_intersect_mt2_launch", SB * BLOCK, *args)


def launch_sb_intersect_mxu(*args):
    return _launch("sb_intersect_mxu_launch", SB * MXU_Q * BLOCK, *args)


def sb_intersect(pair_tile, pair_sb, pair_mask, n_real, rays, planes,
                 prior=None):
    """Form "mt": closest (t, slot) per ray row after executing a
    tile-major pair list.  ``pair_*`` i32[L], ``n_real`` i32 scalar tensor
    (pairs >= it are ignored), ``rays`` f32[(nt+1)*128, 16], ``planes``
    f32[nsb+1, 16, 1024], ``prior`` an optional (t, slot) of an earlier
    round.  Returns (t f32[(nt+1)*128], slot i32[(nt+1)*128])."""
    return dispatch.choose(rays, launch_sb_intersect, sb_intersect_plain)(
        pair_tile, pair_sb, pair_mask, n_real, rays, planes, prior)


def sb_intersect_mt2(pair_tile, pair_sb, pair_mask, n_real, rays, planes,
                     prior=None):
    """Form "mt2": the arguments and result of ``sb_intersect`` bit for
    bit, computed on the walk two sub-blocks of one ray tile a stage."""
    return dispatch.choose(rays, launch_sb_intersect_mt2,
                           sb_intersect_plain)(
        pair_tile, pair_sb, pair_mask, n_real, rays, planes, prior)


def sb_intersect_mxu(pair_tile, pair_sb, pair_mask, n_real, rays, planes,
                     prior=None):
    """Form "mxu": as ``sb_intersect``, with ``planes`` the coefficient
    planes f32[nsb+1, 16, 4096] of ``mxu_planes_from_planes`` and the ray
    matrix's RC_ONE and c columns filled."""
    return dispatch.choose(rays, launch_sb_intersect_mxu,
                           sb_intersect_mxu_plain)(
        pair_tile, pair_sb, pair_mask, n_real, rays, planes, prior)
