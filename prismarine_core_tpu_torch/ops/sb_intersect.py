"""The fused pair intersector: wrapper, layout constants, plain version.

``sb_intersect`` (CUDA: ``csrc/sb_intersect.cu``, replacing
``prismarine_core_tpu/ops/pallas_intersect.py:_sb_kernel``, form "mt"):
for each (tile, superblock) pair of a tile-major pair list and each set
bit k of the pair's 8-bit mask, a 128-ray x 128-triangle Moller-Trumbore
of the tile's rays against sub-block k's SoA planes.  A hit needs
``|det| >= 1e-10``, ``u, v >= 0``, ``u + v <= 1``, ``t > PZERO`` and the
slot's valid row.  Each ray keeps its closest (t, slot),
slot = sb*1024 + k*128 + lane, starting from ``prior`` or from
(t_cap, -1); only a t strictly below the running best replaces it, so a
hit at exactly t_cap is rejected.

Tie rule: among equal t, the earliest (pair, k, lane) in list order wins.
The CUDA kernel gets it from its sequential strict ``<`` over a tile's
pairs; the plain version from a first-occurrence argmin over (k, lane)
per pair, then the earliest pair holding the minimum.  (The JAX kernel
breaks ties by grid step, then lane, then (pair, k); that differs only
where two triangles give bit-equal t, such as on shared edges.)

The result is two tensors over all (nt+1)*128 rows: t f32 and slot i32
(the JAX kernel's int-in-float column is not carried over).
"""

from __future__ import annotations

import torch

from prismarine_core_tpu_torch import _build
from prismarine_core_tpu_torch._build import check_tensor
from prismarine_core_tpu_torch.utils.config import INF_DIST, PZERO

TILE = 128       # rays per tile
BLOCK = 128      # triangle slots per sub-block
SB = 8           # sub-blocks per superblock
RAY_COLS = 16
PLANE_ROWS = 16
# ray component columns (7 and 11-15 are unused by these kernels)
(RC_OX, RC_OY, RC_OZ, RC_DX, RC_DY, RC_DZ, RC_TCAP) = range(7)
RC_IVX, RC_IVY, RC_IVZ = 8, 9, 10
# triangle plane rows
(TC_V0X, TC_V0Y, TC_V0Z, TC_E1X, TC_E1Y, TC_E1Z,
 TC_E2X, TC_E2Y, TC_E2Z, TC_VALID) = range(10)
_DET_EPS = 1e-10


def as_count(n, device):
    """A count (int or 1-element tensor) as a 0-d tensor on ``device``."""
    return torch.as_tensor(n, device=device).reshape(())


def _init(rays, prior):
    if prior is not None:
        return prior
    t0 = rays[:, RC_TCAP].contiguous()
    s0 = torch.full((rays.shape[0],), -1, dtype=torch.int32,
                    device=rays.device)
    return t0, s0


def sb_intersect_plain(pair_tile, pair_sb, pair_mask, n_real, rays, planes,
                       prior=None, chunk: int = 32):
    """Plain PyTorch pair intersector -> (t f32[rows], slot i32[rows]).
    ``chunk`` pairs at a time bound the [chunk, 128, 1024]
    intermediates."""
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
        r = tiles[pair_tile[s:s + chunk].long()]          # [C, 128, 16]
        pl = planes[psb]                                   # [C, 16, 1024]

        def rc(c):
            return r[:, :, c, None]                        # [C, 128, 1]

        def tr(c):
            return pl[:, None, c, :]                       # [C, 1, 1024]

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
        tt = torch.where(ok, tt, INF_DIST)
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


def sb_intersect(pair_tile, pair_sb, pair_mask, n_real, rays, planes,
                 prior=None):
    """Closest (t, slot) per ray row after executing a tile-major pair
    list.  ``pair_*`` i32[L], ``n_real`` i32 scalar tensor (pairs >= it are
    ignored), ``rays`` f32[(nt+1)*128, 16], ``planes``
    f32[nsb+1, 16, 1024], ``prior`` an optional (t, slot) of an earlier
    round.  Returns (t f32[(nt+1)*128], slot i32[(nt+1)*128])."""
    if rays.device.type == "cpu":
        return sb_intersect_plain(pair_tile, pair_sb, pair_mask, n_real,
                                  rays, planes, prior)
    dev = rays.device
    n_rows = rays.shape[0]
    n_pairs = pair_tile.shape[0]
    check_tensor(rays, torch.float32, (n_rows, RAY_COLS), "rays")
    check_tensor(planes, torch.float32,
                 (planes.shape[0], PLANE_ROWS, SB * BLOCK), "planes", dev)
    for name, t in (("pair_tile", pair_tile), ("pair_sb", pair_sb),
                    ("pair_mask", pair_mask)):
        check_tensor(t, torch.int32, (n_pairs,), name, dev)
    check_tensor(n_real, torch.int32, None, "n_real", dev, numel=1)
    if n_rows % TILE:
        raise ValueError("rays rows must be a multiple of 128")
    if prior is not None:
        check_tensor(prior[0], torch.float32, (n_rows,), "prior t", dev)
        check_tensor(prior[1], torch.int32, (n_rows,), "prior slot", dev)
    n_tiles = n_rows // TILE
    # each tile's run of the tile-major list: [start[t], start[t+1])
    tile_start = torch.searchsorted(
        pair_tile, torch.arange(n_tiles + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    out_t = torch.empty((n_rows,), dtype=torch.float32, device=dev)
    out_slot = torch.empty((n_rows,), dtype=torch.int32, device=dev)
    code = _build.library().sb_intersect_launch(
        tile_start.data_ptr(), pair_sb.data_ptr(), pair_mask.data_ptr(),
        n_real.data_ptr(), rays.data_ptr(), planes.data_ptr(),
        prior[0].data_ptr() if prior is not None else None,
        prior[1].data_ptr() if prior is not None else None,
        out_t.data_ptr(), out_slot.data_ptr(), n_tiles,
        _build.stream_ptr(dev))
    _build.check(code, "sb_intersect")
    sb_intersect.launches += 1
    return out_t, out_slot


sb_intersect.launches = 0
