"""The packet query's two cull kernels: wrappers, box layouts, plain versions.

``block_cull`` (CUDA: ``csrc/cull.cu``, replacing
``prismarine_core_tpu/ops/pallas_cull.py:_cull_kernel``): per (128-ray
tile, box) the minimum over the tile's rays of the slab entry distance
``max(tn, 0)``, where a ray passes when ``tf >= max(tn, 0)``,
``tn <= t_cap`` and ``t_cap > 0``; INF_DIST when none passes, and for
every tile >= ``n_live`` untested.

``pair_cull`` (CUDA: ``csrc/cull.cu``, replacing ``_pair_cull_kernel``):
per (tile, superblock) pair an 8-bit mask, bit k set when some ray of the
tile passes block ``sb*8 + k``; 0 for pairs >= ``n_real``.

Each wrapper runs its plain PyTorch version when its tensors lie on the
CPU, and launches the CUDA kernel when they lie on a card; it counts its
kernel launches in ``.launches``.  The plain versions use the kernels'
operation order and are exact references for them.
"""

from __future__ import annotations

import torch

from prismarine_core_tpu_torch import _build
from prismarine_core_tpu_torch._build import check_tensor
from prismarine_core_tpu_torch.accel.lbvh import EMPTY_BOX
from prismarine_core_tpu_torch.ops.sb_intersect import (
    RAY_COLS, RC_IVX, RC_IVY, RC_IVZ, RC_OX, RC_OY, RC_OZ, RC_TCAP, SB,
    TILE, as_count)
from prismarine_core_tpu_torch.utils.config import INF_DIST

BOX_ROWS = 8     # lo_xyz hi_xyz pad pad


def box_rows_from_blocks(block_lo, block_hi):
    """[nb,3] x 2 AABBs -> f32[8, nb_pad] component rows, nb_pad a multiple
    of 128.  Padding lanes hold the inverted box (lo = +EMPTY_BOX,
    hi = -EMPTY_BOX), as in the JAX package; callers slice them off."""
    nb = block_lo.shape[0]
    nb_pad = -(-nb // 128) * 128
    rows = torch.zeros((BOX_ROWS, nb_pad), dtype=torch.float32,
                       device=block_lo.device)
    rows[0:3] = EMPTY_BOX
    rows[3:6] = -EMPTY_BOX
    rows[0:3, :nb] = block_lo.T
    rows[3:6, :nb] = block_hi.T
    return rows


def sb_box_table(block_lo, block_hi):
    """[nb,3] x 2 block AABBs -> f32[nsb+1, 8, SB]: entry [s, c, k] is
    component c (lo_xyz, hi_xyz, pad, pad) of block s*SB + k.  Row nsb is
    the sentinel: far point boxes (lo == hi == +EMPTY_BOX) that never
    pass."""
    nb = block_lo.shape[0]
    if nb % SB:
        raise ValueError(f"block count {nb} is not a multiple of {SB}")
    nsb = nb // SB
    tab = torch.full((nsb + 1, BOX_ROWS, SB), EMPTY_BOX, dtype=torch.float32,
                     device=block_lo.device)
    tab[:nsb, 0:3] = block_lo.reshape(nsb, SB, 3).transpose(1, 2)
    tab[:nsb, 3:6] = block_hi.reshape(nsb, SB, 3).transpose(1, 2)
    return tab


def _slab_entry(ray_cols, lo, hi):
    """Entry distance (INF_DIST where the predicate fails).  ray_cols:
    dict of broadcastable ray columns; lo/hi: tuples of box components."""
    ox, oy, oz = ray_cols["o"]
    ivx, ivy, ivz = ray_cols["iv"]
    tc = ray_cols["tc"]
    t0x = (lo[0] - ox) * ivx
    t1x = (hi[0] - ox) * ivx
    t0y = (lo[1] - oy) * ivy
    t1y = (hi[1] - oy) * ivy
    t0z = (lo[2] - oz) * ivz
    t1z = (hi[2] - oz) * ivz
    tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                     torch.minimum(t0y, t1y)),
                       torch.minimum(t0z, t1z))
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                     torch.maximum(t0y, t1y)),
                       torch.maximum(t0z, t1z))
    tn0 = torch.clamp(tn, min=0.0)
    hit = (tf >= tn0) & (tn <= tc) & (tc > 0.0)
    return torch.where(hit, tn0, INF_DIST)


def _ray_cols(r):
    """Columns of ray rows r[..., RAY_COLS] with a trailing box axis."""
    def c(i):
        return r[..., i, None]
    return {"o": (c(RC_OX), c(RC_OY), c(RC_OZ)),
            "iv": (c(RC_IVX), c(RC_IVY), c(RC_IVZ)), "tc": c(RC_TCAP)}


# ---------------------------------------------------------------- block cull

def block_cull_plain(rays, box_rows, n_live, chunk: int = 64):
    """Plain PyTorch block cull: f32[nt, nb_pad] (see module doc).
    ``chunk`` tiles at a time bound the [chunk, 128, nb_pad]
    intermediates."""
    nt = rays.shape[0] // TILE - 1
    nb_pad = box_rows.shape[1]
    lo = tuple(box_rows[i] for i in range(3))
    hi = tuple(box_rows[3 + i] for i in range(3))
    out = torch.empty((nt, nb_pad), dtype=torch.float32, device=rays.device)
    tiles = rays[:nt * TILE].reshape(nt, TILE, RAY_COLS)
    for s in range(0, nt, chunk):
        ent = _slab_entry(_ray_cols(tiles[s:s + chunk]), lo, hi)
        out[s:s + chunk] = ent.amin(dim=1)
    live = torch.arange(nt, device=rays.device) < as_count(n_live,
                                                            rays.device)
    return torch.where(live[:, None], out, INF_DIST)


def block_cull(rays, box_rows, n_live):
    """Per-(tile, box) entry distance f32[nt, nb_pad]; ``rays``
    f32[(nt+1)*128, 16], ``box_rows`` f32[8, nb_pad] (nb_pad % 128 == 0),
    ``n_live`` i32 scalar tensor on the rays' device."""
    if rays.device.type == "cpu":
        return block_cull_plain(rays, box_rows, n_live)
    n_rows = rays.shape[0]
    nb_pad = box_rows.shape[1]
    check_tensor(rays, torch.float32, (n_rows, RAY_COLS), "rays")
    check_tensor(box_rows, torch.float32, (BOX_ROWS, nb_pad), "box_rows",
                 rays.device)
    check_tensor(n_live, torch.int32, None, "n_live", rays.device, numel=1)
    if n_rows % TILE or nb_pad % TILE:
        raise ValueError("rays rows and nb_pad must be multiples of 128")
    nt = n_rows // TILE - 1
    out = torch.empty((nt, nb_pad), dtype=torch.float32, device=rays.device)
    code = _build.library().block_cull_launch(
        rays.data_ptr(), box_rows.data_ptr(), n_live.data_ptr(),
        out.data_ptr(), nt, nb_pad, _build.stream_ptr(rays.device))
    _build.check(code, "block_cull")
    block_cull.launches += 1
    return out


block_cull.launches = 0


# ----------------------------------------------------------------- pair cull

def pair_cull_plain(pair_tile, pair_sb, n_real, rays, sb_boxes,
                    chunk: int = 4096):
    """Plain PyTorch pair cull: i32[L] 8-bit masks (see module doc)."""
    n_pairs = pair_tile.shape[0]
    dev = rays.device
    tiles = rays.reshape(-1, TILE, RAY_COLS)
    bits = (1 << torch.arange(SB, device=dev, dtype=torch.int32))
    out = torch.empty((n_pairs,), dtype=torch.int32, device=dev)
    for s in range(0, n_pairs, chunk):
        pt = pair_tile[s:s + chunk].long()
        boxes = sb_boxes[pair_sb[s:s + chunk].long()]       # [C, 8, SB]
        r = tiles[pt]                                       # [C, 128, 16]
        lo = tuple(boxes[:, None, i, :] for i in range(3))  # [C, 1, SB]
        hi = tuple(boxes[:, None, 3 + i, :] for i in range(3))
        tn8 = _slab_entry(_ray_cols(r), lo, hi).amin(dim=1)  # [C, SB]
        out[s:s + chunk] = torch.where(tn8 < INF_DIST, bits, 0).sum(
            dim=1, dtype=torch.int32)
    real = torch.arange(n_pairs, device=dev) < as_count(n_real, dev)
    return torch.where(real, out, 0)


def pair_cull(pair_tile, pair_sb, n_real, rays, sb_boxes):
    """8-bit block masks i32[L] of a tile-major (tile, superblock) pair
    list; ``sb_boxes`` f32[nsb+1, 8, 8] (``sb_box_table``), ``n_real`` i32
    scalar tensor on the rays' device."""
    if rays.device.type == "cpu":
        return pair_cull_plain(pair_tile, pair_sb, n_real, rays, sb_boxes)
    n_pairs = pair_tile.shape[0]
    dev = rays.device
    check_tensor(rays, torch.float32, (rays.shape[0], RAY_COLS), "rays")
    check_tensor(sb_boxes, torch.float32,
                 (sb_boxes.shape[0], BOX_ROWS, SB), "sb_boxes", dev)
    check_tensor(pair_tile, torch.int32, (n_pairs,), "pair_tile", dev)
    check_tensor(pair_sb, torch.int32, (n_pairs,), "pair_sb", dev)
    check_tensor(n_real, torch.int32, None, "n_real", dev, numel=1)
    out = torch.empty((n_pairs,), dtype=torch.int32, device=dev)
    if n_pairs == 0:
        return out
    code = _build.library().pair_cull_launch(
        pair_tile.data_ptr(), pair_sb.data_ptr(), n_real.data_ptr(),
        rays.data_ptr(), sb_boxes.data_ptr(), out.data_ptr(), n_pairs,
        _build.stream_ptr(dev))
    _build.check(code, "pair_cull")
    pair_cull.launches += 1
    return out


pair_cull.launches = 0
