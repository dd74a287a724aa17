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
CPU, and launches the CUDA kernel when they lie on a card
(``ops/dispatch.py`` chooses), inside the span ``pc.kernel.<name>``
(``utils/profiling.py``: its count is the kernel's launches).  The plain
versions use the kernels' operation order and are exact references for
them.

Both kernels first reject whole (tile, box) entries with an interval test
on the tile's ray bounds and run the slab test only on the survivors
(``csrc/cull.cu`` proves the test conservative).  ``tile_ray_bounds`` and
``tile_reject`` are that test in plain torch, deciding exactly as the
kernels do; ``block_cull_rejects`` and ``pair_cull_survivors`` give the
entries each kernel settles by it and the ones it tests exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from prismarine_core_tpu_torch import _build
from prismarine_core_tpu_torch._build import check_tensor
from prismarine_core_tpu_torch.accel.lbvh import EMPTY_BOX
from prismarine_core_tpu_torch.ops import dispatch
from prismarine_core_tpu_torch.ops.sb_intersect import (
    RAY_COLS, RC_IVX, RC_IVY, RC_IVZ, RC_OX, RC_OY, RC_OZ, RC_TCAP, SB,
    TILE, as_count)
from prismarine_core_tpu_torch.utils.config import INF_DIST
from prismarine_core_tpu_torch.utils.profiling import span

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


# ------------------------------------------------------ the tile-level reject

@dataclasses.dataclass
class TileBounds:
    """Per-tile bounds over the live lanes (t_cap > 0) of 128-ray tiles."""

    o_lo: torch.Tensor    # f32[T, 3] origin range (+inf / -inf: no live lane)
    o_hi: torch.Tensor
    iv_lo: torch.Tensor   # f32[T, 3] inverse-direction range
    iv_hi: torch.Tensor
    tc_max: torch.Tensor  # f32[T] largest t_cap (0: no live lane)
    finite: torch.Tensor  # bool[T] every live lane's o and iv finite

    def __getitem__(self, idx):
        return TileBounds(*(getattr(self, f.name)[idx]
                            for f in dataclasses.fields(self)))


def tile_ray_bounds(rays):
    """``TileBounds`` of every 128-row tile of the ray matrix ``rays``
    f32[T*128, 16] (the kernels' tile reduction)."""
    r = rays.reshape(-1, TILE, RAY_COLS)
    tc = r[..., RC_TCAP]
    live = (tc > 0.0)[..., None]
    o = r[..., RC_OX:RC_OZ + 1]
    iv = r[..., RC_IVX:RC_IVZ + 1]
    inf = torch.tensor(float("inf"), device=rays.device)
    bad = live & ~(torch.isfinite(o) & torch.isfinite(iv))
    return TileBounds(
        o_lo=torch.where(live, o, inf).amin(1),
        o_hi=torch.where(live, o, -inf).amax(1),
        iv_lo=torch.where(live, iv, inf).amin(1),
        iv_hi=torch.where(live, iv, -inf).amax(1),
        tc_max=torch.where(live[..., 0], tc, 0.0).amax(1),
        finite=~bad.any(dim=(1, 2)))


def tile_reject(bounds: TileBounds, lo, hi):
    """bool[T, N]: True where the tile's interval test proves that no live
    ray of tile t passes box n (``csrc/cull.cu``: ``tile_rejects``, the same
    rounded arithmetic, so the same decisions).  ``bounds`` over T tiles;
    ``lo``, ``hi`` f32[T or 1, N, 3].

    On an axis where iv has one strict sign over the tile, the rounded
    ``(plane - o) * iv`` at the corners of the origin and iv ranges bounds
    every ray's near and far slab distance (rounding is monotone); the
    entry is rejected when the largest near bound exceeds the smallest far
    bound, the far bound is below 0 or the near bound exceeds the tile's
    largest t_cap.  Other axes take no part.  A box with lo > hi on an axis
    is never rejected, nor is any box of a tile with a non-finite o or iv on
    a live lane; every box of a tile with no live lane is."""
    def col(x):
        return x[:, None, :]                              # [T, 1, 3]
    iv_lo, iv_hi = col(bounds.iv_lo), col(bounds.iv_hi)
    pos = iv_lo > 0.0
    takes = pos | (iv_hi < 0.0)
    o_near = torch.where(pos, col(bounds.o_hi), col(bounds.o_lo))
    o_far = torch.where(pos, col(bounds.o_lo), col(bounds.o_hi))
    dn = torch.where(pos, lo, hi) - o_near
    df = torch.where(pos, hi, lo) - o_far
    nl = torch.where(takes, torch.minimum(dn * iv_lo, dn * iv_hi),
                     -float("inf")).amax(-1)
    fu = torch.where(takes, torch.maximum(df * iv_lo, df * iv_hi),
                     float("inf")).amin(-1)
    tc_max = bounds.tc_max[:, None]
    fails = (nl > fu) | (fu < 0.0) | (nl > tc_max)
    ordered = (lo <= hi).all(-1)
    return torch.where(tc_max > 0.0,
                       fails & ordered & bounds.finite[:, None], True)


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


def _check_rows_aligned(rays):
    """The kernels read ray rows as 16-byte vectors."""
    if rays.data_ptr() % 16:
        raise ValueError("rays must start on a 16-byte boundary")


def _box_cols(box_rows):
    """f32[8, nb_pad] box rows -> (lo, hi) f32[1, nb_pad, 3]."""
    return box_rows[0:3].T[None], box_rows[3:6].T[None]


def block_cull_rejects(rays, box_rows, n_live):
    """bool[nt, nb_pad]: the (tile, box) entries the block-cull kernel
    settles without a slab test (every tile >= ``n_live``, and the
    rejects of ``tile_reject``)."""
    nt = rays.shape[0] // TILE - 1
    rej = tile_reject(tile_ray_bounds(rays[:nt * TILE]),
                      *_box_cols(box_rows))
    live = torch.arange(nt, device=rays.device) < as_count(n_live,
                                                            rays.device)
    return rej | ~live[:, None]


def block_cull(rays, box_rows, n_live):
    """Per-(tile, box) entry distance f32[nt, nb_pad]; ``rays``
    f32[(nt+1)*128, 16], ``box_rows`` f32[8, nb_pad] (nb_pad % 128 == 0),
    ``n_live`` i32 scalar tensor on the rays' device."""
    return dispatch.choose(rays, launch_block_cull, block_cull_plain)(
        rays, box_rows, n_live)


def launch_block_cull(rays, box_rows, n_live):
    """``block_cull_plain``'s distances from one launch of
    ``csrc/cull.cu``."""
    n_rows = rays.shape[0]
    nb_pad = box_rows.shape[1]
    check_tensor(rays, torch.float32, (n_rows, RAY_COLS), "rays")
    check_tensor(box_rows, torch.float32, (BOX_ROWS, nb_pad), "box_rows",
                 rays.device)
    check_tensor(n_live, torch.int32, None, "n_live", rays.device, numel=1)
    if n_rows % TILE or nb_pad % TILE:
        raise ValueError("rays rows and nb_pad must be multiples of 128")
    _check_rows_aligned(rays)
    nt = n_rows // TILE - 1
    out = torch.empty((nt, nb_pad), dtype=torch.float32, device=rays.device)
    with span("pc.kernel.block_cull"):
        code = _build.library().block_cull_launch(
            rays.data_ptr(), box_rows.data_ptr(), n_live.data_ptr(),
            out.data_ptr(), nt, nb_pad, _build.stream_ptr(rays.device))
    _build.check(code, "block_cull")
    return out


def derive_pair_tables(tn_blk, nsb: int):
    """Block entry distances f32[nt, nb_pad] (``block_cull`` over block
    rows) -> (sb_mask, sb_tn, mask8), the counterpart of
    ``prismarine_core_tpu/ops/pallas_cull.py:derive_pair_tables``:

    * sb_mask bool[nt, nsb]: the tile lists the superblock (some block
      passes);
    * sb_tn f32[nt, nsb]: the least entry distance over its blocks (a
      front-to-back lower bound, not the superblock box's own entry);
    * mask8 i32[nt, nsb]: bit k set when some ray passes block sb*8 + k.
    """
    nt = tn_blk.shape[0]
    blk = tn_blk[:, :nsb * SB].reshape(nt, nsb, SB)
    bits = 1 << torch.arange(SB, device=tn_blk.device, dtype=torch.int32)
    mask8 = torch.where(blk < INF_DIST, bits, 0).sum(dim=2,
                                                     dtype=torch.int32)
    return mask8 != 0, blk.amin(dim=2), mask8


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


def pair_cull_survivors(pair_tile, pair_sb, n_real, rays, sb_boxes):
    """bool[L, 8]: the blocks of each real pair that the pair-cull kernel
    tests exactly (those ``tile_reject`` keeps); none for pairs >=
    ``n_real``."""
    dev = rays.device
    boxes = sb_boxes[pair_sb.long()]                         # [L, 8, SB]
    rej = tile_reject(tile_ray_bounds(rays)[pair_tile.long()],
                      boxes[:, 0:3].transpose(1, 2),
                      boxes[:, 3:6].transpose(1, 2))
    real = torch.arange(pair_tile.shape[0], device=dev) < as_count(n_real,
                                                                   dev)
    return ~rej & real[:, None]


def pair_cull(pair_tile, pair_sb, n_real, rays, sb_boxes):
    """8-bit block masks i32[L] of a tile-major (tile, superblock) pair
    list; ``sb_boxes`` f32[nsb+1, 8, 8] (``sb_box_table``), ``n_real`` i32
    scalar tensor on the rays' device."""
    return dispatch.choose(rays, launch_pair_cull, pair_cull_plain)(
        pair_tile, pair_sb, n_real, rays, sb_boxes)


def launch_pair_cull(pair_tile, pair_sb, n_real, rays, sb_boxes):
    """``pair_cull_plain``'s masks from one launch of ``csrc/cull.cu``."""
    n_pairs = pair_tile.shape[0]
    dev = rays.device
    check_tensor(rays, torch.float32, (rays.shape[0], RAY_COLS), "rays")
    check_tensor(sb_boxes, torch.float32,
                 (sb_boxes.shape[0], BOX_ROWS, SB), "sb_boxes", dev)
    check_tensor(pair_tile, torch.int32, (n_pairs,), "pair_tile", dev)
    check_tensor(pair_sb, torch.int32, (n_pairs,), "pair_sb", dev)
    check_tensor(n_real, torch.int32, None, "n_real", dev, numel=1)
    _check_rows_aligned(rays)
    out = torch.empty((n_pairs,), dtype=torch.int32, device=dev)
    if n_pairs == 0:
        return out
    with span("pc.kernel.pair_cull"):
        code = _build.library().pair_cull_launch(
            pair_tile.data_ptr(), pair_sb.data_ptr(), n_real.data_ptr(),
            rays.data_ptr(), sb_boxes.data_ptr(), out.data_ptr(), n_pairs,
            _build.stream_ptr(dev))
    _build.check(code, "pair_cull")
    return out
