"""Model-parallel intersection: the packet query over superblock ranges.

The counterpart of ``prismarine_core_tpu.parallel.shard_intersect``
(``intersector="pallas_sharded"``).  Each model shard owns a contiguous
range of the Morton-sorted superblocks: their planes, block and
superblock AABBs, slot -> triangle ids, re-evaluation vertices and
slot-ordered shading attributes, all split on the leading axis (padded
to a multiple of the model-parallel degree with empty superblocks).  A
shard runs the whole single-device query on its own range (the sort, the
culls, the compactions and the pair intersector on the hand-written
kernels, with the caller's knobs), re-evaluates its winners against its
own vertices (differentiably) and interpolates their surface fields; the
per-ray results then min-reduce over "model" on the kernel's detached
distance, the lowest shard winning ties.  Rays split over "data".

On a mesh that one process drives (``parallel/mesh.py``) the JAX
package's ``all_gather('model')`` is a stack of the shards' results moved
to the ray shard's device, and the reduce a ``torch.argmin`` with
``gather``, differentiable through the gather and through ``.to``; where a
row's shards lie in several processes the stack is a differentiable
all-gather over the row's process group (``mesh.model_stack``), and each
process computes only its own shards.  No replicated triangle soup is
read by the query or by shading: ``distribute_scene`` reduces the scene's
soup to an 8-row husk.
"""

from __future__ import annotations

import dataclasses

import torch

from prismarine_core_tpu_torch.accel.lbvh import EMPTY_BOX
from prismarine_core_tpu_torch.accel.packet import (
    SB, PacketSet, _run_packet_pallas, build_packet_set)
from prismarine_core_tpu_torch.ops.intersect import Hit, moller_trumbore
from prismarine_core_tpu_torch.parallel.mesh import (
    Mesh, MeshArray, assemble_rows, model_stack, row_slices, to_device)
from prismarine_core_tpu_torch.utils.config import INF_DIST
from prismarine_core_tpu_torch.utils.math import cross, take_rows

#: the fields replicated over the mesh (the rest split over "model")
_REPLICATED = ("root_lo", "root_hi")


@dataclasses.dataclass
class ShardedPackets:
    """The packet set re-laid out for "model"-axis sharding.

    Every array leads with the superblock axis (padded to a multiple of
    the model-parallel degree); ``planes`` carries no sentinel row, each
    shard appends its own.  Built by ``build_sharded_packets`` the fields
    are tensors; placed by ``shard_packets`` they are ``MeshArray``s."""

    planes: torch.Tensor    # f32[nsb, 16, SB*BLOCK]
    sb_lo: torch.Tensor     # f32[nsb, 3]
    sb_hi: torch.Tensor     # f32[nsb, 3]
    block_lo: torch.Tensor  # f32[nsb, SB, 3]
    block_hi: torch.Tensor  # f32[nsb, SB, 3]
    orig: torch.Tensor      # i32[nsb, SB*BLOCK] slot -> global triangle id
    #: Morton-sorted vertices for the differentiable re-evaluation
    tv0: torch.Tensor       # f32[nsb, SB*BLOCK, 3]
    tv1: torch.Tensor
    tv2: torch.Tensor
    #: per-slot shading attributes (zero when built without a soup)
    n0: torch.Tensor        # f32[nsb, SB*BLOCK, 3]
    n1: torch.Tensor
    n2: torch.Tensor
    t0: torch.Tensor        # f32[nsb, SB*BLOCK, 2]
    t1: torch.Tensor
    t2: torch.Tensor
    mat_id: torch.Tensor    # i32[nsb, SB*BLOCK]
    root_lo: torch.Tensor   # f32[3]
    root_hi: torch.Tensor   # f32[3]

    @property
    def n_superblocks(self) -> int:
        return self.planes.shape[0]

    def local(self, j: int, device) -> "ShardedPackets":
        """Model shard ``j``'s arrays on ``device`` (placed packets)."""
        return ShardedPackets(**{f.name: getattr(self, f.name).local(j, device)
                                 for f in dataclasses.fields(self)})


def build_sharded_packets(bvh, mp: int, soup=None) -> ShardedPackets:
    """The BVH's packet set in the shard layout, nsb padded to a multiple
    of ``mp`` with empty superblocks (``EMPTY_BOX`` boxes, zero planes,
    slot ids -1).  ``soup``: also put the shading attributes in slot
    order; None leaves them zero (intersection only).  Differentiable in
    ``bvh.tv0..2`` (and the soup's attributes)."""
    ps = build_packet_set(bvh)
    nsb = ps.n_superblocks
    pad = -(-nsb // mp) * mp - nsb
    dev = ps.planes.device

    planes = ps.planes[:-1]                      # strip the sentinel
    block_lo = ps.block_lo.reshape(nsb, SB, 3)
    block_hi = ps.block_hi.reshape(nsb, SB, 3)
    orig = ps.slot_orig.reshape(nsb, -1)
    sb_lo, sb_hi = ps.sb_lo, ps.sb_hi
    spb = orig.shape[1]                          # slots per superblock

    def slots_per_sb(tv):                        # [S,3] -> [nsb,spb,3]
        want = nsb * spb
        if want > tv.shape[0]:
            tv = torch.cat([tv, torch.zeros((want - tv.shape[0], 3),
                                            dtype=tv.dtype, device=dev)])
        return tv[:want].reshape(nsb, spb, 3)

    tv0, tv1, tv2 = (slots_per_sb(v) for v in (bvh.tv0, bvh.tv1, bvh.tv2))
    valid = ps.slot_orig >= 0
    gi = torch.clamp(ps.slot_orig, min=0).long()

    def attr_per_sb(name, width):
        """A per-triangle attribute in slot order [nsb, spb(, width)]."""
        shape = (nsb, spb, width) if width > 1 else (nsb, spb)
        if soup is None:
            dt = torch.int32 if width == 1 else torch.float32
            return torch.zeros(shape, dtype=dt, device=dev)
        a = take_rows(getattr(soup, name), gi)
        a = torch.where(valid[:, None] if a.dim() == 2 else valid, a, 0)
        return a.reshape(shape)

    n0, n1, n2 = (attr_per_sb(k, 3) for k in ("n0", "n1", "n2"))
    t0, t1, t2 = (attr_per_sb(k, 2) for k in ("t0", "t1", "t2"))
    mat_id = attr_per_sb("mat_id", 1)
    if pad:
        def grow(x, fill):
            return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]),
                                            fill, dtype=x.dtype,
                                            device=dev)])
        planes = grow(planes, 0.0)
        block_lo, block_hi = grow(block_lo, EMPTY_BOX), grow(block_hi,
                                                             EMPTY_BOX)
        sb_lo, sb_hi = grow(sb_lo, EMPTY_BOX), grow(sb_hi, EMPTY_BOX)
        orig = grow(orig, -1)
        tv0, tv1, tv2, n0, n1, n2, t0, t1, t2 = (
            grow(x, 0.0) for x in (tv0, tv1, tv2, n0, n1, n2, t0, t1, t2))
        mat_id = grow(mat_id, 0)
    return ShardedPackets(planes=planes, sb_lo=sb_lo, sb_hi=sb_hi,
                          block_lo=block_lo, block_hi=block_hi, orig=orig,
                          tv0=tv0, tv1=tv1, tv2=tv2, n0=n0, n1=n1, n2=n2,
                          t0=t0, t1=t1, t2=t2, mat_id=mat_id,
                          root_lo=bvh.lo[0], root_hi=bvh.hi[0])


def shard_packets(sp: ShardedPackets, mesh: Mesh) -> ShardedPackets:
    """Place the packet arrays on the mesh: the superblock axis over
    "model" (each shard's piece on every distinct device of its mesh
    column), the root box replicated."""
    return ShardedPackets(**{
        f.name: MeshArray(getattr(sp, f.name), mesh,
                          None if f.name in _REPLICATED else "model")
        for f in dataclasses.fields(sp)})


def constrain_packets(sp: ShardedPackets, mesh: Mesh) -> ShardedPackets:
    """``shard_packets`` for packets built inside a differentiated loss
    (the train step's rebuild): the placement is differentiable, so
    gradients flow from each shard's re-evaluation back to the
    vertices."""
    return shard_packets(sp, mesh)


def _local_query(sp_local: ShardedPackets, o, d, t_cap, any_hit: bool,
                 order=None, query_kw: dict | None = None):
    """One shard's query against its superblock range.

    Returns (t_key, t, u, v, tri, surf, order): ``t_key`` the kernel's
    detached distance (the reduce key; t_cap on a miss), t/u/v the
    winning slot re-evaluated against the shard's own vertices
    (differentiable), ``surf`` f32[R, 12] its interpolated surface
    fields, ``order`` the coherence sort.  For ``any_hit`` only t_key,
    tri and order are computed (the rest None)."""
    nsb_l = sp_local.planes.shape[0]
    planes = torch.cat([sp_local.planes.detach(),
                        torch.zeros((1,) + tuple(sp_local.planes.shape[1:]),
                                    dtype=torch.float32,
                                    device=sp_local.planes.device)])
    ps = PacketSet(
        block_lo=sp_local.block_lo.detach().reshape(nsb_l * SB, 3),
        block_hi=sp_local.block_hi.detach().reshape(nsb_l * SB, 3),
        sb_lo=sp_local.sb_lo.detach(), sb_hi=sp_local.sb_hi.detach(),
        planes=planes, slot_orig=sp_local.orig.reshape(-1))
    t_key, slot, order = _run_packet_pallas(
        sp_local.root_lo.detach(), sp_local.root_hi.detach(), ps,
        o.detach(), d.detach(), t_cap.detach(), any_hit=any_hit,
        order=order, **(query_kw or {}))
    six = torch.clamp(slot, min=0).long()
    tri = torch.where(slot >= 0, ps.slot_orig[six], -1)
    if any_hit:
        return t_key, None, None, None, tri, None, order

    def at(a, width):
        return take_rows(a.reshape(-1, width), six)

    v0l, v1l, v2l = (at(v, 3) for v in (sp_local.tv0, sp_local.tv1,
                                        sp_local.tv2))
    t, u, v, _ = moller_trumbore(o, d, v0l, v1l, v2l)
    hitm = tri >= 0
    t = torch.where(hitm, t, INF_DIST)
    u = torch.where(hitm, u, 0.0)
    v = torch.where(hitm, v, 0.0)

    # the shard owns its slots' attributes, so the interpolated surface
    # rides the reduce and nothing downstream reads a replicated soup
    w_b = (1.0 - u - v)[:, None]
    u_b, v_b = u[:, None], v[:, None]
    ns = (w_b * at(sp_local.n0, 3) + u_b * at(sp_local.n1, 3)
          + v_b * at(sp_local.n2, 3))
    e1 = v1l - v0l
    e2 = v2l - v0l
    ng = cross(e1, e2)
    t0l, t1l, t2l = (at(x, 2) for x in (sp_local.t0, sp_local.t1,
                                        sp_local.t2))
    duv1 = t1l - t0l
    duv2 = t2l - t0l
    uv = w_b * t0l + u_b * t1l + v_b * t2l
    det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    small = torch.abs(det_uv) < 1e-12
    rdet = torch.where(small, 0.0,
                       1.0 / torch.where(small, 1.0, det_uv))[:, None]
    tang = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * rdet
    mat_f = take_rows(sp_local.mat_id.reshape(-1), six).to(torch.float32)
    surf = torch.cat([ns, ng, tang, uv, mat_f[:, None]], dim=-1)
    surf = torch.where(hitm[:, None], surf, 0.0)
    return t_key, t, u, v, tri, surf, order


def _pick(stacked, k):
    """Each ray's entry of shard ``k`` from [mp, R, ...] (differentiable)."""
    idx = k.reshape((1, -1) + (1,) * (stacked.dim() - 2))
    return torch.gather(stacked, 0, idx.expand((1,) + stacked.shape[1:]))[0]


def make_sharded_query(mesh: Mesh, any_hit: bool = False,
                       use_order: bool = False,
                       query_kw: dict | None = None):
    """The sharded closest-hit or any-hit query: rays over "data",
    superblock ranges over "model", one min-reduce over "model".

    Returns fn(sp, o, d, t_cap[, perm, inv_perm]) -> (t, u, v, tri, surf,
    perm, inv_perm) on ``o``'s device; t/u/v and surf are differentiable
    in the shards' vertices and in the rays (None for ``any_hit``).  The
    coherence order comes per data row (its values row-local indices, as
    the JAX package's per-shard order), concatenated over the rows;
    ``use_order`` takes it back in, for the same bounce's shadow query."""
    mp = mesh.shape["model"]

    def query(sp, o, d, t_cap, *order_in):
        out_dev = o.device
        slices = row_slices(mesh, o.shape[0])
        rows = {}
        for i, sl in enumerate(slices):
            if sl.start == sl.stop or not mesh.participates(i):
                continue
            row_dev = mesh.row_device(i)
            shards, row_order = {}, None
            for j in range(mp):
                if not mesh.is_local(i, j):
                    continue
                dev = mesh.devices[i][j]
                order = (tuple(x[sl].to(dev) for x in order_in)
                         if use_order else None)
                res = _local_query(sp.local(j, dev), o[sl].to(dev),
                                   d[sl].to(dev), t_cap[sl].to(dev),
                                   any_hit, order=order, query_kw=query_kw)
                shards[j] = [None if x is None else x.to(row_dev)
                             for x in res[:6]]
                if row_order is None:
                    row_order = res[6]
            first = next(iter(shards.values()))

            def stacked(f):
                return model_stack(mesh, i, {j: s[f] for j, s in
                                             shards.items()})
            # on ties the lowest shard wins; misses carry t_key == t_cap
            k = torch.argmin(stacked(0), dim=0)
            rows[i] = [None if first[f] is None else
                       _pick(stacked(f), k).to(out_dev) for f in range(1, 6)]
            rows[i] += [x.to(out_dev) for x in row_order]
        t, u, v, tri, surf, perm, inv_perm = (
            None if rows[min(rows)][f] is None else
            assemble_rows(mesh, {i: r[f] for i, r in rows.items()}, slices)
            for f in range(7))
        return t, u, v, tri, surf, perm, inv_perm

    return query


def distribute_scene(scene, mesh: Mesh, shard_soup: bool = True,
                     shard_textures: bool = True):
    """``scene`` distributed over ``mesh`` for
    ``intersector="pallas_sharded"``.

    The packet structures (planes, AABBs, slot maps, re-evaluation
    vertices and the slot-ordered shading attributes) split over "model";
    materials, lights and the environment stay whole on the mesh's first
    device.  ``shard_soup`` (default) reduces the triangle soup to an
    8-row husk: the sharded query interpolates surfaces shard-locally, so
    nothing reads it.  ``shard_soup=False`` keeps the whole soup for flows
    that use it (the train step, whose parameters are the vertices).
    ``shard_textures`` (no-op on the texture-less stub): the texture
    stack's ``data`` and ``quad`` split over "model" on the texture axis,
    padded with white to a multiple of mp, and the stack is marked so
    every fetch is a shard-local gather plus one sum
    (``models/textures.py:_sharded_texel_rows``)."""
    mp = mesh.shape["model"]
    sp = shard_packets(
        build_sharded_packets(scene.bvh, mp, soup=scene.triangles), mesh)
    if shard_soup:
        husk = type(scene.triangles)(**{
            f.name: torch.zeros((8,) + tuple(x.shape[1:]), dtype=x.dtype,
                                device=x.device)
            for f in dataclasses.fields(scene.triangles)
            for x in [getattr(scene.triangles, f.name)]})
        scene = dataclasses.replace(scene, triangles=husk)
    tex = scene.textures
    shard_tex = (shard_textures and tex is not None
                 and not getattr(tex, "stub", False))
    scene = to_device(dataclasses.replace(
        scene, packets=None, bvh=None, textures=None if shard_tex else tex),
        mesh.first)
    if shard_tex:
        npad = (-tex.count) % mp

        def pad_put(arr):
            if arr is None:
                return None
            if npad:
                arr = torch.cat([arr, torch.ones(
                    (npad,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                    device=arr.device)])
            return MeshArray(arr, mesh, "model")

        sizes = tex.sizes
        if sizes is not None:
            if npad:
                sizes = torch.cat([sizes, torch.ones(
                    (npad, 2), dtype=torch.int32, device=sizes.device)])
            sizes = sizes.to(mesh.first)
        tex = dataclasses.replace(tex, data=pad_put(tex.data),
                                  quad=pad_put(tex.quad), sizes=sizes,
                                  mesh=mesh)
        scene = dataclasses.replace(scene, textures=tex)
    return dataclasses.replace(scene, packets=sp, bvh=None, mesh=mesh)


def sharded_intersect_closest(mesh: Mesh, sp: ShardedPackets, o, d,
                              t_cap=None, return_surface: bool = False,
                              return_order: bool = False,
                              query_kw: dict | None = None):
    """Closest hit over the sharded scene, differentiable: each model
    shard re-evaluates its own winners.  ``return_surface`` also returns
    the carried surface fields (dict ns, ng, tang, uv, mat_id);
    ``return_order`` the per-row coherence sort for this bounce's shadow
    query.  ``query_kw``: the single-device knobs forwarded to each
    shard's ``_run_packet_pallas`` (the integrator passes
    ``_pallas_kwargs(cfg)``)."""
    if t_cap is None:
        t_cap = torch.full((o.shape[0],), INF_DIST, device=o.device)
    query = make_sharded_query(mesh, any_hit=False, query_kw=query_kw)
    t, u, v, tri, surf, perm, inv_perm = query(sp, o, d, t_cap)
    hit = Hit(t=t, tri=tri, u=u, v=v)
    out = (hit,)
    if return_surface:
        out = out + (dict(ns=surf[:, 0:3], ng=surf[:, 3:6],
                          tang=surf[:, 6:9], uv=surf[:, 9:11],
                          mat_id=surf[:, 11].to(torch.int32)),)
    if return_order:
        out = out + ((perm, inv_perm),)
    return out if len(out) > 1 else hit


def sharded_occluded(mesh: Mesh, sp: ShardedPackets, o, d, t_max,
                     order=None, query_kw: dict | None = None):
    """Any-hit query over the sharded scene (no gradient); ``order``
    reuses a closest query's per-row coherence sort."""
    query = make_sharded_query(mesh, any_hit=True,
                               use_order=order is not None,
                               query_kw=query_kw)
    args = (o.detach(), d.detach(), t_max.detach())
    if order is not None:
        args = args + tuple(x.detach() for x in order)
    _, _, _, tri, _, _, _ = query(sp, *args)
    return tri >= 0
