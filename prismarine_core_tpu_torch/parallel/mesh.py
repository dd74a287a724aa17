"""The device mesh: rays over "data", triangle ranges over "model".

The counterpart of ``prismarine_core_tpu.parallel.mesh``.  The JAX package
drives its ("data", "model") mesh from one process through ``shard_map``;
here the mesh is likewise one process over a 2-D grid of
``torch.device``s, and a device may appear more than once
(``make_mesh(4, model_parallel=2, devices=["cuda:0"] * 4)`` runs the
whole layout on one card; ``["cpu"] * 8`` is the tests' mesh).  The
collectives are explicit tensor operations: a gather over "model" is a
stack of the shards' results moved to the ray shard's device, a sum over
"model" is a sum, and gradients cross devices through autograd (``.to``
is differentiable) where the JAX package relies on GSPMD's all-reduce.

* ``make_sharded_renderer``: rays and sample arrays split over "data" into
  contiguous chunks (as ``P("data")`` splits them); each data row traces
  its chunk on its row's device, and the image comes back on the mesh's
  first device.
* ``shard_scene(shard_triangles=True)``: the brute intersector splits the
  triangle ranges over "model" and takes the closest hit over the ranges
  (the lowest range on ties, which is brute's own rule).
* ``parallel/shard_intersect.py``: the "pallas_sharded" intersector
  (superblock ranges over "model").
* ``make_train_step``: the inverse-rendering step, on one device or on a
  mesh.  Parameters are the material diffuse table, the light colours
  and the vertex positions (per corner, or one shared vertex buffer);
  the loss is the MSE of the rendered image against a target; the step is
  plain SGD.  Every discrete decision is detached as in the JAX package:
  the packet query runs on detached inputs and each hit is re-evaluated
  from the current geometry.  Under "pallas" the loss does not rebuild
  the BVH (rebuild the scene with ``Scene.with_bvh`` between steps to
  follow the geometry); under "pallas_sharded" it rebuilds the BVH and
  the sharded packets from the parameters, as the JAX step does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from prismarine_core_tpu_torch.render.integrator import (
    primary_rays, radiance_image, render_with_samples, trace)
from prismarine_core_tpu_torch.utils.config import (
    RenderConfig, check_supported)
from prismarine_core_tpu_torch.utils.math import take_rows


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``, a bare "cuda" as the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 2-D grid of devices with axes ("data", "model"); ``devices[i][j]``
    is data row i, model shard j.

    One process drives the whole grid unless ``ranks`` is given: then
    ``ranks[i][j]`` is the rank of the process holding position (i, j)
    (``parallel/distributed.py:global_mesh``), ``rank`` this process's,
    ``groups[i]`` the process group of row i's ranks and ``group`` that
    of the mesh's.  A process then computes on its own positions only,
    and takes part in the rows that hold one."""

    devices: tuple
    ranks: tuple | None = None
    rank: int = 0
    groups: tuple | None = None
    group: object = None

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def multi_process(self) -> bool:
        return self.ranks is not None and len(
            {r for row in self.ranks for r in row}) > 1

    def is_local(self, i: int, j: int) -> bool:
        """Position (i, j) belongs to this process."""
        return self.ranks is None or self.ranks[i][j] == self.rank

    def participates(self, i: int) -> bool:
        """Some position of data row ``i`` belongs to this process."""
        return any(self.is_local(i, j) for j in range(self.shape["model"]))

    def row_device(self, i: int) -> torch.device:
        """Where this process traces data row ``i``: its first position in
        the row (model shard 0's device in one process)."""
        return next(self.devices[i][j] for j in range(self.shape["model"])
                    if self.is_local(i, j))

    def owner(self, i: int) -> int:
        """The rank that carries row ``i``'s result and gradient (the
        lowest of its ranks)."""
        return self.rank if self.ranks is None else min(self.ranks[i])

    @property
    def first(self) -> torch.device:
        """Where results land: the device of data row 0, model shard 0 (in
        a mesh over processes, this process's first position)."""
        return next(self.devices[i][j] for i in range(self.shape["data"])
                    for j in range(self.shape["model"])
                    if self.is_local(i, j))

    def row(self, i: int) -> "Mesh":
        """Data row ``i`` as a mesh of one row."""
        if self.ranks is None:
            return Mesh((self.devices[i],))
        group = self.groups[i]
        return Mesh((self.devices[i],), (self.ranks[i],), self.rank,
                    (group,), group)

    def column(self, j: int) -> list:
        """The distinct devices of this process's positions in model shard
        ``j``'s column, in row order (where the shard's arrays are
        resident)."""
        out = []
        for i, row in enumerate(self.devices):
            if self.is_local(i, j) and row[j] not in out:
                out.append(row[j])
        return out


class MeshArray:
    """A tensor laid out on a Mesh: the counterpart of a ``jax.Array`` under
    a ``NamedSharding`` of the ("data", "model") axes.  ``spec="model"``
    (``P("model")``) splits it on its leading axis into one contiguous
    piece per model shard; ``spec=None`` (``P()``) keeps it whole.  Each
    piece is resident once on every distinct device of this process's mesh
    positions that hold it (a mesh that repeats a device holds it there
    once; a mesh over processes, only the pieces of this process's
    positions), as a copy of its own, not a view of the whole.  Placing is
    differentiable: gradients reach the tensor placed."""

    def __init__(self, x: torch.Tensor, mesh: Mesh, spec: str | None):
        mp = mesh.shape["model"]
        if spec not in ("model", None):
            raise ValueError(f"spec {spec!r} is neither 'model' nor None")
        if spec == "model" and x.shape[0] % mp:
            raise ValueError(f"leading axis {x.shape[0]} does not split "
                             f"{mp} ways")
        self.mesh, self.spec = mesh, spec
        self.shape, self.dtype = tuple(x.shape), x.dtype
        if spec == "model":
            n = x.shape[0] // mp
            self.pieces = {(j, dev): x[j * n:(j + 1) * n].to(dev, copy=True)
                           for j in range(mp) for dev in mesh.column(j)}
        else:
            devs = {dev for i, row in enumerate(mesh.devices)
                    for j, dev in enumerate(row) if mesh.is_local(i, j)}
            self.pieces = {(0, dev): x.to(dev, copy=True) for dev in devs}

    def local(self, j: int, device) -> torch.Tensor:
        """Model shard ``j``'s piece (the whole tensor when replicated) on
        ``device``, one of the devices of that shard's column."""
        return self.pieces[(j if self.spec == "model" else 0, device)]

    def shard(self, j: int = 0) -> torch.Tensor:
        """Model shard ``j``'s piece on the first device of its column that
        this process holds (the counterpart of
        ``addressable_shards[j].data``)."""
        return self.local(j, self.mesh.column(j)[0])

    @property
    def nbytes(self) -> int:
        """The bytes of the whole tensor (not of one piece)."""
        return int(np.prod(self.shape)) * self.dtype.itemsize


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              devices=None) -> Mesh:
    """A ("data", "model") mesh of ``n_devices`` devices, ``model_parallel``
    of them to a row.  ``devices`` defaults to every CUDA card and raises
    without one; it may repeat a device (``["cuda:0"] * 4``).  A mesh over
    processes: ``parallel/distributed.py:global_mesh``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: make_mesh() takes every CUDA card; pass "
                "devices=[...] (for example [\"cpu\"] * 8) to build a mesh "
                "elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices) or n % model_parallel:
        raise ValueError(f"{n} devices of {len(devices)} in rows of "
                         f"{model_parallel}")
    mp = model_parallel
    return Mesh(tuple(tuple(devices[i * mp:(i + 1) * mp])
                      for i in range(n // mp)))


def model_stack(mesh: Mesh, i: int, parts: dict) -> torch.Tensor:
    """[mp, ...]: data row ``i``'s per-shard results stacked in shard order,
    from ``parts`` (shard j -> its result on the row's device, for this
    process's shards of the row); the other processes' shards come over
    the row's process group.  Differentiable."""
    mp = len(mesh.devices[i])
    if len(parts) == mp:
        return torch.stack([parts[j] for j in range(mp)])
    from prismarine_core_tpu_torch.parallel.distributed import gather_stack
    group, owners = mesh.groups[i], mesh.ranks[i]
    # each process sends its own shards of the row in shard order, padded
    # to the most that any process of the row holds
    most = max(owners.count(r) for r in group.ranks)
    mine = [parts[j] for j in range(mp) if owners[j] == mesh.rank]
    local = torch.stack(mine + [torch.zeros_like(mine[0])] *
                        (most - len(mine)))
    everyone = gather_stack(local, group)             # [k, most, ...]
    return torch.stack([everyone[group.ranks.index(owners[j]),
                                 owners[:j].count(owners[j])]
                        for j in range(mp)])


def assemble_rows(mesh: Mesh, parts: dict, slices: list) -> torch.Tensor:
    """The per-row results ``parts`` (data row i -> the rows of its slice in
    ``slices``) as one tensor over every row.  On one process, their
    concatenation.  Over processes, every process gets every row, each
    from its owner (``Mesh.owner``), and the gradient reaches only the rows
    this process owns (``parallel/distributed.py`` says why)."""
    if not mesh.multi_process:
        return torch.cat([parts[i] for i in sorted(parts)])
    from prismarine_core_tpu_torch.parallel.distributed import owned_rows
    like = next(iter(parts.values()))
    rows = [i for i, sl in enumerate(slices) if sl.start != sl.stop]
    buf = torch.cat([parts[i] if i in parts else like.new_zeros(
        (slices[i].stop - slices[i].start,) + tuple(like.shape[1:]))
        for i in rows])

    def per_row(value):
        return torch.cat([torch.full((slices[i].stop - slices[i].start,),
                                     value(i), device=buf.device)
                          for i in rows])
    owned = per_row(lambda i: mesh.owner(i) == mesh.rank)
    everywhere = all(set(r) == set(mesh.group.ranks) for r in mesh.ranks)
    if everywhere:                        # every process holds every row
        return owned_rows(buf, None, None, owned)
    return owned_rows(buf, mesh.group,
                      per_row(lambda i: mesh.group.ranks.index(
                          mesh.owner(i))).long(), owned)


def row_slices(mesh: Mesh, n: int) -> list:
    """The contiguous chunk of ``n`` rays each data row takes (the last may
    be shorter, and a row past the end gets an empty one)."""
    chunk = -(-n // mesh.shape["data"])
    return [slice(min(i * chunk, n), min((i + 1) * chunk, n))
            for i in range(mesh.shape["data"])]


def to_device(obj, device):
    """``obj`` with every tensor of its dataclass fields (recursively) on
    ``device``; anything else (mesh-laid arrays, flags) as it is.  On the
    device a tensor already lies on, a no-op; differentiable."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if (dataclasses.is_dataclass(obj) and not isinstance(obj, type)
            and not isinstance(obj, Mesh)):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def shard_scene(scene, mesh: Mesh, shard_triangles: bool = False):
    """``scene`` laid out on ``mesh``: its tensors on the mesh's first
    device (each data row takes its copy as it renders), and with
    ``shard_triangles`` the brute intersector's triangle ranges split over
    "model"."""
    return dataclasses.replace(to_device(scene, mesh.first), mesh=mesh,
                               shard_triangles=shard_triangles)


def _triangle_ranges(soup, mp: int) -> list:
    """The ``mp`` contiguous triangle ranges of "model" (``P("model")``'s
    split, the last one shorter when the capacity does not divide)."""
    chunk = -(-soup.capacity // mp)
    return [(j * chunk, min((j + 1) * chunk, soup.capacity))
            for j in range(mp)]


def _soup_range(soup, lo: int, hi: int, device):
    return type(soup)(**{f.name: getattr(soup, f.name)[lo:hi].to(device)
                         for f in dataclasses.fields(soup)})


def brute_closest_over_ranges(scene, o, d, block: int):
    """The brute closest hit with the triangle ranges over the model
    shards of ``scene.mesh``, rays over its data rows: per ray the closest
    range's hit (``torch.argmin`` over the stacked t: the lowest range on
    ties, as brute breaks them), differentiable through the gather."""
    from prismarine_core_tpu_torch.ops.intersect import (
        Hit, intersect_closest_brute)
    mesh = scene.mesh
    ranges = _triangle_ranges(scene.triangles, mesh.shape["model"])
    slices = row_slices(mesh, o.shape[0])
    out = {}
    for i, sl in enumerate(slices):
        if sl.start == sl.stop or not mesh.participates(i):
            continue
        row_dev = mesh.row_device(i)
        hits = {}
        for j, (lo, hi) in enumerate(ranges):
            if not mesh.is_local(i, j):
                continue
            dev = mesh.devices[i][j]
            h = intersect_closest_brute(
                _soup_range(scene.triangles, lo, hi, dev), o[sl].to(dev),
                d[sl].to(dev), block=block)
            tri = torch.where(h.tri >= 0, h.tri + lo, -1)
            hits[j] = [x.to(row_dev) for x in (h.t, tri, h.u, h.v)]
        stacked = [model_stack(mesh, i, {j: h[f] for j, h in hits.items()})
                   for f in range(4)]
        k = torch.argmin(stacked[0], dim=0)[None]
        out[i] = [torch.gather(x, 0, k)[0].to(o.device) for x in stacked]
    t, tri, u, v = (assemble_rows(mesh, {i: r[f] for i, r in out.items()},
                                  slices) for f in range(4))
    return Hit(t=t, tri=tri, u=u, v=v)


def brute_occluded_over_ranges(scene, o, d, t_max, block: int):
    """The brute any-hit query over the triangle ranges of
    ``scene.mesh``'s model shards: occluded where any range occludes."""
    from prismarine_core_tpu_torch.ops.intersect import occluded_brute
    mesh = scene.mesh
    ranges = _triangle_ranges(scene.triangles, mesh.shape["model"])
    slices = row_slices(mesh, o.shape[0])
    out = {}
    for i, sl in enumerate(slices):
        if sl.start == sl.stop or not mesh.participates(i):
            continue
        parts = {}
        for j, (lo, hi) in enumerate(ranges):
            if not mesh.is_local(i, j):
                continue
            dev = mesh.devices[i][j]
            parts[j] = occluded_brute(
                _soup_range(scene.triangles, lo, hi, dev), o[sl].to(dev),
                d[sl].to(dev), t_max[sl].to(dev),
                block=block).to(mesh.row_device(i))
        out[i] = model_stack(mesh, i, parts).any(dim=0).to(o.device)
    return assemble_rows(mesh, out, slices)


def _on_row(scene, row: Mesh):
    """``scene`` as one data row sees it: its mesh marks (the scene's, the
    sharded texture stack's) set to the row, so the row's queries and
    fetches split over its model shards only."""
    if scene.mesh is not None:
        scene = dataclasses.replace(scene, mesh=row)
    if getattr(scene.textures, "mesh", None) is not None:
        scene = dataclasses.replace(
            scene, textures=dataclasses.replace(scene.textures, mesh=row))
    return scene


def render_rows(mesh: Mesh, scene, camera, cfg: RenderConfig, cam_samples,
                bounce_samples):
    """``render_with_samples`` (interlace stage 0) with the rays split over
    the data rows of ``mesh``: the camera rays made once, each row's
    contiguous chunk traced on the row's device (the scene's replicated
    tensors moved there, a sharded scene seeing the row as its mesh), the
    radiance gathered on the mesh's first device and reduced to the image
    there.  Over processes, each process traces the rows it takes part in
    and every process gets the whole image (``assemble_rows``)."""
    check_supported(cfg)
    first = mesh.first
    camera = to_device(camera, first)
    o, d, active = primary_rays(camera, cfg, cam_samples.to(first))
    slices = row_slices(mesh, o.shape[0])
    parts = {}
    for i, sl in enumerate(slices):
        if sl.start == sl.stop or not mesh.participates(i):
            continue
        dev, row = mesh.row_device(i), mesh.row(i)
        row_scene = _on_row(to_device(scene, dev), row)
        row_cfg = cfg.replace(mesh=row) if cfg.mesh is not None else cfg
        rad, _ = trace(row_scene, row_cfg, o[sl].to(dev), d[sl].to(dev),
                       bounce_samples[:, sl].to(dev),
                       None if active is None else active[sl].to(dev))
        parts[i] = rad.to(first)
    return radiance_image(cfg, assemble_rows(mesh, parts, slices))


def make_sharded_renderer(mesh: Mesh, cfg: RenderConfig,
                          shard_triangles: bool = False):
    """fn(scene, camera, cam_samples, bounce_samples) -> image f32[H,W,3]
    on the mesh's first device, with the rays split over "data"
    (``render_rows``).  ``shard_triangles``: render the scene as
    ``shard_scene(..., shard_triangles=True)`` lays it out."""
    def render(scene, camera, cam_samples, bounce_samples):
        if shard_triangles:
            scene = shard_scene(scene, mesh, shard_triangles=True)
        return render_rows(mesh, scene, camera, cfg, cam_samples,
                           bounce_samples)
    return render


# -- differentiable training step (inverse rendering) ---------------------

def _as_mesh(mesh):
    """``mesh`` as a Mesh, or None for one device: None, a device (or its
    name) or a sequence of one device.  A bare sequence of more devices
    raises: build it with ``make_mesh``."""
    if mesh is None or isinstance(mesh, (Mesh, str, torch.device)):
        return mesh if isinstance(mesh, Mesh) else None
    if len(mesh) != 1:
        raise ValueError(f"a sequence of {len(mesh)} devices is no mesh: "
                         "build one with make_mesh(devices=...)")
    return None


def apply_params(scene, params, vertex_faces=None):
    """``scene`` with the parameters in place of its diffuse table, light
    colours and vertex positions (``"verts"`` through ``vertex_faces``,
    or per corner ``"v0"`` and optionally ``"v1"``, ``"v2"``)."""
    mats = dataclasses.replace(scene.materials, diffuse=params["mat_diffuse"])
    lights = dataclasses.replace(scene.lights, color=params["light_color"])
    tri = scene.triangles
    if "verts" in params:
        v = params["verts"]
        faces = vertex_faces.long()
        tri = dataclasses.replace(tri, v0=take_rows(v, faces[:, 0]),
                                  v1=take_rows(v, faces[:, 1]),
                                  v2=take_rows(v, faces[:, 2]))
    else:
        tri = dataclasses.replace(tri, v0=params["v0"],
                                  v1=params.get("v1", tri.v1),
                                  v2=params.get("v2", tri.v2))
    return dataclasses.replace(scene, materials=mats, lights=lights,
                               triangles=tri)


def rebuild_sharded(scene, cfg: RenderConfig):
    """``scene`` with its BVH and sharded packets rebuilt from its soup
    over ``cfg.mesh`` (the "pallas_sharded" loss does this each step, so
    vertex gradients flow through each shard's re-evaluation)."""
    from prismarine_core_tpu_torch.accel.lbvh import build_bvh
    from prismarine_core_tpu_torch.parallel.shard_intersect import (
        build_sharded_packets, constrain_packets)
    bvh = build_bvh(scene.triangles, leaf_size=cfg.bvh_leaf_size)
    sp = build_sharded_packets(bvh, mp=cfg.mesh.shape["model"],
                               soup=scene.triangles)
    return dataclasses.replace(scene, packets=constrain_packets(sp, cfg.mesh),
                               bvh=None)


def make_train_step(mesh, cfg: RenderConfig, lr: float = 5e-2,
                    shard_triangles: bool = False, lr_scale=None,
                    normalize_grads: bool = False, vertex_faces=None):
    """Inverse-rendering SGD step.  Returns fn(params, scene, camera,
    cam_s, bounce_s, target) -> (params, loss): ``params`` a dict of
    tensors (``init_params`` or ``init_shared_params``), the new params
    detached, ``loss`` a 0-d tensor (the loss before the step).

    ``mesh``: a ``Mesh`` (the rays split over its data rows, gradients
    summed over them by autograd, and over processes by an all-reduce
    where the mesh spans several) or one device (None, a device, or a
    sequence of one).  ``lr_scale``: per-param multipliers of ``lr``
    (vertex positions live on another scale than colours).
    ``normalize_grads``: divide each gradient by its RMS (+1e-8) before
    the step, so ``lr`` is a distance in parameter space.
    ``vertex_faces`` (i32[T,3], ``shared_vertices``): the shared-vertex
    parameterization.  ``shard_triangles`` exists for the JAX signature:
    the triangle split is the scene's (``shard_scene``)."""
    mesh = _as_mesh(mesh)
    del shard_triangles
    lr_scale = lr_scale or {}

    def loss_fn(params, scene, camera, cam_s, bounce_s, target):
        scene = apply_params(scene, params, vertex_faces)
        if cfg.intersector == "pallas_sharded":
            check_supported(cfg)
            scene = rebuild_sharded(scene, cfg)
        if mesh is None:
            img = render_with_samples(scene, camera, cfg, cam_s, bounce_s)
        else:
            img = render_rows(mesh, scene, camera, cfg, cam_s, bounce_s)
        return torch.mean((img - target.to(img.device)) ** 2)

    @torch.no_grad()
    def update(params, grads):
        """One SGD move of every parameter along its gradient."""
        new = {}
        for k, g in grads.items():
            if normalize_grads:
                g = g / (torch.sqrt(torch.mean(g * g)) + 1e-8)
            new[k] = params[k].detach() - lr * lr_scale.get(k, 1.0) * g
        return new

    def step(params, scene, camera, cam_s, bounce_s, target):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = loss_fn(leaves, scene, camera, cam_s, bounce_s, target)
        if mesh is None or not mesh.multi_process:
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        else:
            # each process's share (the rows it owns, its shards), summed
            from prismarine_core_tpu_torch.parallel.distributed import (
                all_reduce)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            grads = {k: all_reduce(torch.zeros_like(v) if g is None else g,
                                   mesh.group)
                     for (k, v), g in zip(leaves.items(), grads)}
        return update(params, grads), loss.detach()

    # the step's two halves, for callers that time or inspect them
    step.loss_fn, step.update = loss_fn, update
    return step


def init_params(scene):
    """Corner-mode parameters: all three vertex fields optimize."""
    return {
        "mat_diffuse": scene.materials.diffuse,
        "light_color": scene.lights.color,
        "v0": scene.triangles.v0,
        "v1": scene.triangles.v1,
        "v2": scene.triangles.v2,
    }


def shared_vertices(soup):
    """Deduplicate the corner soup into (verts f32[V,3], faces i32[T,3]) on
    the soup's device.  Shared vertices are bitwise-equal copies of one
    source vertex, so exact ``np.unique`` recovers the indexed mesh (on
    the host, once, at init)."""
    corners = np.concatenate([soup.v0.detach().cpu().numpy(),
                              soup.v1.detach().cpu().numpy(),
                              soup.v2.detach().cpu().numpy()], axis=0)
    verts, inv = np.unique(corners, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    t = soup.v0.shape[0]
    faces = np.stack([inv[:t], inv[t:2 * t], inv[2 * t:]], axis=1)
    dev = soup.v0.device
    return (torch.as_tensor(verts.astype(np.float32), device=dev),
            torch.as_tensor(faces.astype(np.int32), device=dev))


def init_shared_params(scene, verts):
    return {
        "mat_diffuse": scene.materials.diffuse,
        "light_color": scene.lights.color,
        "verts": verts,
    }
