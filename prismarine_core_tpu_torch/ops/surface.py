"""The surface at the hit: the kernel wrapper, its records and its plain
version.

``surface_fields`` gives each ray the fields shading reads at its hit
(garbage where it missed: callers mask): the shading normal interpolated
from the soup's vertex normals (the geometric normal where that is not
finite), the geometric normal, the uv (interpolated from the texcoords on a
textured scene, zeros on the texture-less stub stack), the tangent where
the materials bind a bump map, and the hit triangle's material row.  On a
CUDA tensor it launches the hand-written kernel ``csrc/surface.cu`` (one
lane a ray); on a CPU tensor it runs ``surface_fields_plain``, the torch
code.  A gradient through the kernel's fields is the plain version's:
``_Surface``'s backward runs the plain version again on the same inputs
and differentiates it.

The kernel reads the soup and the material table as packed records
(``pack_soup``, ``pack_uvs``, ``pack_materials``): 16-byte-aligned rows
with the integer fields stored as float bits, built here in torch and kept
for the last scene served (``surface_records``) under a key that sees every
source tensor's storage and version, so a refit or any in-place change
packs them anew.

The kernel is the port's own: the JAX package interpolates the surface in
XLA, which fuses it.  It computes the plain version's fields bit for bit,
missed lanes included.
"""

from __future__ import annotations

import dataclasses

import torch

from prismarine_core_tpu_torch import _build
from prismarine_core_tpu_torch._build import check_tensor
from prismarine_core_tpu_torch.models.materials import (
    _ARRAY_FIELDS, MaterialTable)
from prismarine_core_tpu_torch.utils import math as pm
from prismarine_core_tpu_torch.utils.profiling import span

#: float32 words of a packed soup record (v0.xyz, mat_id, v1.xyz, 0,
#: v2.xyz, 0, n0.xyz, 0, n1.xyz, 0, n2.xyz, 0), of a texcoord record (t0,
#: t1, t2, 0, 0) and of a material record (diffuse, specular, emissive,
#: transmission, ior, tex_diffuse, tex_specular, tex_emissive, tex_bump,
#: 0, 0, 0)
SOUP_WORDS, UV_WORDS, MAT_WORDS = 24, 8, 24


def _stub(scene) -> bool:
    return getattr(scene.textures, "stub", False)


def surface_fields_plain(scene, hit, kinds=None):
    """The surface at each hit in torch: (ns f32[R,3], ng f32[R,3], uv
    f32[R,2], tang f32[R,3] or None, mat), ``mat`` a ``MaterialTable`` of
    each ray's material row.  ``kinds``: the materials' ``kinds_bound``
    (read on a textured scene: ``tang`` only where a bump map is bound)."""
    tri = torch.clamp(hit.tri, min=0).long()
    soup = scene.triangles
    ns, ng, uv, tang = _geometry_plain(soup, hit, tri, _stub(scene), kinds)
    return ns, ng, uv, tang, scene.materials.lookup(soup.mat_id[tri].long())


def _geometry_plain(soup, hit, tri, stub, kinds):
    """(ns, ng, uv, tang) of ``surface_fields_plain``, ``tri`` the hit
    triangles clamped to 0."""
    w = (1.0 - hit.u - hit.v)[:, None]
    uu = hit.u[:, None]
    vv = hit.v[:, None]
    ns = pm.normalize(w * soup.n0[tri] + uu * soup.n1[tri]
                      + vv * soup.n2[tri])
    v0 = pm.take_rows(soup.v0, tri)
    e1 = pm.take_rows(soup.v1, tri) - v0
    e2 = pm.take_rows(soup.v2, tri) - v0
    ng = pm.normalize(pm.cross(e1, e2))
    # geometric normal where the shading normal is degenerate
    ns = torch.where(torch.isfinite(ns).all(-1, keepdim=True), ns, ng)
    tang = None
    if stub:
        # uv only feeds texture fetches: zeros on texture-less scenes
        uv = torch.zeros((tri.shape[0], 2), dtype=torch.float32,
                         device=tri.device)
    else:
        t0 = pm.take_rows(soup.t0, tri)
        t1 = pm.take_rows(soup.t1, tri)
        t2 = pm.take_rows(soup.t2, tri)
        uv = w * t0 + uu * t1 + vv * t2
        if kinds[3]:
            # tangent-space normal mapping: the tangent from the uv
            # derivatives
            duv1 = t1 - t0
            duv2 = t2 - t0
            det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
            rdet = pm.safe_rcp(det_uv)[:, None]
            tang = pm.normalize((e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2])
                                * rdet)
    return ns, ng, uv, tang


def pack_soup(soup, n_mats: int):
    """The kernel's soup records, f32[T, 24]: (v0.xyz, mat_id, v1.xyz, 0,
    v2.xyz, 0, n0.xyz, 0, n1.xyz, 0, n2.xyz, 0), the material id as its
    int32 bits, clamped into the table (the plain version's index raises
    on an id outside it; the kernel must not read outside it)."""
    zero = torch.zeros((soup.v0.shape[0], 1), dtype=torch.float32,
                       device=soup.v0.device)
    mat = torch.clamp(soup.mat_id.to(torch.int32), 0, n_mats - 1)
    return torch.cat([soup.v0, mat[:, None].view(torch.float32),
                      soup.v1, zero, soup.v2, zero, soup.n0, zero,
                      soup.n1, zero, soup.n2, zero], dim=1)


def pack_uvs(soup):
    """The kernel's texcoord records, f32[T, 8]: (t0, t1, t2, 0, 0)."""
    zero = torch.zeros((soup.t0.shape[0], 2), dtype=torch.float32,
                       device=soup.t0.device)
    return torch.cat([soup.t0, soup.t1, soup.t2, zero], dim=1)


def pack_materials(mats):
    """The kernel's material records, f32[M, 24]: (diffuse, specular,
    emissive, transmission, ior, tex_diffuse, tex_specular, tex_emissive,
    tex_bump, 0, 0, 0), the texture ids as their int32 bits."""
    ids = [getattr(mats, f).to(torch.int32)[:, None].view(torch.float32)
           for f in ("tex_diffuse", "tex_specular", "tex_emissive",
                     "tex_bump")]
    zero = torch.zeros((mats.ior.shape[0], 3), dtype=torch.float32,
                       device=mats.ior.device)
    return torch.cat([mats.diffuse, mats.specular, mats.emissive,
                      mats.transmission, mats.ior[:, None], *ids, zero],
                     dim=1)


#: the packed records of the last scene served
_records = _build.Records()


def surface_records(scene):
    """(soup, uvs, mats) records of ``scene``, packed at the first call and
    then reused while every source tensor keeps its storage, layout and
    version (``_build.Records``)."""
    soup, mats = scene.triangles, scene.materials
    return _records.get(
        (soup.v0, soup.v1, soup.v2, soup.n0, soup.n1, soup.n2, soup.t0,
         soup.t1, soup.t2, soup.mat_id,
         *(getattr(mats, f) for f in _ARRAY_FIELDS)),
        lambda: (pack_soup(soup, mats.ior.shape[0]), pack_uvs(soup),
                 pack_materials(mats)))




def launch_kernel(scene, hit, kinds=None):
    """``surface_fields_plain``'s fields from one launch of
    ``csrc/surface.cu`` on the scene's packed records, into tensors of the
    plain version's shapes and dtypes (the material fields as [R,4] rows
    and [R] columns, as ``lookup`` gathers them).  No autograd: the
    caller is ``_Surface.forward``."""
    dev = hit.u.device
    tri, u, v = hit.tri.detach(), hit.u.detach(), hit.v.detach()
    r = tri.shape[0]
    check_tensor(tri, torch.int32, (r,), "hit.tri", dev)
    check_tensor(u, torch.float32, (r,), "hit.u", dev)
    check_tensor(v, torch.float32, (r,), "hit.v", dev)
    soup, uvs, mats = surface_records(scene)
    n_tris, n_mats = soup.shape[0], mats.shape[0]
    if n_tris == 0 or n_mats == 0:
        raise ValueError(f"{n_tris} triangles, {n_mats} materials: the "
                         "kernel needs at least one of each")
    check_tensor(soup, torch.float32, (n_tris, SOUP_WORDS), "soup records",
                 dev)
    check_tensor(uvs, torch.float32, (n_tris, UV_WORDS), "uv records", dev)
    check_tensor(mats, torch.float32, (n_mats, MAT_WORDS),
                 "material records", dev)
    textured = not _stub(scene)
    bump = textured and bool(kinds[3])

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    ns, ng, tang = empty(r, 3), empty(r, 3), empty(r, 3) if bump else None
    uv = empty(r, 2)
    rows = [empty(r, 4) for _ in range(4)]
    ior, tex = empty(r), empty(4, r, dtype=torch.int32)
    if r:
        with span("pc.kernel.surface"):
            code = _build.library().surface_fields_launch(
                soup.data_ptr(), uvs.data_ptr(), mats.data_ptr(),
                tri.data_ptr(), u.data_ptr(), v.data_ptr(), ns.data_ptr(),
                ng.data_ptr(), uv.data_ptr(),
                tang.data_ptr() if bump else None,
                *(t.data_ptr() for t in rows), ior.data_ptr(),
                tex.data_ptr(), r, int(textured), int(bump),
                _build.stream_ptr(dev))
        _build.check(code, "surface_fields_launch")
    return ns, ng, uv, tang, MaterialTable(*rows, ior, *tex)


#: the soup's and the material table's fields the surface differentiates
#: (the material id and the texture ids are integers)
_SOUP_FIELDS = ("v0", "v1", "v2", "n0", "n1", "n2", "t0", "t1", "t2")
_MAT_FLOATS = _ARRAY_FIELDS[:5]
#: for each float output of ``_Surface`` (ns, ng, uv, tang, then the
#: material's float fields), the ``_inputs`` it depends on: the plain
#: version's output requires grad where one of them does (ns falls back
#: to ng; the stub's uv is zeros and depends on nothing)
_V, _N, _T, _UV = (0, 1, 2), (3, 4, 5), (6, 7, 8), (14, 15)
_DEPENDS = (_V + _N + _UV, _V, _T + _UV, _V + _T,
            *((9 + k,) for k in range(len(_MAT_FLOATS))))


def _inputs(scene, hit):
    """The tensors the surface differentiates, in ``_Surface``'s order:
    the soup's vertices, normals and texcoords, the material table's float
    fields, the hit's barycentrics."""
    soup, mats = scene.triangles, scene.materials
    return (*(getattr(soup, f) for f in _SOUP_FIELDS),
            *(getattr(mats, f) for f in _MAT_FLOATS), hit.u, hit.v)


class _Surface(torch.autograd.Function):
    """The kernel's fields as a function of ``_inputs``: the forward is one
    ``launch``; the backward runs the parts of ``surface_fields_plain``
    that receive a gradient again on the saved inputs and differentiates
    them, so a gradient through the surface is the plain version's."""

    @staticmethod
    def forward(ctx, launch, scene, hit, kinds, *xs):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*xs)
        ctx.args = (scene, hit, kinds)
        ns, ng, uv, tang, mat = launch(scene, hit, kinds)
        outs = (ns, ng, uv, tang, *(getattr(mat, f) for f in _ARRAY_FIELDS))
        # an output the plain version would not differentiate stays out
        # of the graph, so no shading downstream of it is differentiated
        needs = ctx.needs_input_grad[4:]
        stub = _stub(scene)
        ctx.mark_non_differentiable(*(
            y for k, y in enumerate(outs) if y is not None and (
                k >= len(_DEPENDS) or (k == 2 and stub)
                or not any(needs[i] for i in _DEPENDS[k]))))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        scene, hit, kinds = ctx.args
        needs = ctx.needs_input_grad[4:]
        xs = [x.detach().requires_grad_(n)
              for x, n in zip(ctx.saved_tensors, needs)]
        m = len(_SOUP_FIELDS)
        soup = dataclasses.replace(scene.triangles,
                                   **dict(zip(_SOUP_FIELDS, xs[:m])))
        hit = dataclasses.replace(hit, u=xs[-2], v=xs[-1])
        # the plain version again, only the parts that receive a gradient
        outs = [None] * len(_DEPENDS)
        with torch.enable_grad():
            tri = torch.clamp(hit.tri, min=0).long()
            if any(g is not None for g in grads[:4]):
                outs[:4] = _geometry_plain(soup, hit, tri, _stub(scene),
                                           kinds)
            if any(g is not None for g in grads[4:len(_DEPENDS)]):
                mat_id = soup.mat_id[tri].long()
                for k, x in enumerate(xs[m:m + len(_MAT_FLOATS)]):
                    if grads[4 + k] is not None:
                        outs[4 + k] = pm.take_rows(x, mat_id)
        pairs = [(y, g) for y, g in zip(outs, grads)
                 if g is not None and y is not None and y.requires_grad]
        wanted = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(
            [y for y, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(wanted))
        return (None, None, None, None,
                *(next(got) if need else None for need in needs))


def fused(launch, scene, hit, kinds=None):
    """``surface_fields_plain``'s fields as ``launch(scene, hit, kinds)``
    computes them, differentiable as the plain version is (``_Surface``)."""
    xs = _inputs(scene, hit)
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        # nothing to differentiate: the launch without autograd's
        # bookkeeping (~0.15 ms of host time a call on the H100's host)
        return launch(scene, hit, kinds)
    out = _Surface.apply(launch, scene, hit, kinds, *xs)
    return (*out[:4], MaterialTable(*out[4:]))


def surface_fields(scene, hit, kinds=None):
    """``surface_fields_plain``'s fields: on a CUDA card from one launch of
    ``csrc/surface.cu`` (``launch_kernel``), whether or not a gradient
    flows through them; on CPU tensors from ``surface_fields_plain``."""
    if hit.u.device.type != "cuda":
        return surface_fields_plain(scene, hit, kinds)
    return fused(launch_kernel, scene, hit, kinds)
