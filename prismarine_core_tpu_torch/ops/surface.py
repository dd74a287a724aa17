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
code.  Both are functions of the soup's and the material table's tensors
and the hit's (``_tensors``), bound to the kind of work, so
``ops/dispatch.py`` chooses between them, and a gradient through the
kernel's fields is the plain version's: the seam's backward runs the plain
version again on the same inputs and differentiates it.

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

import types

import torch

from prismarine_core_tpu_torch import _build
from prismarine_core_tpu_torch._build import check_tensor
from prismarine_core_tpu_torch.models.materials import (
    _ARRAY_FIELDS, MaterialTable)
from prismarine_core_tpu_torch.ops import dispatch
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


#: the soup's fields the surface reads, in the order of the plain
#: version's and the launch's tensor arguments; the material table's
#: (``_ARRAY_FIELDS``) follow, then the hit's tri, u and v
_SOUP_FIELDS = ("v0", "v1", "v2", "n0", "n1", "n2", "t0", "t1", "t2",
                "mat_id")


def _scene_tensors(scene) -> tuple:
    """The soup's and the material table's tensors the surface reads."""
    soup, mats = scene.triangles, scene.materials
    return (*(getattr(soup, f) for f in _SOUP_FIELDS),
            *(getattr(mats, f) for f in _ARRAY_FIELDS))


def _tensors(scene, hit) -> tuple:
    """The tensors the surface reads, in ``_surface_plain``'s order."""
    return (*_scene_tensors(scene), hit.tri, hit.u, hit.v)


def _fields(out) -> tuple:
    """(ns, ng, uv, tang, mat) of the flat outputs of ``_surface_plain``
    or ``launch_surface``."""
    return (*out[:4], MaterialTable(*out[4:]))


def unit_or(v, fallback):
    """``v`` normalised where that is finite, else ``fallback`` (a
    tensor of ``v``'s shape or a scalar)."""
    n = pm.normalize(v)
    return torch.where(torch.isfinite(n).all(-1, keepdim=True), n, fallback)


def _surface_plain(stub: bool, kinds, v0, v1, v2, n0, n1, n2, t0, t1, t2,
                   mat_id, *rest):
    """The surface at each hit in torch, as a function of the tensors of
    ``_tensors``: (ns, ng, uv, tang or None, then the hit triangle's
    material row field by field)."""
    *mats, tri, u, v = rest
    tri = torch.clamp(tri, min=0).long()
    w = (1.0 - u - v)[:, None]
    uu = u[:, None]
    vv = v[:, None]
    ns = w * n0[tri] + uu * n1[tri] + vv * n2[tri]
    p0 = pm.take_rows(v0, tri)
    e1 = pm.take_rows(v1, tri) - p0
    e2 = pm.take_rows(v2, tri) - p0
    ng = pm.normalize(pm.cross(e1, e2))
    # geometric normal where the shading normal is degenerate
    ns = unit_or(ns, ng)
    tang = None
    if stub:
        # uv only feeds texture fetches: zeros on texture-less scenes
        uv = torch.zeros((tri.shape[0], 2), dtype=torch.float32,
                         device=tri.device)
    else:
        tc0 = pm.take_rows(t0, tri)
        tc1 = pm.take_rows(t1, tri)
        tc2 = pm.take_rows(t2, tri)
        uv = w * tc0 + uu * tc1 + vv * tc2
        if kinds[3]:
            # tangent-space normal mapping: the tangent from the uv
            # derivatives
            duv1 = tc1 - tc0
            duv2 = tc2 - tc0
            det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
            rdet = pm.safe_rcp(det_uv)[:, None]
            tang = pm.normalize((e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2])
                                * rdet)
    row = mat_id[tri].long()
    return (ns, ng, uv, tang, *(pm.take_rows(f, row) for f in mats))


def surface_fields_plain(scene, hit, kinds=None):
    """The surface at each hit in torch: (ns f32[R,3], ng f32[R,3], uv
    f32[R,2], tang f32[R,3] or None, mat), ``mat`` a ``MaterialTable`` of
    each ray's material row.  ``kinds``: the materials' ``kinds_bound``
    (read on a textured scene: ``tang`` only where a bump map is bound)."""
    return _fields(_surface_plain(_stub(scene), kinds,
                                  *_tensors(scene, hit)))


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


def _records_of(xs: tuple):
    """(soup, uvs, mats) records of the soup's and the material table's
    tensors ``xs`` (``_scene_tensors``), packed at the first call and then
    reused while every one keeps its storage, layout and version
    (``_build.Records``)."""
    def pack():
        soup = types.SimpleNamespace(**dict(zip(_SOUP_FIELDS, xs)))
        mats = MaterialTable(*xs[len(_SOUP_FIELDS):])
        return (pack_soup(soup, mats.ior.shape[0]), pack_uvs(soup),
                pack_materials(mats))
    return _records.get(xs, pack)


def surface_records(scene):
    """(soup, uvs, mats) records of ``scene`` (``_records_of``)."""
    return _records_of(_scene_tensors(scene))


def launch_surface(stub: bool, kinds, *xs):
    """``_surface_plain``'s outputs from one launch of ``csrc/surface.cu``
    on the packed records of ``xs`` (``_tensors``), into tensors of the
    plain version's shapes and dtypes (the material fields as [R,4] rows
    and [R] columns, as ``take_rows`` gathers them).  No autograd: the
    caller is ``dispatch.fused``."""
    tri, u, v = (x.detach() for x in xs[-3:])
    dev = u.device
    r = tri.shape[0]
    check_tensor(tri, torch.int32, (r,), "hit.tri", dev)
    check_tensor(u, torch.float32, (r,), "hit.u", dev)
    check_tensor(v, torch.float32, (r,), "hit.v", dev)
    soup, uvs, mats = _records_of(xs[:-3])
    n_tris, n_mats = soup.shape[0], mats.shape[0]
    if n_tris == 0 or n_mats == 0:
        raise ValueError(f"{n_tris} triangles, {n_mats} materials: the "
                         "kernel needs at least one of each")
    check_tensor(soup, torch.float32, (n_tris, SOUP_WORDS), "soup records",
                 dev)
    check_tensor(uvs, torch.float32, (n_tris, UV_WORDS), "uv records", dev)
    check_tensor(mats, torch.float32, (n_mats, MAT_WORDS),
                 "material records", dev)
    textured = not stub
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
    return (ns, ng, uv, tang, *rows, ior, *tex)


def surface_fields(scene, hit, kinds=None):
    """``surface_fields_plain``'s fields: on a CUDA card from one launch of
    ``csrc/surface.cu`` (``launch_surface``), whether or not a gradient
    flows through them; on CPU tensors from ``surface_fields_plain``."""
    return _fields(dispatch.fused(*dispatch.bind(
        launch_surface, _surface_plain, _stub(scene), kinds),
        *_tensors(scene, hit)))
