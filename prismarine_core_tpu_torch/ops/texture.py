"""The texture maps at the hit: the kernel wrapper and its plain version.

``texture_fields`` fetches, for each kind of map some material binds
(``kinds``, the materials' ``kinds_bound``: diffuse, specular, emissive,
bump), the hit material's map at the hit's uv and applies it: the diffuse
map scales the albedo (alpha included), the specular map's G and B the
roughness and the metallic, the emissive map the emission, and the bump
map's tangent-space normal replaces the shading normal.  On a CUDA tensor
it launches the hand-written kernel ``csrc/texture.cu`` (one lane a ray,
every bound kind in one launch); on a CPU tensor it runs
``texture_plain``, the torch code, whose fetch and use of each kind run in
a span of their own, ``pc.texture.<kind>``.  Both are functions of the
fields at the hit and the stack's tensors (``_tensors``), bound to the
kinds and the stack's layout, so ``ops/dispatch.py`` chooses between them,
and a gradient through the kernel's fields is the plain version's: the
seam's backward runs the plain version again on the same inputs and
differentiates it.

Two stacks keep the plain version on every device, as what the code sees
in its inputs decides: a stack split over a mesh (``stack.mesh``; its
fetch gathers shard by shard) and the bicubic filter
(``texture_filter="bicubic"``: four bilinear taps at weight-shifted
coordinates, ``models/textures.py:sample_bicubic``).

The kernel is the port's own: the JAX package fetches in XLA.  It computes
the plain version's fields bit for bit, missed lanes included.
"""

from __future__ import annotations

import types

import torch

from prismarine_core_tpu_torch import _build
from prismarine_core_tpu_torch._build import check_tensor
from prismarine_core_tpu_torch.models.textures import (
    TextureStack, sample_bicubic, sample_bilinear)
from prismarine_core_tpu_torch.ops import dispatch
from prismarine_core_tpu_torch.utils import math as pm
from prismarine_core_tpu_torch.utils.profiling import span

#: the material fields the maps read, in the order of ``_tensors``
_MAT_FIELDS = ("diffuse", "specular", "emissive", "tex_diffuse",
               "tex_specular", "tex_emissive", "tex_bump")


def untextured(ns, mat):
    """The fields of ``texture_plain``'s order where no map is bound: the
    shading normal and the material's own albedo, emission, roughness and
    metallic (views of its rows)."""
    return (ns, mat.diffuse, mat.emissive[:, :3], mat.specular[:, 1],
            mat.specular[:, 2])


def texture_plain(stack, texture_filter, kinds, ns, tang, uv, mat):
    """Each bound kind's fetch and its use at the hit in torch: (ns f32[R,3],
    albedo f32[R,4], emissive f32[R,3], roughness f32[R], metallic f32[R]).
    ``mat`` holds the hit material's rows (``_MAT_FIELDS``), ``tang`` the
    tangent (read where a bump map is bound)."""
    ns, albedo4, emissive, rough, metal = untextured(ns, mat)
    sample_tex = (sample_bicubic if texture_filter == "bicubic"
                  else sample_bilinear)
    if kinds[3]:
        with span("pc.texture.bump"):
            # tangent-space normal mapping: the bump texture's normal
            # in the frame of the tangent (from the uv derivatives)
            btex = sample_tex(stack, mat.tex_bump, uv)
            bitan = pm.cross(ns, tang)
            nt = btex[:, :3] * 2.0 - 1.0
            n_mapped = pm.normalize(tang * nt[:, 0:1]
                                    + bitan * nt[:, 1:2]
                                    + ns * nt[:, 2:3])
            ns = torch.where((mat.tex_bump >= 0)[:, None], n_mapped, ns)
    if kinds[0]:
        with span("pc.texture.diffuse"):
            tex = sample_tex(stack, mat.tex_diffuse, uv)
            albedo4 = torch.where((mat.tex_diffuse >= 0)[:, None],
                                  albedo4 * tex, albedo4)
    if kinds[2]:
        with span("pc.texture.emissive"):
            etex = sample_tex(stack, mat.tex_emissive, uv)
            emissive = torch.where((mat.tex_emissive >= 0)[:, None],
                                   emissive * etex[:, :3], emissive)
    if kinds[1]:
        with span("pc.texture.specular"):
            has_stex = mat.tex_specular >= 0
            stex = sample_tex(stack, mat.tex_specular, uv)
            rough = torch.where(has_stex, rough * stex[:, 1], rough)
            metal = torch.where(has_stex, metal * stex[:, 2], metal)
    return ns, albedo4, emissive, rough, metal


def _tensors(stack, ns, tang, uv, mat, kinds) -> tuple:
    """The tensors the maps read, in ``_texture_plain``'s order: ns, uv,
    the material's ``_MAT_FIELDS``, the stack's texels, then the tangent
    where a bump map is bound and the stack's size table and corner quads
    where it has them."""
    return (ns, uv, *(getattr(mat, f) for f in _MAT_FIELDS), stack.data,
            *((tang,) if kinds[3] else ()),
            *(t for t in (stack.sizes, stack.quad) if t is not None))


def _inputs(kinds, sized, packed, xs):
    """(ns, tang or None, uv, mat, stack) of the tensors ``xs``
    (``_tensors``)."""
    n = len(_MAT_FIELDS)
    ns, uv = xs[:2]
    mat = types.SimpleNamespace(**dict(zip(_MAT_FIELDS, xs[2:2 + n])))
    rest = list(xs[2 + n:])
    data = rest.pop(0)
    tang = rest.pop(0) if kinds[3] else None
    sizes = rest.pop(0) if sized else None
    quad = rest.pop(0) if packed else None
    return ns, tang, uv, mat, TextureStack(data=data, sizes=sizes, quad=quad)


def _changed(kinds, fields) -> tuple:
    """The fields of ``texture_plain``'s order that the bound kinds change
    (ns: bump; albedo: diffuse; emissive: emissive; roughness and
    metallic: specular), None for the others."""
    keep = (kinds[3], kinds[0], kinds[2], kinds[1], kinds[1])
    return tuple(f if k else None for f, k in zip(fields, keep))


def _texture_plain(kinds, sized, packed, *xs):
    """``texture_plain`` (bilinear) as a function of the tensors of
    ``_tensors``: the fields the bound kinds change, None for the
    others."""
    ns, tang, uv, mat, stack = _inputs(kinds, sized, packed, xs)
    return _changed(kinds, texture_plain(stack, "bilinear", kinds, ns, tang,
                                         uv, mat))


#: the corner quads of the last stack served that has none of its own
_quads = _build.Records()


def _quads_of(stack):
    """The corner quads of ``stack`` (``TextureStack.with_packed_corners``),
    its own or, for a stack without them, packed at the first call and
    then reused while its texels and size table keep their storage,
    layout and version (``_build.Records``)."""
    if stack.quad is not None:
        return stack.quad
    srcs = tuple(t for t in (stack.data, stack.sizes) if t is not None)
    return _quads.get(srcs, lambda: stack.with_packed_corners().quad)


def _kernel_arg(x, dtype, shape, name, dev):
    """``x`` as the kernel reads it: detached, contiguous and 16-byte
    aligned (its float4 and float2 loads), checked."""
    x = x.detach().contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    check_tensor(x, dtype, shape, name, dev)
    return x


def launch_texture(kinds, sized, packed, *xs):
    """``_texture_plain``'s outputs from one launch of ``csrc/texture.cu``
    on the tensors ``xs`` (``_tensors``), into new tensors of the plain
    version's shapes.  The kernel reads the stack's corner quads, packed
    once (``_quads_of``) for a stack without them.  No autograd: the
    caller is ``dispatch.fused``."""
    ns, tang, uv, mat, stack = _inputs(kinds, sized, packed, xs)
    dev = ns.device
    r = ns.shape[0]
    f32, i32 = torch.float32, torch.int32
    ns = _kernel_arg(ns, f32, (r, 3), "ns", dev)
    uv = _kernel_arg(uv, f32, (r, 2), "uv", dev)
    if kinds[3]:
        tang = _kernel_arg(tang, f32, (r, 3), "tang", dev)
    rows = {f: _kernel_arg(getattr(mat, f), f32, (r, 4), f, dev)
            for f, k in (("diffuse", 0), ("specular", 1), ("emissive", 2))
            if kinds[k]}
    ids = [_kernel_arg(getattr(mat, f), i32, (r,), f, dev) if kinds[k]
           else None for k, f in enumerate(_MAT_FIELDS[3:])]
    n_tex, h, w, c = stack.data.shape
    if c != 4 or n_tex == 0:
        raise ValueError(f"stack.data has shape {tuple(stack.data.shape)}: "
                         "the kernel needs [N>0, H, W, 4]")
    sizes = (_kernel_arg(stack.sizes, i32, (n_tex, 2), "stack.sizes", dev)
             if sized else None)
    quad = _kernel_arg(_quads_of(stack), f32, (n_tex, h, w, 16), "stack.quad",
                       dev)

    def empty(*shape):
        return torch.empty(shape, dtype=f32, device=dev)
    outs = (empty(r, 3) if kinds[3] else None,
            empty(r, 4) if kinds[0] else None,
            empty(r, 3) if kinds[2] else None,
            empty(r) if kinds[1] else None,
            empty(r) if kinds[1] else None)

    def ptr(t):
        return None if t is None else t.data_ptr()
    flags = sum(1 << k for k in range(4) if kinds[k])
    if r:
        with span("pc.kernel.texture"):
            code = _build.library().texture_fields_launch(
                quad.data_ptr(), ptr(sizes), uv.data_ptr(), ns.data_ptr(),
                ptr(tang), *(ptr(rows.get(f)) for f in
                             ("diffuse", "specular", "emissive")),
                *(ptr(t) for t in ids), *(ptr(t) for t in outs), r, n_tex,
                h, w, flags, _build.stream_ptr(dev))
        _build.check(code, "texture_fields_launch")
    return outs


def texture_fields(stack, texture_filter, kinds, ns, tang, uv, mat):
    """``texture_plain``'s fields: on a CUDA card from one launch of
    ``csrc/texture.cu`` (``launch_texture``), whether or not a gradient
    flows through them; on CPU tensors, on a stack split over a mesh and
    under the bicubic filter from ``texture_plain``."""
    if stack.mesh is not None or texture_filter == "bicubic":
        return texture_plain(stack, texture_filter, kinds, ns, tang, uv, mat)
    out = dispatch.fused(*dispatch.bind(
        launch_texture, _texture_plain, tuple(kinds),
        stack.sizes is not None, stack.quad is not None),
        *_tensors(stack, ns, tang, uv, mat, kinds))
    return tuple(u if o is None else o
                 for o, u in zip(out, untextured(ns, mat)))
