"""Wavefront OBJ/MTL ingest.

The counterpart of ``prismarine_core_tpu.models.obj_loader``: numpy at
load time, emitting the padded TriangleSoup + MaterialTable +
TextureStack the renderer consumes, on ``device`` (None is the CUDA
card).

Supported: v/vn/vt, polygonal ``f`` with triangle-fan splitting, negative
indices, usemtl/mtllib.  MTL: Kd/Ks/Ke/Ns/d/Tr/Ni plus the four texture
kinds (map_Kd/map_Ks/map_Ke/map_bump|bump|norm), decoded with Pillow when
it is importable; a map whose decoder is missing is skipped.  Geometry
goes through the native C++ parser (``prismarine_core_tpu_torch.native``)
or this module's Python parser: ``use_native`` None takes the native one
when it builds, True requires it (and raises without it), False never
uses it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from prismarine_core_tpu_torch.models.geometry import TriangleSoup
from prismarine_core_tpu_torch.models.materials import MaterialTable
from prismarine_core_tpu_torch.models.textures import TextureStack
from prismarine_core_tpu_torch.utils.device import resolve_device


def _parse_mtl(path: str) -> dict[str, dict]:
    mats: dict[str, dict] = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].lower()
            if key == "newmtl":
                cur = {"name": parts[1] if len(parts) > 1 else ""}
                mats[cur["name"]] = cur
            elif cur is None:
                continue
            elif key == "kd" and len(parts) >= 4:
                cur["diffuse"] = tuple(float(x) for x in parts[1:4])
            elif key == "ks" and len(parts) >= 4:
                ks = tuple(float(x) for x in parts[1:4])
                # metallic-ish proxy: spec strength
                cur["metallic"] = float(np.clip(max(ks), 0.0, 1.0))
            elif key == "ke" and len(parts) >= 4:
                cur["emissive"] = tuple(float(x) for x in parts[1:4])
            elif key == "ns" and len(parts) >= 2:
                # shininess -> roughness (rough ~ sqrt(2/(ns+2)))
                ns = float(parts[1])
                cur["roughness"] = float(np.sqrt(2.0 / (ns + 2.0)))
            elif key == "d" and len(parts) >= 2:
                cur["alpha"] = float(parts[1])
            elif key == "tr" and len(parts) >= 2:
                cur["alpha"] = 1.0 - float(parts[1])
            elif key == "ni" and len(parts) >= 2:
                cur["ior"] = float(parts[1])
            elif key in ("map_kd", "map_ks", "map_ke") and len(parts) >= 2:
                cur[key] = parts[-1]
            elif key in ("map_bump", "bump", "norm") and len(parts) >= 2:
                cur["map_bump"] = parts[-1]
    return mats


def _try_load_image(path: str):
    """RGBA f32 in [0, 1], or None when the file or Pillow is missing or
    the file does not decode."""
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGBA"), np.float32) / 255.0
    except (OSError, ValueError):
        return None


#: MTL texture statement -> MaterialTable texture slot (diffuse, specular,
#: emissive, bump)
_MTL_TEX_SLOTS = (("map_kd", "tex_diffuse"), ("map_ks", "tex_specular"),
                  ("map_ke", "tex_emissive"), ("map_bump", "tex_bump"))


def _build_materials(mat_names, mtl: dict, base: str):
    """MTL dicts -> MaterialTable dicts + decoded image list."""
    images: list = []
    path_cache: dict[str, int] = {}
    mat_dicts = []
    for name in mat_names:
        d = dict(mtl.get(name, {}))
        d.setdefault("diffuse", (0.7, 0.7, 0.7))
        for mtl_key, slot in _MTL_TEX_SLOTS:
            if mtl_key not in d:
                continue
            p = os.path.join(base, d[mtl_key])
            if p not in path_cache:
                img = _try_load_image(p)
                path_cache[p] = -1 if img is None else len(images)
                if img is not None:
                    images.append(img)
            if path_cache[p] >= 0:
                d[slot] = path_cache[p]
        mat_dicts.append(d)
    if not mat_dicts:
        mat_dicts.append({"diffuse": (0.7, 0.7, 0.7)})
    return mat_dicts, images


def _tables(mat_dicts, images, texture_resolution, device):
    mats = MaterialTable.build(mat_dicts, device=device)
    textures = (TextureStack.from_images(images, texture_resolution,
                                         device=device)
                if images else TextureStack.empty(device=device))
    return mats, textures


def load_obj(path: str, scale: float = 1.0, capacity: int | None = None,
             texture_resolution: int = 256, use_native: bool | None = None,
             device=None) -> Tuple[TriangleSoup, MaterialTable,
                                   TextureStack]:
    """Parse an OBJ file into (TriangleSoup, MaterialTable, TextureStack)
    on ``device`` (None is the CUDA card).  ``scale`` multiplies the
    positions.  ``use_native``: None parses natively when the library
    builds, else in Python; True requires the native parser (raises
    RuntimeError when it cannot be built or loaded); False parses in
    Python."""
    device = resolve_device(device)
    if use_native is not False:
        from prismarine_core_tpu_torch import native
        lib = native.library() if use_native else native.get_lib()
        if lib is not None:
            parsed = native.parse_obj_native(os.path.abspath(path), lib)
            if parsed is not None:
                return _assemble_native(parsed, path, scale, capacity,
                                        texture_resolution, device)
            if use_native:
                raise ValueError(f"no faces found in {path}")
    return _load_obj_python(path, scale, capacity, texture_resolution,
                            device)


def _load_obj_python(path, scale, capacity, texture_resolution, device):
    positions: list = []
    normals: list = []
    texcoords: list = []
    tri_pos: list = []
    tri_nrm: list = []
    tri_uv: list = []
    tri_mat: list = []
    mtl: dict[str, dict] = {}
    mat_order: list[str] = []
    cur_mat = 0
    base = os.path.dirname(os.path.abspath(path))

    def mat_index(name: str) -> int:
        if name not in mat_order:
            mat_order.append(name)
        return mat_order.index(name)

    def index(ids, k, n):
        """0-based index of corner field ``k`` (-1 when absent)."""
        if len(ids) <= k or not ids[k]:
            return -1
        i = int(ids[k])
        return i - 1 if i > 0 else n + i

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v" and len(parts) >= 4:
                positions.append([float(x) for x in parts[1:4]])
            elif key == "vn" and len(parts) >= 4:
                normals.append([float(x) for x in parts[1:4]])
            elif key == "vt" and len(parts) >= 3:
                texcoords.append([float(x) for x in parts[1:3]])
            elif key == "mtllib" and len(parts) >= 2:
                mtl.update(_parse_mtl(os.path.join(base, parts[1])))
            elif key == "usemtl" and len(parts) >= 2:
                cur_mat = mat_index(parts[1])
            elif key == "f" and len(parts) >= 4:
                corners = []
                for vert in parts[1:]:
                    ids = vert.split("/")
                    corners.append((index(ids, 0, len(positions)),
                                    index(ids, 1, len(texcoords)),
                                    index(ids, 2, len(normals))))
                for k in range(1, len(corners) - 1):  # triangle fan
                    tri = (corners[0], corners[k], corners[k + 1])
                    tri_pos.append(tuple(c[0] for c in tri))
                    tri_uv.append(tuple(c[1] for c in tri))
                    tri_nrm.append(tuple(c[2] for c in tri))
                    tri_mat.append(cur_mat)

    if not tri_pos:
        raise ValueError(f"no faces found in {path}")

    pos = np.asarray(positions, np.float32) * scale
    faces = np.asarray(tri_pos, np.int64)
    fn_idx = np.asarray(tri_nrm, np.int64)
    ft_idx = np.asarray(tri_uv, np.int64)
    nf = len(faces)
    soup = TriangleSoup.from_arrays(pos, faces,
                                    mat_ids=np.asarray(tri_mat, np.int32),
                                    capacity=capacity, device=device)

    def pad(x):
        out = np.zeros((soup.capacity, x.shape[1]), np.float32)
        out[:nf] = x
        return torch.as_tensor(out, device=device)

    # OBJ indexes normals and uvs apart from positions: per-corner arrays
    if normals and (fn_idx >= 0).all():
        nrm = np.asarray(normals, np.float32)
        soup = dataclasses.replace(soup, **{
            f"n{k}": pad(nrm[fn_idx[:, k]]) for k in range(3)})
    if texcoords and (ft_idx >= 0).all():
        uv = np.asarray(texcoords, np.float32)
        soup = dataclasses.replace(soup, **{
            f"t{k}": pad(uv[ft_idx[:, k]]) for k in range(3)})

    mat_dicts, images = _build_materials(mat_order, mtl, base)
    return (soup, *_tables(mat_dicts, images, texture_resolution, device))


def _assemble_native(parsed: dict, path: str, scale: float,
                     capacity: int | None, texture_resolution: int,
                     device=None):
    """Materials + soup assembly for the native geometry parse."""
    device = resolve_device(device)
    base = os.path.dirname(os.path.abspath(path))
    mtl = {}
    if parsed["mtllib"]:
        mtl = _parse_mtl(os.path.join(base, parsed["mtllib"]))
    mat_dicts, images = _build_materials(parsed["mat_names"], mtl, base)
    soup = TriangleSoup.from_corners(
        parsed["v0"] * scale, parsed["v1"] * scale, parsed["v2"] * scale,
        parsed["n0"], parsed["n1"], parsed["n2"],
        parsed["t0"], parsed["t1"], parsed["t2"],
        parsed["mat"], capacity=capacity, device=device)
    return (soup, *_tables(mat_dicts, images, texture_resolution, device))
