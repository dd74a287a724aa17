"""glTF 2.0 ingest (.gltf with external or base64 buffers, and .glb).

The counterpart of ``prismarine_core_tpu.models.gltf_loader``: resolve
buffers, bufferViews and accessors at load time into the dense
TriangleSoup, walk the node hierarchy composing transforms, and map
pbrMetallicRoughness materials onto the MaterialTable, on ``device``
(None is the CUDA card).

Supported: POSITION/NORMAL/TEXCOORD_0 attributes; u8/u16/u32 indices and
non-indexed primitives; TRIANGLES mode; node matrix or TRS transforms;
baseColor / metallic-roughness / emissive factors; the four texture slots
(baseColor, metallicRoughness, emissive, normal), decoded with Pillow
when it is importable (a texture that does not decode is skipped).
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct
from typing import Tuple

import numpy as np

from prismarine_core_tpu_torch.models.geometry import TriangleSoup
from prismarine_core_tpu_torch.models.materials import MaterialTable
from prismarine_core_tpu_torch.models.textures import TextureStack
from prismarine_core_tpu_torch.utils.device import resolve_device

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}
_GLB_MAGIC, _CHUNK_JSON, _CHUNK_BIN = 0x46546C67, 0x4E4F534A, 0x004E4942


def _load_glb(path: str):
    with open(path, "rb") as f:
        data = f.read()
    magic, _version, _length = struct.unpack_from("<III", data, 0)
    if magic != _GLB_MAGIC:
        raise ValueError(f"{path} is not a GLB file")
    offset = 12
    gltf = None
    bin_chunk = b""
    while offset < len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8: offset + 8 + clen]
        if ctype == _CHUNK_JSON:
            gltf = json.loads(chunk.decode("utf-8"))
        elif ctype == _CHUNK_BIN:
            bin_chunk = chunk
        offset += 8 + clen
    return gltf, bin_chunk


def _resolve_buffers(gltf: dict, base: str, bin_chunk: bytes):
    bufs = []
    for b in gltf.get("buffers", []):
        uri = b.get("uri")
        if uri is None:
            bufs.append(bin_chunk)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base, uri), "rb") as f:
                bufs.append(f.read())
    return bufs


def _read_accessor(gltf: dict, bufs, idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize * ncomp
    stride = view.get("byteStride", itemsize)
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    raw = bufs[view["buffer"]]
    if stride == itemsize:
        arr = np.frombuffer(raw, dtype, count * ncomp,
                            offset=start).reshape(count, ncomp)
    else:
        arr = np.zeros((count, ncomp), dtype)
        for i in range(count):
            arr[i] = np.frombuffer(raw, dtype, ncomp,
                                   offset=start + i * stride)
    if acc.get("normalized") and dtype != np.float32:
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return arr


def _node_matrix(node: dict) -> np.ndarray:
    """A node's local 4x4 (column-major ``matrix``, or T * R * S)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(list(node["scale"]) + [1.0]).astype(np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.asarray([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
             2 * (x * z + y * w), 0],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
             2 * (y * z - x * w), 0],
            [2 * (x * z - y * w), 2 * (y * z + x * w),
             1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1],
        ], np.float32)
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _decode_image(data) -> np.ndarray | None:
    """RGBA f32 in [0, 1] from a path or bytes, or None when Pillow is
    missing or the image does not decode."""
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        src = io.BytesIO(data) if isinstance(data, bytes) else data
        with Image.open(src) as im:
            return np.asarray(im.convert("RGBA"), np.float32) / 255.0
    except (OSError, ValueError):
        return None


def load_gltf(path: str, scale: float = 1.0, capacity: int | None = None,
              texture_resolution: int = 256, device=None,
              ) -> Tuple[TriangleSoup, MaterialTable, TextureStack]:
    """Parse a .gltf / .glb file into (TriangleSoup, MaterialTable,
    TextureStack) on ``device`` (None is the CUDA card); ``scale``
    scales the scene root."""
    device = resolve_device(device)
    base = os.path.dirname(os.path.abspath(path))
    if path.lower().endswith(".glb"):
        gltf, bin_chunk = _load_glb(path)
    else:
        with open(path, "r") as f:
            gltf = json.load(f)
        bin_chunk = b""
    bufs = _resolve_buffers(gltf, base, bin_chunk)

    images: list = []
    img_cache: dict[int, int] = {}

    def texture_slot(tex_index: int) -> int:
        """glTF texture index -> TextureStack slot (-1: not decodable)."""
        if tex_index not in img_cache:
            img = gltf["images"][gltf["textures"][tex_index]["source"]]
            if "uri" in img and not img["uri"].startswith("data:"):
                arr = _decode_image(os.path.join(base, img["uri"]))
            elif "uri" in img:
                arr = _decode_image(
                    base64.b64decode(img["uri"].split(",", 1)[1]))
            else:
                view = gltf["bufferViews"][img["bufferView"]]
                s = view.get("byteOffset", 0)
                arr = _decode_image(
                    bytes(bufs[view["buffer"]][s: s + view["byteLength"]]))
            img_cache[tex_index] = -1 if arr is None else len(images)
            if arr is not None:
                images.append(arr)
        return img_cache[tex_index]

    mat_dicts = []
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        bc = pbr.get("baseColorFactor", [1, 1, 1, 1])
        d = {
            "diffuse": tuple(bc[:3]),
            "alpha": float(bc[3]),
            "metallic": float(pbr.get("metallicFactor", 1.0)),
            "roughness": float(pbr.get("roughnessFactor", 1.0)),
            "emissive": tuple(m.get("emissiveFactor", (0, 0, 0))),
        }
        # metallicRoughness (G = roughness, B = metallic) multiplies the
        # specular record, whose y/z are exactly those
        for slot, owner, key in (
                ("tex_diffuse", pbr, "baseColorTexture"),
                ("tex_specular", pbr, "metallicRoughnessTexture"),
                ("tex_emissive", m, "emissiveTexture"),
                ("tex_bump", m, "normalTexture")):
            if key in owner:
                d[slot] = texture_slot(owner[key]["index"])
        mat_dicts.append(d)
    if not mat_dicts:
        mat_dicts.append({"diffuse": (0.7, 0.7, 0.7)})

    # geometry: walk the scene graph composing transforms
    tri_parts = []

    def emit_mesh(mesh_idx: int, mat: np.ndarray):
        for prim in gltf["meshes"][mesh_idx].get("primitives", []):
            if prim.get("mode", 4) != 4:  # TRIANGLES only
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(gltf, bufs, attrs["POSITION"]).astype(
                np.float32)
            pos = pos @ mat[:3, :3].T + mat[:3, 3]
            nrm = None
            if "NORMAL" in attrs:
                nrm = _read_accessor(gltf, bufs, attrs["NORMAL"]).astype(
                    np.float32)
                nm = np.linalg.inv(mat[:3, :3]).T     # inverse transpose
                nrm = nrm @ nm.T
                nrm /= np.maximum(
                    np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
            uv = None
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(
                    gltf, bufs, attrs["TEXCOORD_0"]).astype(np.float32)
            if "indices" in prim:
                idx = _read_accessor(gltf, bufs, prim["indices"]).reshape(
                    -1).astype(np.int64)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            tri_parts.append((pos, nrm, uv, idx.reshape(-1, 3),
                              prim.get("material", 0)))

    def walk(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        mat = parent @ _node_matrix(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], mat)
        for child in node.get("children", []):
            walk(child, mat)

    root_scale = np.diag([scale, scale, scale, 1.0]).astype(np.float32)
    scene_def = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    for n in scene_def.get("nodes", range(len(gltf.get("nodes", [])))):
        walk(n, root_scale)
    if not tri_parts:
        raise ValueError(f"no triangle primitives in {path}")

    # flatten into one indexed mesh
    all_v, all_n, all_t, all_f, all_m = [], [], [], [], []
    off = 0
    for pos, nrm, uv, faces, mid in tri_parts:
        all_v.append(pos)
        all_n.append(nrm if nrm is not None else np.zeros_like(pos))
        all_t.append(uv if uv is not None
                     else np.zeros((len(pos), 2), np.float32))
        all_f.append(faces + off)
        all_m.append(np.full(len(faces), mid, np.int32))
        off += len(pos)
    nrms = np.concatenate(all_n)
    if not np.abs(nrms).sum():
        nrms = None
    soup = TriangleSoup.from_arrays(
        np.concatenate(all_v), np.concatenate(all_f), normals=nrms,
        texcoords=np.concatenate(all_t), mat_ids=np.concatenate(all_m),
        capacity=capacity, device=device)
    mats = MaterialTable.build(mat_dicts, device=device)
    textures = (TextureStack.from_images(images, texture_resolution,
                                         device=device)
                if images else TextureStack.empty(device=device))
    return soup, mats, textures
