"""Triangle geometry: a padded structure-of-arrays triangle soup.

The counterpart of ``prismarine_core_tpu.models.geometry``: fixed capacity,
a validity mask for padding, per-corner attributes as dense tensors.  The
mesh builders are numpy (load time) and give the same arrays as the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from prismarine_core_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TriangleSoup:
    """Padded SoA triangle soup (all tensors share leading dim T)."""

    v0: torch.Tensor  # f32[T,3] vertex positions
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor  # f32[T,3] shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    t0: torch.Tensor  # f32[T,2] texcoords
    t1: torch.Tensor
    t2: torch.Tensor
    mat_id: torch.Tensor  # i32[T]
    valid: torch.Tensor   # bool[T]

    @property
    def capacity(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum()

    @staticmethod
    def from_arrays(vertices, faces, normals=None, texcoords=None,
                    mat_ids=None, capacity: int | None = None,
                    device=None) -> "TriangleSoup":
        """Build from an indexed mesh; area-weighted smooth normals when
        ``normals`` is None; ``device`` None is the CUDA card."""
        device = resolve_device(device)
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        nf = faces.shape[0]
        if normals is None:
            normals = _smooth_vertex_normals(vertices, faces)
        if texcoords is None:
            texcoords = np.zeros((vertices.shape[0], 2), np.float32)
        if mat_ids is None:
            mat_ids = np.zeros((nf,), np.int32)
        cap = capacity or nf
        if cap < nf:
            raise ValueError(f"capacity {cap} < {nf} triangles")

        def pad(x):
            out = np.zeros((cap, x.shape[1]), np.float32)
            out[:nf] = x
            return torch.as_tensor(out, device=device)

        f0, f1, f2 = faces[:, 0], faces[:, 1], faces[:, 2]
        valid = np.zeros((cap,), bool)
        valid[:nf] = True
        mid = np.zeros((cap,), np.int32)
        mid[:nf] = mat_ids
        return TriangleSoup(
            v0=pad(vertices[f0]), v1=pad(vertices[f1]), v2=pad(vertices[f2]),
            n0=pad(normals[f0]), n1=pad(normals[f1]), n2=pad(normals[f2]),
            t0=pad(texcoords[f0][:, :2]), t1=pad(texcoords[f1][:, :2]),
            t2=pad(texcoords[f2][:, :2]),
            mat_id=torch.as_tensor(mid, device=device),
            valid=torch.as_tensor(valid, device=device),
        )

    @staticmethod
    def from_corners(v0, v1, v2, n0, n1, n2, t0, t1, t2, mat_ids,
                     capacity: int | None = None,
                     device=None) -> "TriangleSoup":
        """Build directly from per-corner numpy arrays (the native OBJ
        parser's output); ``device`` None is the CUDA card."""
        device = resolve_device(device)
        nf = len(v0)
        cap = capacity or nf
        if cap < nf:
            raise ValueError(f"capacity {cap} < {nf} triangles")

        def pad(x, w):
            out = np.zeros((cap, w), np.float32)
            out[:nf] = x
            return torch.as_tensor(out, device=device)

        valid = np.zeros((cap,), bool)
        valid[:nf] = True
        mid = np.zeros((cap,), np.int32)
        mid[:nf] = mat_ids
        return TriangleSoup(
            v0=pad(v0, 3), v1=pad(v1, 3), v2=pad(v2, 3),
            n0=pad(n0, 3), n1=pad(n1, 3), n2=pad(n2, 3),
            t0=pad(t0, 2), t1=pad(t1, 2), t2=pad(t2, 2),
            mat_id=torch.as_tensor(mid, device=device),
            valid=torch.as_tensor(valid, device=device))

    @staticmethod
    def concatenate(soups: list["TriangleSoup"]) -> "TriangleSoup":
        """The soups' lanes one after another (all on one device)."""
        return TriangleSoup(**{
            f.name: torch.cat([getattr(s, f.name) for s in soups])
            for f in dataclasses.fields(TriangleSoup)})

    def transformed(self, matrix) -> "TriangleSoup":
        """Apply a 4x4 transform to the positions and its inverse
        transpose to the normals (renormalised), on the soup's device."""
        m = torch.as_tensor(matrix, dtype=torch.float32, device=self.device)
        nrm_m = torch.linalg.inv(m[:3, :3]).T

        def xp(p):
            return p @ m[:3, :3].T + m[:3, 3]

        def xn(n):
            out = n @ nrm_m.T
            return out / torch.clamp(
                torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)

        return dataclasses.replace(
            self, v0=xp(self.v0), v1=xp(self.v1), v2=xp(self.v2),
            n0=xn(self.n0), n1=xn(self.n1), n2=xn(self.n2))


def _smooth_vertex_normals(vertices: np.ndarray,
                           faces: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (numpy, load time only)."""
    fn = np.cross(vertices[faces[:, 1]] - vertices[faces[:, 0]],
                  vertices[faces[:, 2]] - vertices[faces[:, 0]])
    out = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(out, faces[:, k], fn)
    n = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(n, 1e-12)).astype(np.float32)


def make_quad(p0, p1, p2, p3,
              mat_id=0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Two triangles for quad p0-p1-p2-p3 (counter-clockwise)."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
    return verts, faces, np.full((2,), mat_id, np.int32)


def make_box(lo, hi, mat_id=0, inward=False, skip_faces=()):
    """Axis-aligned box as 12 triangles; ``inward=True`` flips winding;
    ``skip_faces`` drops named faces."""
    x0, y0, z0 = np.asarray(lo, np.float32)
    x1, y1, z1 = np.asarray(hi, np.float32)
    corners = np.asarray([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ], np.float32)
    quads = {
        "back": (0, 3, 2, 1), "front": (4, 5, 6, 7),
        "floor": (0, 1, 5, 4), "ceiling": (3, 7, 6, 2),
        "left": (0, 4, 7, 3), "right": (1, 2, 6, 5),
    }
    faces = []
    for name, (a, b, c, d) in quads.items():
        if name in skip_faces:
            continue
        faces += ([[a, c, b], [a, d, c]] if inward
                  else [[a, b, c], [a, c, d]])
    faces = np.asarray(faces, np.int64)
    return corners, faces, np.full((len(faces),), mat_id, np.int32)


def merge_meshes(parts):
    """Concatenate (verts, faces, mat_ids) triples into one indexed mesh."""
    verts, faces, mids = [], [], []
    off = 0
    for v, f, m in parts:
        verts.append(v)
        faces.append(np.asarray(f) + off)
        mids.append(m)
        off += len(v)
    return (np.concatenate(verts), np.concatenate(faces),
            np.concatenate(mids))
