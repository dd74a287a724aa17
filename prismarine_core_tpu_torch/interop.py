"""Scene state to and from plain numpy arrays.

This renderer has no weights: its state is the scene (triangles,
materials, lights, environment, textures) and the acceleration structures
built from it (``bvh``, ``packets``).  ``scene_from_numpy`` takes that
state as a dict of numpy arrays keyed by dotted field path — for example
``"triangles.v0"``, ``"bvh.orig"``, ``"packets.planes"``,
``"lights.center"`` — and returns the port's ``Scene`` with exactly that
BVH and packet set.  A JAX scene flattened to such a dict (on the JAX
side) thus crosses over without this package importing jax, and the
port's query can be held against the JAX query on an identical
acceleration structure.  ``params_from_numpy`` and ``params_to_numpy``
carry the train step's parameter dict across the same way,
``camera_from_numpy`` a camera, and ``samples_from_numpy`` sample arrays
(a frame's or the boundary term's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from prismarine_core_tpu_torch.accel.lbvh import BVH
from prismarine_core_tpu_torch.accel.packet import PacketSet
from prismarine_core_tpu_torch.models.camera import Camera
from prismarine_core_tpu_torch.models.geometry import TriangleSoup
from prismarine_core_tpu_torch.models.lights import SphereLights
from prismarine_core_tpu_torch.models.materials import MaterialTable
from prismarine_core_tpu_torch.models.scene import Scene
from prismarine_core_tpu_torch.models.textures import (
    Environment, TextureStack)
from prismarine_core_tpu_torch.utils.device import resolve_device

_GROUPS = {
    "triangles": TriangleSoup,
    "materials": MaterialTable,
    "lights": SphereLights,
    "environment": Environment,
    "bvh": BVH,
    "packets": PacketSet,
}


def _tensor_fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


#: the texture stack's arrays; ``sizes`` and ``quad`` are optional
_TEXTURE_FIELDS = ("data", "sizes", "quad")


def scene_from_numpy(arrays: dict, device=None) -> Scene:
    """Build the port's Scene from ``{"group.field": ndarray}``.

    Groups ``triangles``, ``materials``, ``lights`` and ``environment``
    are required; ``bvh`` and ``packets`` are taken when present (both or
    neither).  ``textures.data``, ``textures.sizes`` and
    ``textures.quad`` are taken when present; without them, or for a
    single all-white texture with no size table, the stack is the
    texture-less stub.  ``device`` None is the CUDA card."""
    device = resolve_device(device)

    def group(name):
        cls = _GROUPS[name]
        kw = {}
        for f in _tensor_fields(cls):
            key = f"{name}.{f}"
            if key not in arrays:
                raise KeyError(f"missing array {key!r}")
            kw[f] = torch.tensor(np.asarray(arrays[key]), device=device)
        return cls(**kw)

    known = {f"{g}.{f}" for g, c in _GROUPS.items()
             for f in _tensor_fields(c)} | {
        f"textures.{f}" for f in _TEXTURE_FIELDS}
    extra = sorted(set(arrays) - known)
    if extra:
        raise KeyError(f"arrays {extra} are not part of the scene state")
    tex = {f: torch.tensor(np.asarray(arrays[f"textures.{f}"]),
                           device=device)
           for f in _TEXTURE_FIELDS if f"textures.{f}" in arrays}
    if "data" not in tex and tex:
        raise KeyError("textures.sizes or textures.quad without "
                       "textures.data")
    if "data" not in tex:
        textures = TextureStack.empty(device=device)
    else:
        data = tex["data"]
        stub = ("sizes" not in tex and "quad" not in tex
                and data.shape[0] == 1 and bool((data == 1.0).all()))
        textures = TextureStack(**tex, stub=stub)
    has_accel = ["bvh.lo" in arrays, "packets.planes" in arrays]
    if any(has_accel) and not all(has_accel):
        raise ValueError("bvh and packets come together")
    return Scene(
        triangles=group("triangles"), materials=group("materials"),
        lights=group("lights"), environment=group("environment"),
        textures=textures,
        bvh=group("bvh") if all(has_accel) else None,
        packets=group("packets") if all(has_accel) else None)


def scene_to_numpy(scene: Scene) -> dict:
    """The inverse of ``scene_from_numpy``."""
    out = {}
    for name in _GROUPS:
        obj = getattr(scene, name)
        if obj is None:
            continue
        for f in _tensor_fields(type(obj)):
            out[f"{name}.{f}"] = getattr(obj, f).detach().cpu().numpy()
    for f in _TEXTURE_FIELDS:
        t = getattr(scene.textures, f)
        if t is not None:
            out[f"textures.{f}"] = t.detach().cpu().numpy()
    return out


#: the keys of the train step's parameter dicts (``parallel/mesh.py``):
#: corner mode carries v0 (and v1, v2), shared mode carries verts
PARAM_KEYS = ("mat_diffuse", "light_color", "v0", "v1", "v2", "verts")


def params_from_numpy(arrays: dict, device=None) -> dict:
    """The train step's parameter dict from ``{key: ndarray}`` (keys of
    ``PARAM_KEYS``: ``init_params``' or ``init_shared_params``' dict), so
    that both packages start from one state.  ``device`` None is the CUDA
    card."""
    device = resolve_device(device)
    extra = sorted(set(arrays) - set(PARAM_KEYS))
    if extra:
        raise KeyError(f"unknown parameter(s) {extra}")
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()}


def params_to_numpy(params: dict) -> dict:
    """The inverse of ``params_from_numpy``."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


#: the camera's fields: eye, target, up f32[3] and fov_y f32[] (radians)
CAMERA_KEYS = tuple(f.name for f in dataclasses.fields(Camera))


def camera_from_numpy(arrays: dict, device=None) -> Camera:
    """The port's Camera from ``{field: ndarray}`` (keys ``CAMERA_KEYS``,
    a JAX camera's fields as numpy).  ``device`` None is the CUDA card."""
    device = resolve_device(device)
    if set(arrays) != set(CAMERA_KEYS):
        raise KeyError(f"camera arrays {sorted(arrays)}, expected "
                       f"{sorted(CAMERA_KEYS)}")
    return Camera(**{k: torch.tensor(np.asarray(arrays[k], np.float32),
                                     device=device) for k in CAMERA_KEYS})


def samples_from_numpy(*arrays, device=None):
    """Sample arrays (uniforms made elsewhere, for example by the JAX
    package's ``make_sample_arrays`` or ``make_edge_sample_arrays``) as
    float32 tensors on ``device`` (None is the CUDA card), in order."""
    device = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a, np.float32), device=device)
                 for a in arrays)
