"""Scene container + the Cornell and sun-plane test scenes.

The counterpart of ``prismarine_core_tpu.models.scene``: geometry,
materials, lights, environment and textures, plus the acceleration
structures (``bvh``, ``packets``) once built.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from prismarine_core_tpu_torch.models.geometry import (
    TriangleSoup, make_box, make_quad, merge_meshes)
from prismarine_core_tpu_torch.models.lights import SphereLights
from prismarine_core_tpu_torch.models.materials import MaterialTable
from prismarine_core_tpu_torch.models.textures import (
    Environment, TextureStack)
from prismarine_core_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Scene:
    triangles: TriangleSoup
    materials: MaterialTable
    lights: SphereLights
    environment: Environment
    textures: TextureStack
    #: acceleration structure; None until built (see ``with_bvh``)
    bvh: object = None
    #: packet-query view of the BVH (built with it), or the sharded
    #: packets of ``parallel/shard_intersect.py:distribute_scene``
    packets: object = None
    #: the device mesh the scene is laid out on (``parallel/mesh.py:
    #: shard_scene``, ``distribute_scene``); None on one device
    mesh: object = None
    #: brute's triangle ranges split over the mesh's "model" axis
    shard_triangles: bool = False

    @property
    def device(self):
        """Where the scene's replicated tensors live: the mesh's first
        device on a mesh (a distributed scene's soup may be a husk),
        else the soup's."""
        return self.mesh.first if self.mesh is not None \
            else self.triangles.device

    @staticmethod
    def assemble(triangles, materials, lights=None, environment=None,
                 textures=None, build_bvh: bool = True,
                 leaf_size: int = 4) -> "Scene":
        dev = triangles.device
        scene = Scene(
            triangles=triangles,
            materials=materials,
            lights=(lights if lights is not None
                    else SphereLights.suns(device=dev)),
            environment=(environment if environment is not None
                         else Environment.constant((0.5, 0.6, 0.7),
                                                   device=dev)),
            textures=(textures if textures is not None
                      else TextureStack.empty(device=dev)),
        )
        return scene.with_bvh(leaf_size) if build_bvh else scene

    def with_bvh(self, leaf_size: int = 4,
                 topology: str = "karras") -> "Scene":
        """(Re)build the BVH (``topology`` "karras" or "median") and its
        packet set."""
        from prismarine_core_tpu_torch.accel.lbvh import build_bvh
        from prismarine_core_tpu_torch.accel.packet import build_packet_set
        bvh = build_bvh(self.triangles, leaf_size=leaf_size,
                        topology=topology)
        return dataclasses.replace(self, bvh=bvh,
                                   packets=build_packet_set(bvh))

    def with_refit(self) -> "Scene":
        """Refit the existing BVH's boxes over its frozen topology after the
        soup's vertices moved (same triangle count and identity), and
        rebuild the packet view from the refit BVH."""
        from prismarine_core_tpu_torch.accel.lbvh import refit_bvh
        from prismarine_core_tpu_torch.accel.packet import build_packet_set
        if self.bvh is None:
            raise ValueError("with_refit() needs an existing BVH — "
                             "build one with with_bvh() first")
        bvh = refit_bvh(self.bvh, self.triangles)
        return dataclasses.replace(self, bvh=bvh,
                                   packets=build_packet_set(bvh))


def make_cornell_scene(capacity: int | None = None, device=None) -> Scene:
    """Cornell-box-style scene: inward room (red left, green right wall),
    one tall box, a small sphere light near the ceiling.  ``device`` None
    is the CUDA card."""
    device = resolve_device(device)
    room = make_box((-1, -1, -1), (1, 1, 1), mat_id=0, inward=True,
                    skip_faces=("front",))
    rv, rf, rm = room
    centers = rv[rf].mean(axis=1)
    rm = np.where(centers[:, 0] < -0.99, 1, rm)
    rm = np.where(centers[:, 0] > 0.99, 2, rm)
    block = make_box((-0.4, -1.0, -0.5), (0.1, 0.2, 0.0), mat_id=3)
    verts, faces, mids = merge_meshes([(rv, rf, rm.astype(np.int32)),
                                       block])
    tris = TriangleSoup.from_arrays(verts, faces, mat_ids=mids,
                                    capacity=capacity, device=device)
    mats = MaterialTable.build([
        {"diffuse": (0.75, 0.75, 0.75)},
        {"diffuse": (0.75, 0.15, 0.15)},
        {"diffuse": (0.15, 0.75, 0.15)},
        {"diffuse": (0.7, 0.7, 0.5), "roughness": 0.2, "metallic": 0.4},
    ], device=device)
    lights = SphereLights.single(center=(0.0, 0.8, 0.0), radius=0.15,
                                 color=(40.0, 40.0, 38.0), device=device)
    env = Environment.constant((0.0, 0.0, 0.0), device=device)
    return Scene.assemble(tris, mats, lights, env)


def make_sun_plane_scene(capacity: int | None = None, device=None) -> Scene:
    """Open plane + cube under the default far sun (env-map misses and
    long shadow rays).  ``device`` None is the CUDA card."""
    device = resolve_device(device)
    plane = make_quad((-10, 0, -10), (-10, 0, 10), (10, 0, 10),
                      (10, 0, -10), mat_id=0)
    cube = make_box((-0.5, 0.0, -0.5), (0.5, 1.0, 0.5), mat_id=1)
    verts, faces, mids = merge_meshes([plane, cube])
    tris = TriangleSoup.from_arrays(verts, faces, mat_ids=mids,
                                    capacity=capacity, device=device)
    mats = MaterialTable.build([
        {"diffuse": (0.6, 0.6, 0.6)},
        {"diffuse": (0.8, 0.5, 0.3), "roughness": 0.3, "metallic": 0.2},
    ], device=device)
    return Scene.assemble(
        tris, mats, SphereLights.suns(device=device),
        Environment.constant((0.4, 0.55, 0.75), device=device))
