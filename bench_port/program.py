"""The system under test: the port's scene, camera and ``RenderConfig`` of
a configuration, built from the benchmark's raw arrays by the port's own
constructors (the port derives its normals, BVH and packets itself)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Program:
    scene: object
    camera: object
    cfg: object
    device: object


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(config: dict, arrays: dict, dev) -> Program:
    """Hand a configuration's arrays to the port's constructors."""
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.models.geometry import TriangleSoup
    from prismarine_core_tpu_torch.models.lights import SphereLights
    from prismarine_core_tpu_torch.models.materials import MaterialTable
    from prismarine_core_tpu_torch.models.scene import Scene
    from prismarine_core_tpu_torch.models.textures import Environment
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    render = config["render"]
    soup = TriangleSoup.from_arrays(arrays["verts"], arrays["faces"],
                                    mat_ids=arrays["mat_ids"], device=dev)
    lights = SphereLights(
        center=torch.as_tensor(arrays["light_center"], device=dev),
        radius=torch.as_tensor(arrays["light_radius"], device=dev),
        color=torch.as_tensor(arrays["light_color"], device=dev))
    scene = Scene.assemble(
        soup, MaterialTable.build(list(arrays["materials"]), device=dev),
        lights, Environment.from_image(arrays["sky"],
                                       scale=arrays["sky_scale"], device=dev),
        leaf_size=render.get("bvh_leaf_size", 4))
    cam = config["camera"]
    camera = Camera.look_at(cam["eye"], cam["target"],
                            cam.get("up", (0.0, 1.0, 0.0)),
                            fov_y_deg=cam["fov_y_deg"], device=dev)
    return Program(scene, camera, RenderConfig(**render), dev)
