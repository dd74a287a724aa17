"""Frames of a textured configuration: ``frames.py``'s frames, with the
scene's texcoords, texture bindings and texture stack handed to the port
(``build``) and the textured plain reference (``reference/textured.py``)
in the check.

The configuration's ``scene`` block names a generator whose arrays add
``texcoords`` f32[V,2], ``textures`` (a list of f32[h,w,3|4] images) and
``tex_*`` ids in its ``materials`` (``scenes/hall_textured.py``); its
``texture_resolution`` caps the stack's side.  The stack is corner-packed,
as the port's textured hall builds it."""

from __future__ import annotations

import torch

from bench_port import plugins, program, sampling
from bench_port.reference import textured, tracer

frames_job = plugins.load("jobs", "frames")


def build(config: dict, arrays: dict, dev) -> program.Program:
    """Hand a textured configuration's arrays to the port's
    constructors."""
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.models.geometry import TriangleSoup
    from prismarine_core_tpu_torch.models.lights import SphereLights
    from prismarine_core_tpu_torch.models.materials import MaterialTable
    from prismarine_core_tpu_torch.models.scene import Scene
    from prismarine_core_tpu_torch.models.textures import (
        Environment, TextureStack)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    render, spec = config["render"], config["scene"]
    soup = TriangleSoup.from_arrays(arrays["verts"], arrays["faces"],
                                    mat_ids=arrays["mat_ids"],
                                    texcoords=arrays["texcoords"], device=dev)
    stack = TextureStack.from_images(arrays["textures"],
                                     resolution=spec["texture_resolution"],
                                     device=dev).with_packed_corners()
    lights = SphereLights(
        center=torch.as_tensor(arrays["light_center"], device=dev),
        radius=torch.as_tensor(arrays["light_radius"], device=dev),
        color=torch.as_tensor(arrays["light_color"], device=dev))
    scene = Scene.assemble(
        soup, MaterialTable.build(list(arrays["materials"]), device=dev),
        lights, Environment.from_image(arrays["sky"],
                                       scale=arrays["sky_scale"], device=dev),
        textures=stack, leaf_size=render.get("bvh_leaf_size", 4))
    cam = config["camera"]
    camera = Camera.look_at(cam["eye"], cam["target"],
                            cam.get("up", (0.0, 1.0, 0.0)),
                            fov_y_deg=cam["fov_y_deg"], device=dev)
    return program.Program(scene, camera, RenderConfig(**render), dev)


class Job(frames_job.Job):
    def reference(self, frames: list, arrays: dict, dev, dtype):
        """The textured reference's radiance at the kept pixels of
        ``frames``, each the mean of its ``spp`` paths."""
        ref_scene = textured.build_scene(arrays, dev, dtype)
        index = textured.scene_index(ref_scene)
        out = []
        for j in frames:
            cam_s, bounce_s = self.samples(sampling.WINDOW, j, dev)
            pix = self.pix[j].to(dev)
            lanes = tracer.pixel_lanes(self.render, pix)
            out.append(textured.render_pixels(
                ref_scene, index, self.cell.config["camera"], self.render,
                cam_s[lanes], bounce_s[:, lanes], pix).float())
        return torch.cat(out)
