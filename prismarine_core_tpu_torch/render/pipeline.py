"""Renderer facade with progressive accumulation.

The counterpart of ``prismarine_core_tpu.render.pipeline``: holds the
scene, camera and config, renders frames from one ``torch.Generator`` on
the scene's device (seeded by ``seed``), and folds each frame into a
weighted progressive accumulator that resets when the camera moves.
With ``cfg.interlace`` each checkerboard parity collects its own
per-pixel weight; ``cfg.samples_lock`` clamps the accumulated weight so
the average rolls (old frames decay) instead of growing.
"""

from __future__ import annotations

import numpy as np
import torch

from prismarine_core_tpu_torch.models.camera import Camera
from prismarine_core_tpu_torch.models.scene import Scene
from prismarine_core_tpu_torch.render.integrator import (
    interlace_mask, render)
from prismarine_core_tpu_torch.utils.config import RenderConfig


class ProgressiveRenderer:
    """Stateful host-side facade (the only mutable object in the stack)."""

    def __init__(self, scene: Scene, camera: Camera, cfg: RenderConfig,
                 seed: int = 0):
        self.scene = scene
        self.cfg = cfg
        self._camera = camera
        dev = scene.device
        self._generator = torch.Generator(device=dev).manual_seed(seed)
        self._accum = torch.zeros((cfg.height, cfg.width, 3),
                                  dtype=torch.float32, device=dev)
        self._weight = torch.zeros((cfg.height, cfg.width, 1),
                                   dtype=torch.float32, device=dev)
        self._n_frames = 0

    # -- camera control (resets the accumulation) -------------------------

    @property
    def camera(self) -> Camera:
        return self._camera

    @camera.setter
    def camera(self, cam: Camera) -> None:
        self._camera = cam
        self.clear()

    def clear(self) -> None:
        self._accum = torch.zeros_like(self._accum)
        self._weight = torch.zeros_like(self._weight)
        self._n_frames = 0

    # -- rendering --------------------------------------------------------

    def step(self) -> torch.Tensor:
        """Render one frame and fold it into the running average.
        Returns the current accumulated image."""
        stage = self._n_frames
        frame = render(self.scene, self._camera, self.cfg, self._generator,
                       interlace_stage=stage)
        if self.cfg.interlace:
            w = interlace_mask(self.cfg, stage, device=self._weight.device)
            w = w[..., None].to(torch.float32)
        else:
            w = torch.ones_like(self._weight)
        self._accum = self._accum + frame
        self._weight = self._weight + w
        if self.cfg.samples_lock > 0:
            # clamp the accumulated weight to SAMPLES_LOCK - 1 after the
            # blend, in sum/weight form: a rolling average
            lock = float(self.cfg.samples_lock - 1)
            scale = torch.clamp(lock / torch.clamp(self._weight, min=1e-6),
                                max=1.0)
            self._accum = self._accum * scale
            self._weight = self._weight * scale
        self._n_frames += 1
        return self._accum / torch.clamp(self._weight, min=1.0)

    def render_frames(self, n: int) -> torch.Tensor:
        for _ in range(n):
            img = self.step()
        return img

    @property
    def sample_count(self) -> int:
        return self._n_frames * self.cfg.spp

    def snapshot(self) -> np.ndarray:
        """Host copy of the HDR accumulator, f32[H,W,3]."""
        return (self._accum / torch.clamp(self._weight, min=1.0)
                ).cpu().numpy()

    def set_exposure_scene(self, scene: Scene) -> None:
        self.scene = scene
        self.clear()

    def rebuild_bvh(self) -> None:
        """Rebuild the BVH and packet set (animated geometry)."""
        self.scene = self.scene.with_bvh(self.cfg.bvh_leaf_size)

    def refit_bvh(self) -> None:
        """Refit the BVH's boxes over its frozen topology after the
        vertices moved (much cheaper than ``rebuild_bvh``)."""
        self.scene = self.scene.with_refit()
