"""Sphere lights — the counterpart of ``prismarine_core_tpu.models.lights``.

A sun is a sphere at ``normalize(direction) * distance`` with the given
radius; lights contribute only through next-event shadow rays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from prismarine_core_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class SphereLights:
    center: torch.Tensor  # f32[L,3]
    radius: torch.Tensor  # f32[L]
    color: torch.Tensor   # f32[L,3] radiant intensity scale

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @staticmethod
    def suns(directions=((0.3, 1.0, 0.1),), distance: float = 400.0,
             radius: float = 40.0,
             color=(150.0 * 255 / 255, 150.0 * 250 / 255, 150.0 * 244 / 255),
             device=None) -> "SphereLights":
        """Reference-default sun(s); ``device`` None is the CUDA card."""
        device = resolve_device(device)
        dirs = np.asarray(directions, np.float32)
        dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        n = dirs.shape[0]
        col = np.broadcast_to(np.asarray(color, np.float32), (n, 3)).copy()
        return SphereLights(
            center=torch.as_tensor(dirs * np.float32(distance),
                                   device=device),
            radius=torch.full((n,), radius, dtype=torch.float32,
                              device=device),
            color=torch.as_tensor(col, device=device))

    @staticmethod
    def single(center, radius, color, device=None) -> "SphereLights":
        device = resolve_device(device)

        def t(x):
            return torch.as_tensor(np.asarray([x], np.float32),
                                   device=device)
        return SphereLights(center=t(center), radius=t(radius),
                            color=t(color))
