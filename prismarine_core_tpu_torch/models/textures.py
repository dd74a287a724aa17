"""Texture stack (stub only) and the equirect environment map.

The counterpart of ``prismarine_core_tpu.models.textures``.  The port has
the texture-less stub stack (``TextureStack.empty``) and ``Environment``
with its bilinear ``sample``; image textures, bicubic filtering and env
importance sampling are ROADMAP queue 1, 'Textures and env NEE'.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from prismarine_core_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TextureStack:
    data: torch.Tensor  # f32[N, H, W, 4]
    #: the all-white placeholder stack: the integrator skips every
    #: texture fetch (results are identical, every id is -1)
    stub: bool = False

    @staticmethod
    def empty(resolution: int = 64, device=None) -> "TextureStack":
        """Stack with a single white texture at id 0 (``device`` None is
        the CUDA card)."""
        device = resolve_device(device)
        return TextureStack(
            data=torch.ones((1, resolution, resolution, 4),
                            dtype=torch.float32, device=device),
            stub=True)


@dataclasses.dataclass
class Environment:
    """Equirect environment map times a constant tint."""

    image: torch.Tensor  # f32[H, W, 3]; 1x1 for a constant color
    scale: torch.Tensor  # f32[3]

    @staticmethod
    def constant(color=(0.0, 0.0, 0.0), device=None) -> "Environment":
        device = resolve_device(device)
        return Environment(
            image=torch.ones((1, 1, 3), dtype=torch.float32, device=device),
            scale=torch.as_tensor(np.asarray(color, np.float32),
                                  device=device))

    @staticmethod
    def from_image(img, scale=(1.0, 1.0, 1.0), device=None) -> "Environment":
        device = resolve_device(device)
        return Environment(
            image=torch.as_tensor(
                np.ascontiguousarray(np.asarray(img, np.float32)[..., :3]),
                device=device),
            scale=torch.as_tensor(np.asarray(scale, np.float32),
                                  device=device))

    def sample(self, d: torch.Tensor) -> torch.Tensor:
        """Radiance for directions d f32[R,3]: equirect lookup (u from
        atan2(z, x), v from asin(y)), bilinear, wrapping in u and
        clamping in v."""
        h, w, _ = self.image.shape
        u = torch.atan2(d[:, 2], d[:, 0]) / (2.0 * math.pi) + 0.5
        v = 0.5 - torch.asin(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi
        x = u * w - 0.5
        y = v * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]
        x0i = torch.remainder(x0.to(torch.int32), w)
        x1i = torch.remainder(x0i + 1, w)
        y0i = torch.clamp(y0.to(torch.int32), 0, h - 1)
        y1i = torch.clamp(y0i + 1, 0, h - 1)
        img = self.image
        c00 = img[y0i, x0i]
        c10 = img[y0i, x1i]
        c01 = img[y1i, x0i]
        c11 = img[y1i, x1i]
        col = ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
               + (c01 * (1 - fx) + c11 * fx) * fy)
        return col * self.scale
