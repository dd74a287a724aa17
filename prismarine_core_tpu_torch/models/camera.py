"""Camera model + primary ray generation.

The counterpart of ``prismarine_core_tpu.models.camera``: rays come from a
look-at frame in closed form, one per (spp, row, column) in scanline
order, with per-ray jitter inside the pixel; ``cfg.camera_360`` maps the
frame to an equirectangular panorama and ``cfg.dof`` moves each origin
onto a thin lens aimed at the focal distance.  With an active
``primary_tile_order`` (``tile_order_active``) lane p takes pixel
``tile_pixel_perm[p]``: each 128-lane tile of the packet query is a
16x8-pixel rect instead of a 128x1 scanline strip.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from prismarine_core_tpu_torch.utils import math as pm
from prismarine_core_tpu_torch.utils.config import RenderConfig
from prismarine_core_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Camera:
    eye: torch.Tensor     # f32[3]
    target: torch.Tensor  # f32[3]
    up: torch.Tensor      # f32[3]
    fov_y: torch.Tensor   # f32[] vertical field of view, radians

    @staticmethod
    def look_at(eye, target, up=(0.0, 1.0, 0.0), fov_y_deg: float = 60.0,
                device=None) -> "Camera":
        """``device`` None is the CUDA card."""
        device = resolve_device(device)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        return Camera(eye=t(eye), target=t(target), up=t(up),
                      fov_y=t(fov_y_deg * math.pi / 180.0))

    def basis(self):
        """Right-handed camera frame: forward, right, up."""
        fwd = pm.normalize(self.target - self.eye)
        right = pm.normalize(pm.cross(fwd, pm.normalize(self.up)))
        cup = pm.cross(right, fwd)
        return fwd, right, cup


def tile_order_active(cfg: RenderConfig) -> bool:
    """Whether ``cfg.primary_tile_order`` applies: under "pallas", on a
    frame of whole 16x8 tiles."""
    return (cfg.primary_tile_order and cfg.intersector == "pallas"
            and cfg.width % 16 == 0 and cfg.height % 8 == 0)


def _tile_pixel_perm_np(w: int, h: int):
    """(perm, inv) i64[H*W] numpy constants: lane -> pixel and pixel ->
    lane of the 16x8-pixel-tile lane order (tiles row-major, pixels
    row-major within a tile)."""
    tw, th = 16, 8
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    key = (((yy // th) * (w // tw) + xx // tw) * (th * tw)
           + (yy % th) * tw + (xx % tw))
    perm = np.empty(h * w, np.int64)
    perm[key.reshape(-1)] = np.arange(h * w)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(h * w)
    return perm, inv


@functools.lru_cache(maxsize=8)
def _tile_pixel_perms(w: int, h: int, device: torch.device):
    """``_tile_pixel_perm_np`` on ``device``, moved there once."""
    return tuple(torch.as_tensor(x, device=device)
                 for x in _tile_pixel_perm_np(w, h))


def tile_pixel_perm(cfg: RenderConfig, device) -> torch.Tensor:
    """Lane -> pixel map of the 16x8-pixel-tile lane order, i64[H*W] on
    ``device``."""
    return _tile_pixel_perms(cfg.width, cfg.height, torch.device(device))[0]


def tile_pixel_inv_perm(cfg: RenderConfig, device) -> torch.Tensor:
    """Pixel -> lane, the inverse of ``tile_pixel_perm``: the one radiance
    unpermute of a frame."""
    return _tile_pixel_perms(cfg.width, cfg.height, torch.device(device))[1]


def generate_rays(camera: Camera, cfg: RenderConfig,
                  cam_samples: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays (origins, dirs) f32[R,3], R = spp*H*W laid out as
    [spp, H, W] row-major (with an active ``primary_tile_order``, lane p of
    a plane takes pixel ``tile_pixel_perm[p]``); cam_samples f32[R,4]
    (jitter xy in 0:2, the lens sample in 2:4)."""
    w, h, spp = cfg.width, cfg.height, cfg.spp
    n = spp * h * w
    if cam_samples.shape[0] != n:
        raise ValueError(f"cam_samples has {cam_samples.shape[0]} rows, "
                         f"expected {n}")
    dev = cam_samples.device
    pix = torch.arange(n, dtype=torch.int32, device=dev) % (h * w)
    if tile_order_active(cfg):
        pix = tile_pixel_perm(cfg, dev)[pix.long()]
    px = (pix % w).to(torch.float32)
    py = (pix // w).to(torch.float32)
    jitter = torch.clamp(cam_samples[:, 0:2], 1e-5, 1.0 - 1e-5)
    u = (px + jitter[:, 0]) / w
    v = (py + jitter[:, 1]) / h
    fwd, right, cup = camera.basis()

    if cfg.camera_360:
        # equirectangular: longitude from u, latitude from v
        lon = (u * 2.0 - 1.0) * math.pi
        lat = (0.5 - v) * math.pi
        cl = torch.cos(lat)
        local = torch.stack([cl * torch.sin(lon), torch.sin(lat),
                             cl * torch.cos(lon)], dim=-1)
        d = (local[:, 0:1] * right + local[:, 1:2] * cup
             + local[:, 2:3] * fwd)
        return camera.eye.expand(d.shape), pm.normalize(d)

    tan_half = torch.tan(camera.fov_y * 0.5)
    aspect = w / h
    sx = (u * 2.0 - 1.0) * tan_half * aspect
    sy = (1.0 - v * 2.0) * tan_half
    d = pm.normalize(fwd + sx[:, None] * right + sy[:, None] * cup)
    o = camera.eye.expand(d.shape)

    if cfg.dof:
        # thin lens: the origin moves on the aperture disk, the ray aims
        # at the point the pinhole ray reaches at the focal distance
        r = torch.sqrt(cam_samples[:, 2:3]) * cfg.dof_focal_radius
        phi = cam_samples[:, 3:4] * (2.0 * math.pi)
        lens = r * (torch.cos(phi) * right + torch.sin(phi) * cup)
        focus = o + d * cfg.dof_focus_radius
        o = o + lens
        d = pm.normalize(focus - o)
    return o, d
