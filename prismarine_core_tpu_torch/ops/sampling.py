"""Monte-Carlo sampling primitives + per-frame uniform sample arrays.

The counterpart of ``prismarine_core_tpu.ops.sampling``.  The integrator
is a deterministic function of explicit uniform arrays; here they come
from an explicit ``torch.Generator`` (the JAX package draws them from a
threefry key, so the two give different numbers from one seed — the
parity tests hand both packages the same arrays).

Sample slot layout, consumed per bounce (11 slots, ``S_* = range(11)``):
  0 alpha coin, 1 diffuse/specular coin, 2-3 cosine hemisphere,
  4 glossy perturbation, 5-6 light sphere point, 7 light selection,
  8-9 environment NEE, 10 Russian roulette.
"""

from __future__ import annotations

import math

import torch

from prismarine_core_tpu_torch.models.camera import (
    tile_order_active, tile_pixel_perm)
from prismarine_core_tpu_torch.utils import math as pm
from prismarine_core_tpu_torch.utils.config import (
    SAMPLES_PER_BOUNCE, SAMPLES_PER_CAMERA_RAY)

(S_ALPHA, S_SPEC, S_COS1, S_COS2, S_GLOSS, S_LIGHT1, S_LIGHT2, S_RESERVED,
 S_ENV1, S_ENV2, S_RR) = range(11)


def make_sample_arrays(generator: torch.Generator, n_rays: int,
                       max_bounces: int, device=None):
    """Uniforms for one frame: (cam f32[R,4], bounce f32[B,R,11])."""
    device = device or generator.device
    cam = torch.rand((n_rays, SAMPLES_PER_CAMERA_RAY), generator=generator,
                     device=device)
    bounce = torch.rand((max_bounces, n_rays, SAMPLES_PER_BOUNCE),
                        generator=generator, device=device)
    return cam, bounce


def make_coherent_sample_arrays(generator: torch.Generator, cfg,
                                block=(8, 16), device=None):
    """Tile-correlated frame uniforms (coherent path tracing): every ray
    of a ``block``-pixel screen block (per spp plane) shares the same
    bounce-sample rows, so secondary rays leave nearby points in nearly
    the same directions.  Camera jitter stays independent per ray.
    Returns (cam f32[R,4], bounce f32[B,R,11]) in ``generate_rays``'s ray
    layout ([spp, H, W] row-major; with an active ``primary_tile_order``
    each lane takes its pixel's block)."""
    device = device or generator.device
    cam = torch.rand((cfg.n_rays, SAMPLES_PER_CAMERA_RAY),
                     generator=generator, device=device)
    bh, bw = block
    nby = -(-cfg.height // bh)
    nbx = -(-cfg.width // bw)
    ub = torch.rand((cfg.max_bounces, cfg.spp, nby * nbx,
                     SAMPLES_PER_BOUNCE), generator=generator, device=device)
    by = torch.arange(cfg.height, device=device) // bh
    bx = torch.arange(cfg.width, device=device) // bw
    bid = (by[:, None] * nbx + bx[None, :]).reshape(-1)       # [H*W]
    if tile_order_active(cfg):
        bid = bid[tile_pixel_perm(cfg, device)]
    bounce = ub[:, :, bid, :].reshape(cfg.max_bounces, cfg.n_rays,
                                      SAMPLES_PER_BOUNCE)
    return cam, bounce


def cosine_hemisphere(n, u1, u2):
    """Cosine-weighted hemisphere around normals ``n`` f32[R,3]:
    up = sqrt(u1), sideways sqrt(1-u1), azimuth 2*pi*u2."""
    up = torch.sqrt(u1)[..., None]
    over = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))[..., None]
    around = (u2 * 2.0 * math.pi)[..., None]
    t, b = pm.orthonormal_basis(n)
    return pm.normalize(n * up + t * torch.cos(around) * over
                        + b * torch.sin(around) * over)


def uniform_sphere(u1, u2):
    """Uniform direction on the unit sphere."""
    up = u1 * 2.0 - 1.0
    over = torch.sqrt(torch.clamp(1.0 - up * up, min=0.0))
    around = u2 * 2.0 * math.pi
    return torch.stack([up, torch.cos(around) * over,
                        torch.sin(around) * over], dim=-1)


def light_sampling_weight(ldir, n, radius, dist):
    """The reference's sphere-light weight heuristic
    ``1 - sqrt(1 - clamp(dot(l,n) * 2 * (r/d)^2, 0, 1))`` (sqrt guarded
    away from 0 as in the JAX package)."""
    c = torch.clamp(
        pm.dot(ldir, n) * 2.0 * (radius / torch.clamp(dist, min=1e-6)) ** 2,
        0.0, 1.0)
    return 1.0 - torch.sqrt(torch.clamp(1.0 - c, min=1e-12))
