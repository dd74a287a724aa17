"""Texture stack, texture fetches, the equirect environment map and its
importance sampling.

The counterpart of ``prismarine_core_tpu.models.textures``.  A texture
stack is one dense f32[N, H, W, 4] tensor plus a per-texture native size
table; a fetch is a row gather of a flat texel index (the bindless handle
dereference of the reference).  ``with_packed_corners`` stores the four
bilinear corner texels of every texel in one 16-wide row, so a bilinear
fetch is one row gather instead of four.  The stack arrays are built in
numpy, as the JAX package builds them, so they are equal bit for bit.

Environment importance sampling draws directions from the sky's
reconstructed luminance x sin(theta); the integrator combines it with the
cosine bounce by the balance heuristic (``cfg.env_nee``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from prismarine_core_tpu_torch.utils.device import resolve_device
from prismarine_core_tpu_torch.utils.math import take_rows


@dataclasses.dataclass
class TextureStack:
    data: torch.Tensor  # f32[N, Hmax, Wmax, 4]
    #: i32[N, 2] per-texture native (w, h); None = every texture fills
    #: the stack.  A smaller texture occupies the top-left corner and
    #: samples at its own resolution.
    sizes: torch.Tensor | None = None
    #: f32[N, Hmax, Wmax, 16] corner-packed texel quads: entry (i, y, x)
    #: holds the texels (y, x), (y, x+1), (y+1, x), (y+1, x+1), wrapped at
    #: the texture's native size (``with_packed_corners``)
    quad: torch.Tensor | None = None
    #: the all-white placeholder stack: the integrator skips every
    #: texture fetch (results are identical, every id is -1)
    stub: bool = False
    #: the device mesh of a stack split over its "model" axis
    #: (``parallel/shard_intersect.py:distribute_scene``): ``data`` and
    #: ``quad`` are then ``MeshArray``s split on the texture axis, and a
    #: fetch is a shard-local gather plus one sum over the shards
    #: (``_sharded_texel_rows``); ``sizes`` stays whole
    mesh: object = None

    @property
    def count(self) -> int:
        return self.data.shape[0]

    @staticmethod
    def empty(resolution: int = 64, device=None) -> "TextureStack":
        """Stack with a single white texture at id 0 (``device`` None is
        the CUDA card)."""
        device = resolve_device(device)
        return TextureStack(
            data=torch.ones((1, resolution, resolution, 4),
                            dtype=torch.float32, device=device),
            stub=True)

    @staticmethod
    def from_images(images, resolution: int = 1024,
                    device=None) -> "TextureStack":
        """Stack images (each f32[h, w, 3|4], values 0..1) at their native
        resolutions, padded into [N, Hmax, Wmax, 4] with a size table;
        ``resolution`` only caps oversized textures (an area-averaged box
        downsample by an integer factor).  ``device`` None is the CUDA
        card."""
        device = resolve_device(device)
        sized = []
        for img in images:
            img = np.asarray(img, np.float32)
            if img.ndim == 2:
                img = img[..., None].repeat(3, -1)
            h, w = img.shape[:2]
            if max(h, w) > resolution:
                f = -(-max(h, w) // resolution)   # integer box factor
                hc, wc = (h // f) * f, (w // f) * f
                img = img[:hc, :wc].reshape(
                    hc // f, f, wc // f, f, img.shape[-1]).mean((1, 3))
            sized.append(img)
        hmax = max([s.shape[0] for s in sized], default=1)
        wmax = max([s.shape[1] for s in sized], default=1)
        out = np.ones((max(len(sized), 1), hmax, wmax, 4), np.float32)
        sizes = np.ones((max(len(sized), 1), 2), np.int32)
        for i, img in enumerate(sized):
            h, w = img.shape[:2]
            out[i, :h, :w, :img.shape[-1]] = img
            if img.shape[-1] < 4:
                out[i, :h, :w, 3] = 1.0
            sizes[i] = (w, h)
        return TextureStack(data=torch.as_tensor(out, device=device),
                            sizes=torch.as_tensor(sizes, device=device))

    def with_packed_corners(self) -> "TextureStack":
        """The stack with its corner-packed quad array (built in numpy on
        the host, then placed beside ``data``)."""
        data = self.data.detach().cpu().numpy()
        n, h, w, _ = data.shape
        sizes = (self.sizes.cpu().numpy() if self.sizes is not None
                 else np.tile(np.asarray([[w, h]], np.int32), (n, 1)))
        quad = np.empty((n, h, w, 16), np.float32)
        for i in range(n):
            wi, hi = int(sizes[i, 0]), int(sizes[i, 1])
            img = data[i, :hi, :wi]
            xp = np.roll(img, -1, axis=1)       # (y, x+1), native wrap
            yp = np.roll(img, -1, axis=0)       # (y+1, x)
            xyp = np.roll(xp, -1, axis=0)       # (y+1, x+1)
            quad[i, :hi, :wi] = np.concatenate([img, xp, yp, xyp], -1)
            quad[i, hi:, :] = 1.0
            quad[i, :, wi:] = 1.0
        return dataclasses.replace(
            self, quad=torch.as_tensor(quad, device=self.data.device))


def _tex_size(stack: TextureStack, tid):
    """Per-fetch native (w, h) as i32[R] each: from the size table, or
    the full stack dims without one.  ``tid`` int64[R], in range."""
    _, h, w, _ = stack.data.shape
    if stack.sizes is None:
        return (torch.full(tid.shape, w, dtype=torch.int32,
                           device=tid.device),
                torch.full(tid.shape, h, dtype=torch.int32,
                           device=tid.device))
    wh = take_rows(stack.sizes, tid)
    return wh[:, 0], wh[:, 1]


def _texel_rows(arr, tid, y, x):
    """``arr[tid, y, x]`` as one row gather of the flat texel index
    ``(tid * H + y) * W + x`` from ``arr`` viewed as [N*H*W, C]."""
    _, h, w, c = arr.shape
    flat = (tid * h + y.long()) * w + x.long()
    return take_rows(arr.reshape(-1, c), flat)


def _sharded_texel_rows(mesh, arr, tid, y, x):
    """``_texel_rows`` from a texture array split over the "model" axis of
    ``mesh`` (a ``MeshArray``): per data row, each shard gathers the rows
    whose texture id it owns and gives zeros elsewhere, and one sum of the
    shards' results (moved to the row's device) assembles the rows; one
    shard owns each id, so the sum is the fetch.  Over processes each
    process gathers for its own shards and the rest come over the row's
    process group (``parallel/mesh.py:model_stack``)."""
    from prismarine_core_tpu_torch.parallel.mesh import (
        assemble_rows, model_stack, row_slices)
    mp = mesh.shape["model"]
    nl = arr.shape[0] // mp
    slices = row_slices(mesh, tid.shape[0])
    out = {}
    for i, sl in enumerate(slices):
        if sl.start == sl.stop or not mesh.participates(i):
            continue
        parts = {}
        for j in range(mp):
            if not mesh.is_local(i, j):
                continue
            dev = mesh.devices[i][j]
            lid = tid[sl].to(dev) - j * nl
            own = (lid >= 0) & (lid < nl)
            rows = _texel_rows(arr.local(j, dev), torch.where(own, lid, 0),
                               y[sl].to(dev), x[sl].to(dev))
            parts[j] = torch.where(own[:, None], rows, 0.0).to(
                mesh.row_device(i))
        stacked = model_stack(mesh, i, parts)
        acc = stacked[0]
        for j in range(1, mp):
            acc = acc + stacked[j]
        out[i] = acc.to(tid.device)
    return assemble_rows(mesh, out, slices)


def sample_bilinear(stack: TextureStack, tex_id: torch.Tensor,
                    uv: torch.Tensor) -> torch.Tensor:
    """Bilinear texture fetch: tex_id i32[R], uv f32[R,2] -> f32[R,4].

    Wrap addressing at each texture's native resolution (floored modulo,
    so negative uv wrap as GL_REPEAT does); tex_id < 0 returns white."""
    n = stack.data.shape[0]
    tid = torch.clamp(tex_id, 0, n - 1).long()
    wi, hi = _tex_size(stack, tid)
    wf = wi.to(torch.float32)
    hf = hi.to(torch.float32)
    u = torch.remainder(uv[:, 0], 1.0)
    v = torch.remainder(uv[:, 1], 1.0)
    x = u * wf - 0.5
    y = v * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int32), wi)
    y0i = torch.remainder(y0.to(torch.int32), hi)
    if stack.mesh is not None:
        def fetch(arr, y, x):
            return _sharded_texel_rows(stack.mesh, arr, tid, y, x)
    else:
        def fetch(arr, y, x):
            return _texel_rows(arr, tid, y, x)
    if stack.quad is not None:
        # corner-packed: one row gather yields all four texels
        q = fetch(stack.quad, y0i, x0i)                     # [R, 16]
        c00, c10, c01, c11 = (q[:, 0:4], q[:, 4:8], q[:, 8:12],
                              q[:, 12:16])
    else:
        x1i = torch.remainder(x0i + 1, wi)
        y1i = torch.remainder(y0i + 1, hi)
        c00 = fetch(stack.data, y0i, x0i)
        c10 = fetch(stack.data, y0i, x1i)
        c01 = fetch(stack.data, y1i, x0i)
        c11 = fetch(stack.data, y1i, x1i)
    col = ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
           + (c01 * (1 - fx) + c11 * fx) * fy)
    return torch.where(tex_id[:, None] < 0, torch.ones_like(col), col)


def _cubic(v):
    """Cubic B-spline weights f32[R,4] at fractional offsets v f32[R]."""
    nvec = torch.stack([1.0 - v, 2.0 - v, 3.0 - v, 4.0 - v], dim=-1)
    s = nvec * nvec * nvec
    x = s[..., 0]
    y = s[..., 1] - 4.0 * x
    z = s[..., 2] - 4.0 * s[..., 1] + 6.0 * x
    ww = 6.0 - x - y - z
    return torch.stack([x, y, z, ww], dim=-1) * (1.0 / 6.0)


def sample_bicubic(stack: TextureStack, tex_id: torch.Tensor,
                   uv: torch.Tensor) -> torch.Tensor:
    """Bicubic (cubic B-spline) fetch as four bilinear taps at
    weight-shifted coordinates (each 4-tap row and column pair collapses
    into one bilinear fetch)."""
    n = stack.data.shape[0]
    wi, hi = _tex_size(stack, torch.clamp(tex_id, 0, n - 1).long())
    size = torch.stack([wi, hi], dim=-1).to(torch.float32)   # [R,2]
    tc = uv * size
    fxy = torch.remainder(tc, 1.0)
    base = torch.floor(tc)
    xc = _cubic(fxy[:, 0])
    yc = _cubic(fxy[:, 1])
    sx0 = xc[:, 0] + xc[:, 1]
    sx1 = xc[:, 2] + xc[:, 3]
    sy0 = yc[:, 0] + yc[:, 1]
    sy1 = yc[:, 2] + yc[:, 3]
    ox0 = (base[:, 0] + 0.0 + xc[:, 1] / sx0) / size[:, 0]
    ox1 = (base[:, 0] + 1.0 + xc[:, 3] / sx1) / size[:, 0]
    oy0 = (base[:, 1] + 0.0 + yc[:, 1] / sy0) / size[:, 1]
    oy1 = (base[:, 1] + 1.0 + yc[:, 3] / sy1) / size[:, 1]

    s00 = sample_bilinear(stack, tex_id, torch.stack([ox0, oy0], -1))
    s10 = sample_bilinear(stack, tex_id, torch.stack([ox1, oy0], -1))
    s01 = sample_bilinear(stack, tex_id, torch.stack([ox0, oy1], -1))
    s11 = sample_bilinear(stack, tex_id, torch.stack([ox1, oy1], -1))

    wx = (sx0 / (sx0 + sx1))[:, None]
    wy = (sy0 / (sy0 + sy1))[:, None]
    top = s10 + (s00 - s10) * wx     # mix(sample1, sample0, sx)
    bot = s11 + (s01 - s11) * wx
    return bot + (top - bot) * wy


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


#: Rec. 709 luminance weights
_LUM = (0.2126, 0.7152, 0.0722)


def _env_texel_probs(env: Environment) -> torch.Tensor:
    """Per-texel selection probabilities f32[H, W] (sum 1), weighted by
    the reconstructed luminance x sin(theta) (the solid angle of an
    equirect row).  The luminance is tent-filtered with (1/8, 3/4, 1/8)
    per axis, periodic in x and edge-clamped in y: the per-cell average
    of the bilinear reconstruction ``Environment.sample`` fetches, so
    the energy bilinear filtering spreads around a spiky sun keeps its
    probability."""
    h, _, _ = env.image.shape
    img = env.image * env.scale
    lum = torch.clamp(img[..., 0] * _LUM[0] + img[..., 1] * _LUM[1]
                      + img[..., 2] * _LUM[2], min=0.0)
    k0, k1 = 0.75, 0.125
    lum = k0 * lum + k1 * (torch.roll(lum, 1, dims=1)
                           + torch.roll(lum, -1, dims=1))
    lum_up = torch.cat([lum[:1], lum[:-1]], dim=0)
    lum_dn = torch.cat([lum[1:], lum[-1:]], dim=0)
    lum = k0 * lum + k1 * (lum_up + lum_dn)
    theta = ((torch.arange(h, dtype=torch.float32, device=lum.device) + 0.5)
             / h * math.pi)
    wgt = lum * torch.sin(theta)[:, None] + 1e-12
    return wgt / wgt.sum()


def sample_env_direction(env: Environment, u1, u2):
    """Directions from the env's luminance distribution: u1, u2 f32[R]
    -> (d f32[R,3], pdf f32[R] in solid angle).  Inverse CDF over the
    flattened texels (u1; the first texel whose CDF is >= u1), then
    in-texel jitter (the CDF remainder for x, u2 for y).  The CDF sums in
    float64 on every device, rounded once to float32, so the card and
    the CPU pick texels from the same steps."""
    h, w, _ = env.image.shape
    pf = _env_texel_probs(env).reshape(-1)
    cdf = torch.cumsum(pf, dim=0, dtype=torch.float64).to(torch.float32)
    idx = torch.clamp(torch.searchsorted(cdf, u1.contiguous(), right=False),
                      0, h * w - 1)
    y = idx // w
    x = idx % w
    p_idx = pf[idx]
    cdf_lo = torch.where(idx > 0, cdf[torch.clamp(idx - 1, min=0)], 0.0)
    jx = torch.clamp((u1 - cdf_lo) / torch.clamp(p_idx, min=1e-20),
                     0.0, 1.0)
    u = (x.to(torch.float32) + jx) / w
    v = (y.to(torch.float32) + u2) / h
    phi = (u - 0.5) * (2.0 * math.pi)
    sin_t = torch.sin(math.pi * v)
    d = torch.stack([sin_t * torch.cos(phi),
                     torch.cos(math.pi * v),
                     sin_t * torch.sin(phi)], dim=-1)
    # pdf_solid = p_texel / texel solid angle, dOmega = 2 pi^2 sin(t)/(h w)
    pdf = p_idx * (h * w) / (2.0 * math.pi ** 2
                             * torch.clamp(sin_t, min=1e-6))
    return d, pdf


def env_pdf(env: Environment, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of ``sample_env_direction`` at directions d
    f32[R,3] (the other half of the MIS weight)."""
    h, w, _ = env.image.shape
    p = _env_texel_probs(env)
    u = torch.atan2(d[:, 2], d[:, 0]) / (2.0 * math.pi) + 0.5
    v = 0.5 - torch.asin(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi
    x = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    y = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    sin_t = torch.sqrt(torch.clamp(1.0 - d[:, 1] ** 2, min=1e-12))
    return take_rows(p.reshape(-1), y * w + x) * (h * w) / (
        2.0 * math.pi ** 2 * torch.clamp(sin_t, min=1e-6))
