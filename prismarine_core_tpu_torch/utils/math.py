"""Small vector-math helpers on batched ``[..., 3]`` tensors.

The counterpart of ``prismarine_core_tpu.utils.math``.  Dot and cross
products are written out component by component, left to right, so the
rounding is the same on every device and matches the JAX package's
formulas term for term.
"""

from __future__ import annotations

import torch


def dot(a, b, keepdim: bool = False):
    """Batched vec3 dot product over the last axis."""
    out = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return out.unsqueeze(-1) if keepdim else out


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(v, keepdim: bool = False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdim=keepdim), min=1e-30))


def normalize(v):
    return v / length(v, keepdim=True)


def reflect(d, n):
    """GLSL reflect: d - 2*dot(d,n)*n (d points *into* the surface)."""
    return d - 2.0 * dot(d, n, keepdim=True) * n


def refract(d, n, eta):
    """GLSL refract; zero vector on total internal reflection (k <= 0)."""
    cosi = dot(n, d, keepdim=True)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    refr = eta * d - (
        eta * cosi + torch.sqrt(torch.where(k > 0.0, k, 1.0))) * n
    return torch.where(k <= 0.0, torch.zeros_like(d), refr)


def faceforward(n, i):
    """Flip ``n`` to oppose incident direction ``i``."""
    return torch.where(dot(n, i, keepdim=True) < 0.0, n, -n)


def orthonormal_basis(n):
    """Tangent frame around ``n``: the coordinate axis least aligned with
    ``n``, then two cross products (the reference's axis-pick rule)."""
    sqrt_third = 0.57735026
    ax = torch.abs(n[..., 0:1]) < sqrt_third
    ay = torch.abs(n[..., 1:2]) < sqrt_third
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    ex, ey, ez = (eye[i].expand(n.shape) for i in range(3))
    perp0 = torch.where(ax, ex, torch.where(ay, ey, ez))
    t = normalize(cross(n, perp0))
    b = cross(n, t)
    return t, b


def luminance_length(c):
    """The reference's ``mlength``: the plain vector length of an RGB
    triple."""
    return length(c)


def mix(a, b, t):
    return a + (b - a) * t


def safe_rcp(x, eps: float = 1e-12):
    """Reciprocal with sign-preserving clamp away from zero."""
    return 1.0 / torch.where(torch.abs(x) < eps,
                             torch.where(x < 0, -eps, eps), x)


def take_rows(table, idx):
    """``table[idx]`` for a 1-D int64 index.  The values are the same; the
    backward scatter-adds with ``index_add_`` (atomics on the card)
    instead of advanced indexing's sort-based accumulation, which on CUDA
    walks each repeated index serially: a 6-row material table gathered
    by 921,600 lanes took ~100 ms per backward there."""
    return torch.index_select(table, 0, idx)
