"""Ray-triangle and ray-sphere tests, and the brute-force intersectors.

The counterpart of ``prismarine_core_tpu.ops.intersect``.  The brute
intersectors are the port's test oracle (and ``intersector="brute"``):
they stream triangle blocks through a Python loop with a running-best
combine, lowest triangle index winning at equal t.
"""

from __future__ import annotations

import dataclasses

import torch

from prismarine_core_tpu_torch.utils import math as pm
from prismarine_core_tpu_torch.utils.config import INF_DIST, PZERO

_DET_EPS = 1e-10


@dataclasses.dataclass
class Hit:
    """Closest-hit record over rays; ``tri == -1`` means miss (``t`` is
    then INF_DIST)."""

    t: torch.Tensor    # f32[R]
    tri: torch.Tensor  # i32[R]
    u: torch.Tensor    # f32[R] barycentric
    v: torch.Tensor    # f32[R]

    @property
    def missed(self) -> torch.Tensor:
        return self.tri < 0


def moller_trumbore(o, d, v0, v1, v2, eps: float = PZERO):
    """Double-sided Moller-Trumbore, broadcasting over leading dims.

    Returns (t, u, v, hit_mask); ``t`` is INF_DIST where there is no hit.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    p = pm.cross(d, e2)
    det = pm.dot(e1, p)
    inv = 1.0 / torch.where(torch.abs(det) < _DET_EPS, _DET_EPS, det)
    s = o - v0
    u = pm.dot(s, p) * inv
    q = pm.cross(s, e1)
    v = pm.dot(d, q) * inv
    t = pm.dot(e2, q) * inv
    ok = ((torch.abs(det) >= _DET_EPS)
          & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps))
    return torch.where(ok, t, INF_DIST), u, v, ok


def intersect_closest_brute(soup, o, d, block: int = 512) -> Hit:
    """Closest hit over all triangles, streamed in blocks of ``block``.
    o, d: f32[R,3]."""
    r = o.shape[0]
    dev = o.device
    bt = torch.full((r,), INF_DIST, dtype=torch.float32, device=dev)
    btri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros((r,), dtype=torch.float32, device=dev)
    bv = torch.zeros((r,), dtype=torch.float32, device=dev)
    rows = torch.arange(r, device=dev)
    for base in range(0, soup.capacity, block):
        sl = slice(base, base + block)
        t, u, v, ok = moller_trumbore(
            o[:, None, :], d[:, None, :], soup.v0[None, sl],
            soup.v1[None, sl], soup.v2[None, sl])
        t = torch.where(ok & soup.valid[None, sl], t, INF_DIST)
        j = torch.argmin(t, dim=1)                  # first-min tie-break
        tn = t[rows, j]
        trin = base + j.to(torch.int32)
        better = (tn < bt) | ((tn == bt) & (trin < btri) & (tn < INF_DIST))
        bt = torch.where(better, tn, bt)
        btri = torch.where(better, trin, btri)
        bu = torch.where(better, u[rows, j], bu)
        bv = torch.where(better, v[rows, j], bv)
    btri = torch.where(bt < INF_DIST, btri, -1)
    return Hit(t=bt, tri=btri, u=bu, v=bv)


def occluded_brute(soup, o, d, t_max, block: int = 512):
    """Any-hit query: True where some triangle lies in (PZERO, t_max)."""
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for base in range(0, soup.capacity, block):
        sl = slice(base, base + block)
        t, _, _, ok = moller_trumbore(
            o[:, None, :], d[:, None, :], soup.v0[None, sl],
            soup.v1[None, sl], soup.v2[None, sl])
        occ |= (ok & soup.valid[None, sl] & (t < t_max[:, None])).any(dim=1)
    return occ


def intersect_aabb(o, inv_d, lo, hi, t_min: float = PZERO,
                   t_max: float = INF_DIST):
    """Slab test of rays against boxes (broadcasting over leading axes):
    (entry distance max(tn, t_min), hit mask)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    tn_min = torch.clamp(tn, min=t_min)
    return tn_min, (tf >= tn_min) & (tn <= t_max)


def intersect_sphere(o, d, center, radius):
    """Nearest positive t of the quadratic sphere test, or INF_DIST."""
    to = o - center
    b = 2.0 * pm.dot(to, d)
    c = pm.dot(to, to) - radius * radius
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    t1 = 0.5 * (-b - sq)
    t2 = 0.5 * (-b + sq)
    mn = torch.minimum(t1, t2)
    mx = torch.maximum(t1, t2)
    t = torch.where(mx >= 0.0, torch.where(mn >= 0.0, mn, mx), INF_DIST)
    return torch.where(disc > 0.0, t, INF_DIST)
