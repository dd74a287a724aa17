"""The plain reference's hit search: triangle clusters and brute force.

The triangles are sorted by the Morton code of their centroids and cut
into clusters of ``CLUSTER`` consecutive ones, each with its bounding box
(padded by ``BOX_PAD``).  A query tests every ray against every cluster
box, visits each ray's clusters nearest entry first, and brute-forces the
triangles of each one it visits (Moller-Trumbore, double-sided, a hit
needs ``|det| >= 1e-10``, barycentrics inside and ``t > PZERO``), until
no remaining cluster can hold a hit below the ray's best.  Closest hits
keep the smallest t strictly below the ray's cap (among equal t in one
cluster the lowest triangle index); any-hit queries stop a ray at its
first hit below its cap.  A ray whose cap is at most PZERO has no hit.

Plain torch and numpy only: no kernel, no import of the program.  The
clusters are built once from the geometry they are given; the train
step's reference searches the clusters of its starting geometry and
re-evaluates each hit on the current vertices (``tracer.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PZERO = 0.0005
INF_DIST = 10000.0
DET_EPS = 1e-10
#: triangles a cluster
CLUSTER = 64
#: absolute padding of a cluster box: no rounding of the slab test can
#: then drop a triangle on the box's face
BOX_PAD = 1e-4
#: nearest clusters a ray takes in the first pass; a ray that enters more
#: boxes below its best gets a second pass over all of them
FIRST_PASS = 64
#: (ray, cluster) entries of one block of the box test
BLOCK_ENTRIES = 1 << 25


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def moller_trumbore(o, d, v0, v1, v2):
    """(t, u, v, hit) of rays against triangles, broadcasting over leading
    dimensions; t is INF_DIST where there is no hit."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross(d, e2)
    det = dot(e1, p)
    small = torch.abs(det) < DET_EPS
    inv = 1.0 / torch.where(small, DET_EPS, det)
    s = o - v0
    u = dot(s, p) * inv
    q = cross(s, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    hit = ~small & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > PZERO)
    return torch.where(hit, t, INF_DIST), u, v, hit


def _morton(cent: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points, 10 bits an axis over their box."""
    lo, hi = cent.min(0), cent.max(0)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.int64)
    q = np.clip(q, 0, 1023)
    code = np.zeros(len(cent), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + (2 - axis))
    return code


@dataclasses.dataclass
class ClusterIndex:
    members: torch.Tensor  # i64[C, CLUSTER] triangle ids, -1 = padding
    v0: torch.Tensor       # [C, CLUSTER, 3] the members' vertices
    v1: torch.Tensor
    v2: torch.Tensor
    lo: torch.Tensor       # [C, 3] padded cluster boxes
    hi: torch.Tensor

    @property
    def count(self) -> int:
        return self.members.shape[0]


def build_index(v0, v1, v2, cluster: int = CLUSTER) -> ClusterIndex:
    """Clusters of the triangles (v0, v1, v2 [T,3], any float dtype, on
    their device); boxes from the vertices in float64, then padded."""
    dev, dtype = v0.device, v0.dtype
    tri = np.stack([x.detach().to("cpu", torch.float64).numpy()
                    for x in (v0, v1, v2)], axis=1)            # [T,3,3]
    order = np.argsort(_morton(tri.mean(1)), kind="stable")
    n = len(order)
    nc = -(-n // cluster)
    members = np.full(nc * cluster, -1, np.int64)
    members[:n] = order
    members = members.reshape(nc, cluster)
    safe = np.where(members >= 0, members, order[0])
    corners = tri[safe]                                        # [C,K,3,3]
    lo = corners.min(axis=(1, 2)) - BOX_PAD
    hi = corners.max(axis=(1, 2)) + BOX_PAD
    m = torch.as_tensor(members, device=dev)
    sm = torch.as_tensor(safe, device=dev)
    return ClusterIndex(
        members=m, v0=v0.detach()[sm], v1=v1.detach()[sm],
        v2=v2.detach()[sm],
        lo=torch.as_tensor(lo, device=dev).to(dtype),
        hi=torch.as_tensor(hi, device=dev).to(dtype))


def _inv(d):
    return 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d < 0, -1e-12, 1e-12), d)


def _entries(index, o, inv, cap):
    """Entry distance of each ray into each cluster box, INF_DIST+ where
    the box is missed or entered at or beyond the ray's cap: [A, C]."""
    tn = tf = None
    for axis in range(3):
        a = (index.lo[None, :, axis] - o[:, None, axis]) * inv[:, None, axis]
        b = (index.hi[None, :, axis] - o[:, None, axis]) * inv[:, None, axis]
        near, far = torch.minimum(a, b), torch.maximum(a, b)
        tn = near if tn is None else torch.maximum(tn, near)
        tf = far if tf is None else torch.minimum(tf, far)
    enter = torch.clamp(tn, min=PZERO)
    ok = (tf >= enter) & (enter < cap[:, None])
    return torch.where(ok, enter, float("inf"))


def _candidates(index, o, d, cap, rows, k):
    """Each ray's ``k`` nearest cluster entries (ascending; inf past the
    ones it enters) and how many boxes it enters below its cap."""
    inv = _inv(d)
    step = max(BLOCK_ENTRIES // max(index.count, 1), 1)
    keys, clus, n_ok = [], [], []
    for s in range(0, rows.shape[0], step):
        r = rows[s:s + step]
        e = _entries(index, o[r], inv[r], cap[r])
        kk, cc = torch.topk(e, k, dim=1, largest=False, sorted=True)
        keys.append(kk)
        clus.append(cc)
        n_ok.append(torch.isfinite(e).sum(1))
    return torch.cat(keys), torch.cat(clus), torch.cat(n_ok)


def _rounds(index, o, d, rows, keys, clus, best_t, best_tri, any_hit):
    """Visit each ray's listed clusters in order while the next one can
    hold a hit below its best (any-hit: until its first hit)."""
    big = index.members.shape[0] * index.members.shape[1] + 1
    act = torch.arange(rows.shape[0], device=rows.device)
    act = act[keys[:, 0] < best_t[rows]]
    j = 0
    while act.numel():
        r = rows[act]
        c = clus[act, j]
        tri = index.members[c]
        t, _, _, _ = moller_trumbore(o[r, None, :], d[r, None, :],
                                     index.v0[c], index.v1[c], index.v2[c])
        t = torch.where((tri >= 0) & (t < best_t[r, None]), t, INF_DIST)
        tmin = t.amin(1)
        cand = torch.where(t == tmin[:, None], tri, big).amin(1)
        better = tmin < best_t[r]
        best_t[r] = torch.where(better, tmin, best_t[r])
        best_tri[r] = torch.where(better, cand, best_tri[r])
        j += 1
        if j >= keys.shape[1]:
            break
        if any_hit:
            act = act[best_tri[r] < 0]
        act = act[keys[act, j] < best_t[rows[act]]]


def query(index, o, d, cap, any_hit: bool = False):
    """(t, tri) per ray: the closest hit strictly below ``cap`` (any-hit:
    some hit below it), t = cap and tri = -1 where there is none.  No
    gradient: callers re-evaluate the hit they keep."""
    with torch.no_grad():
        o, d = o.detach(), d.detach()
        cap = cap.detach().to(o.dtype)
        best_t = cap.clone()
        best_tri = torch.full(cap.shape, -1, dtype=torch.int64,
                              device=o.device)
        rows = torch.nonzero(cap > PZERO).reshape(-1)
        if rows.numel() == 0:
            return best_t, best_tri
        k = min(FIRST_PASS, index.count)
        keys, clus, n_ok = _candidates(index, o, d, cap, rows, k)
        _rounds(index, o, d, rows, keys, clus, best_t, best_tri, any_hit)
        more = rows[n_ok > k]
        if any_hit:
            more = more[best_tri[more] < 0]
        if more.numel():
            keys, clus, _ = _candidates(index, o, d, cap, more, index.count)
            _rounds(index, o, d, more, keys, clus, best_t, best_tri,
                    any_hit)
        return best_t, best_tri
