"""Port primitives against the JAX package: Morton codes (30- and 60-bit),
sampling formulas, Moller-Trumbore, the sphere and slab tests, the brute
intersectors and the RGB length.

Integers must be equal.  Floats are held two ways.

Against numpy: the sampling formulas, Moller-Trumbore and the sphere test
are written out again below in numpy float32, term for term, and the port
must equal them bit for bit.  numpy rounds every float32 add, multiply,
divide and compare on its own, correctly, on any host, and the port
rounds each product before the add that follows (no fused multiply-add;
checked below on the cross product), so this check does not depend on the
host.  sqrt, sin and cos are library functions on the port's side,
torch's CPU kernels, whose last bit depends on the host's vector unit
(torch's float32 sqrt is not correctly rounded on every host): the numpy
formulas take the port's own values of them, each held to 1 ulp of the
float64 value rounded to float32.

Against the JAX package: XLA on the CPU may contract a multiply and the
add that follows into one fused multiply-add, or not, depending on how it
compiles for the host, and it evaluates sin and cos with its own
polynomial.  Each such stage moves its result by up to 1 ulp at the
stage's scale, and the later stages carry that on, so an output is held
to 1 ulp per such stage on its chain (``JAX_STAGES``), at the scale of the
computation.  Where an output cancels (a cross product near zero) its own
ulp is meaningless, so the scale is the operands'; Moller-Trumbore's t, u,
v are numerators times 1/det, so their scale is the numerator's terms over
|det|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax.numpy as jnp  # noqa: E402

from prismarine_core_tpu.ops import intersect as ji  # noqa: E402
from prismarine_core_tpu.ops import morton as jmo  # noqa: E402
from prismarine_core_tpu.ops import sampling as js  # noqa: E402
from prismarine_core_tpu.utils import math as jm  # noqa: E402
from prismarine_core_tpu_torch.ops import intersect as ti  # noqa: E402
from prismarine_core_tpu_torch.ops import morton as tmo  # noqa: E402
from prismarine_core_tpu_torch.ops import sampling as ts  # noqa: E402
from prismarine_core_tpu_torch.utils import math as tm  # noqa: E402

torch.set_num_threads(1)

F = np.float32
#: the stages of each output that XLA may contract (a multiply, then an
#: add) or approximate (sin, cos): its bound in ulps against the JAX
#: package
JAX_STAGES = {
    # the tangent's length, b = n x t, cos and sin, the weighted sum of
    # the frame, the result's length (n x axis is exact: the axis is 0/1)
    "cosine_hemisphere": 5,
    # 1 - up * up, cos and sin
    "uniform_sphere": 2,
    # the length
    "normalize": 1,
    # dot(l, n)
    "light_sampling_weight": 1,
    # the numerator's cross and dot product, and det's, through 1/det
    "moller_trumbore": 4,
    # dot(to, d), dot(to, to) - r * r, b * b - 4 * c
    "intersect_sphere": 3,
}


def assert_ulp(port, ref, scale, n_ulp=1.0):
    """|port - ref| <= n_ulp ulps of max(|ref|, scale) (float32)."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    mag = np.maximum(np.abs(ref), scale).astype(np.float32)
    err = np.abs(port - ref) / np.spacing(mag).astype(np.float64)
    assert err.max() <= n_ulp, f"max error {err.max():.2f} ulp"


def T(*xs):
    return [torch.as_tensor(x) for x in xs]


def J(*xs):
    return [jnp.asarray(x) for x in xs]


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def assert_bits(port, ref, what):
    port = np.asarray(port)
    assert port.dtype == ref.dtype and port.shape == ref.shape, what
    assert np.array_equal(port.view(np.int32) if port.dtype == F else port,
                          ref.view(np.int32) if ref.dtype == F else ref), (
        what, int((port != ref).sum()))


# numpy float32 formulas of the port's primitives, term for term


def np_dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def np_cross(a, b):
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def port_fn(f, g, x):
    """The port's own ``f`` (``torch.sqrt``, ``torch.cos`` or
    ``torch.sin``) of the float32 array ``x``, held to 1 ulp of numpy's
    float64 ``g`` rounded to float32."""
    y = f(torch.from_numpy(np.ascontiguousarray(x))).numpy()
    ref = g(x.astype(np.float64)).astype(F)
    err = (np.abs(y.astype(np.float64) - ref)
           / np.spacing(np.abs(ref)).astype(np.float64))
    assert err.max() <= 1.0, (f.__name__, err.max())
    return y


def np_sqrt(x):
    return port_fn(torch.sqrt, np.sqrt, x)


def np_normalize(v):
    return v / np_sqrt(np.maximum(np_dot(v, v), F(1e-30)))[..., None]


def np_around(u2):
    return u2 * F(2.0) * F(np.pi)


def port_cos_sin(around):
    return (port_fn(torch.cos, np.cos, around),
            port_fn(torch.sin, np.sin, around))


def np_cosine_hemisphere(n, u1, u2):
    up = np_sqrt(u1)[:, None]
    over = np_sqrt(np.maximum(F(1.0) - u1, F(0.0)))[:, None]
    c, s = (x[:, None] for x in port_cos_sin(np_around(u2)))
    third = F(0.57735026)
    eye = np.eye(3, dtype=F)
    perp0 = np.where(np.abs(n[:, 0:1]) < third, eye[0],
                     np.where(np.abs(n[:, 1:2]) < third, eye[1], eye[2]))
    t = np_normalize(np_cross(n, perp0))
    b = np_cross(n, t)
    return np_normalize(n * up + t * c * over + b * s * over)


def np_uniform_sphere(u1, u2):
    up = u1 * F(2.0) - F(1.0)
    over = np_sqrt(np.maximum(F(1.0) - up * up, F(0.0)))
    c, s = port_cos_sin(np_around(u2))
    return np.stack([up, c * over, s * over], -1)


def np_light_sampling_weight(ldir, n, radius, dist):
    c = np.clip(np_dot(ldir, n) * F(2.0)
                * (radius / np.maximum(dist, F(1e-6))) ** 2, F(0.0), F(1.0))
    return F(1.0) - np_sqrt(np.maximum(F(1.0) - c, F(1e-12)))


def np_moller_trumbore(o, d, v0, v1, v2):
    e1, e2 = v1 - v0, v2 - v0
    p = np_cross(d, e2)
    det = np_dot(e1, p)
    inv = F(1.0) / np.where(np.abs(det) < F(1e-10), F(1e-10), det)
    s = o - v0
    u = np_dot(s, p) * inv
    q = np_cross(s, e1)
    v = np_dot(d, q) * inv
    t = np_dot(e2, q) * inv
    ok = ((np.abs(det) >= F(1e-10)) & (u >= F(0.0)) & (v >= F(0.0))
          & (u + v <= F(1.0)) & (t > F(0.0005)))
    return np.where(ok, t, F(10000.0)), u, v, ok


def np_intersect_sphere(o, d, center, radius):
    to = o - center
    b = F(2.0) * np_dot(to, d)
    c = np_dot(to, to) - radius * radius
    disc = b * b - F(4.0) * c
    sq = np_sqrt(np.where(disc > F(0.0), disc, F(1.0)))
    t1 = F(0.5) * (-b - sq)
    t2 = F(0.5) * (-b + sq)
    mn, mx = np.minimum(t1, t2), np.maximum(t1, t2)
    t = np.where(mx >= F(0.0), np.where(mn >= F(0.0), mn, mx), F(10000.0))
    return np.where(disc > F(0.0), t, F(10000.0))


def test_morton_codes_equal():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 1024, (5000, 3))
    got = tmo.morton30(torch.as_tensor(q)).numpy()
    ref = np.asarray(jmo.morton30(jnp.asarray(q, jnp.uint32)))
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    p = rng.uniform(-0.2, 1.2, (5000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tmo.quantize_unit(torch.as_tensor(p)).numpy(),
        np.asarray(jmo.quantize_unit(jnp.asarray(p))).astype(np.int64))


def test_port_cross_is_unfused_float32():
    """The port rounds every product (no FMA): it equals numpy's float32
    evaluation of the formula exactly."""
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 4000, 3)).astype(np.float32)
    ref = np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                    a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                    a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)
    np.testing.assert_array_equal(tm.cross(*T(a, b)).numpy(), ref)
    assert_ulp(tm.cross(*T(a, b)), jm.cross(*J(a, b)),
               scale=(np.abs(a).max(1) * np.abs(b).max(1))[:, None])


def test_sampling_formulas_match_jax():
    """Equal to the numpy formulas bit for bit; within their stages of
    the JAX package (``JAX_STAGES``)."""
    rng = np.random.default_rng(2)
    n = _unit(rng, 20000)
    u1, u2 = rng.random((2, 20000)).astype(np.float32)
    radius = rng.uniform(0.5, 2.0, 20000).astype(np.float32)
    dist = rng.uniform(1.0, 100.0, 20000).astype(np.float32)
    m = n[::-1].copy()
    cases = {
        "cosine_hemisphere": (ts.cosine_hemisphere, js.cosine_hemisphere,
                              np_cosine_hemisphere, (n, u1, u2)),
        "uniform_sphere": (ts.uniform_sphere, js.uniform_sphere,
                           np_uniform_sphere, (u1, u2)),
        "normalize": (tm.normalize, jm.normalize, np_normalize,
                      (F(3.0) * n,)),
        "light_sampling_weight": (
            ts.light_sampling_weight, js.light_sampling_weight,
            np_light_sampling_weight, (n, m, radius, dist)),
    }
    for name, (port_fn, jax_fn, np_fn, args) in cases.items():
        port = port_fn(*T(*args)).numpy()
        assert_bits(port, np_fn(*args), name)
        assert_ulp(port, jax_fn(*J(*args)), scale=1.0,
                   n_ulp=JAX_STAGES[name])


def test_moller_trumbore_and_sphere_match_jax():
    rng = np.random.default_rng(3)
    r = 20000
    o = rng.uniform(-3, 3, (r, 3)).astype(np.float32)
    d = _unit(rng, r)
    v0, v1, v2 = rng.uniform(-2, 2, (3, r, 3)).astype(np.float32)
    tj, uj, vj, okj = (np.asarray(x) for x in ji.moller_trumbore(
        *J(o, d, v0, v1, v2)))
    tt, ut, vt, okt = (x.numpy() for x in ti.moller_trumbore(
        *T(o, d, v0, v1, v2)))
    for k, p, ref in zip(("t", "u", "v", "ok"), (tt, ut, vt, okt),
                         np_moller_trumbore(o, d, v0, v1, v2)):
        assert_bits(p, ref, f"moller_trumbore {k}")
    np.testing.assert_array_equal(okt, okj)
    det = np.abs(np.einsum("ij,ij->i", v1 - v0,
                           np.cross(d, v2 - v0))).astype(np.float64)
    # numerator terms are products of coordinates of magnitude <= 5
    scale = 25.0 / np.maximum(det, 1e-6)
    for p, j in ((tt, tj), (ut, uj), (vt, vj)):
        assert_ulp(p[okt], j[okt], scale=scale[okt],
                   n_ulp=JAX_STAGES["moller_trumbore"])

    c = rng.uniform(-1, 1, (r, 3)).astype(np.float32)
    rad = rng.uniform(0.5, 2.0, r).astype(np.float32)
    port = ti.intersect_sphere(*T(o, d, c, rad)).numpy()
    assert_bits(port, np_intersect_sphere(o, d, c, rad), "intersect_sphere")
    assert_ulp(port, ji.intersect_sphere(*J(o, d, c, rad)), scale=1.0,
               n_ulp=JAX_STAGES["intersect_sphere"])


@pytest.mark.parametrize("n_tris,r,block", [(50, 64, 16), (300, 333, 64)])
def test_brute_intersectors_match_jax(n_tris, r, block):
    from prismarine_core_tpu.models.geometry import TriangleSoup as JSoup
    from prismarine_core_tpu_torch.models.geometry import TriangleSoup
    rng = np.random.default_rng(4)
    centers = rng.uniform(-5, 5, (n_tris, 3)).astype(np.float32)
    verts = np.concatenate([centers + rng.normal(0, 0.3, (n_tris, 3))
                            for _ in range(3)]).astype(np.float32)
    faces = np.stack([np.arange(n_tris) + k * n_tris for k in range(3)], 1)
    js_soup = JSoup.from_arrays(verts, faces, capacity=n_tris + 7)
    ts_soup = TriangleSoup.from_arrays(verts, faces, capacity=n_tris + 7,
                                       device="cpu")
    o = rng.uniform(-8, 8, (r, 3)).astype(np.float32)
    aim = centers[rng.integers(0, n_tris, r)] + rng.normal(0, 0.2, (r, 3))
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    d = d.astype(np.float32)
    hj = ji.intersect_closest_brute(js_soup, *J(o, d), block=block)
    ht = ti.intersect_closest_brute(ts_soup, *T(o, d), block=block)
    tri_j, tri_t = np.asarray(hj.tri), ht.tri.numpy()
    diff = int((tri_j != tri_t).sum())
    print(f"brute closest: {diff} of {r} lanes pick another triangle")
    assert diff <= max(1, r // 1000)
    both = (tri_j == tri_t) & (tri_j >= 0)
    assert both.sum() > r // 10
    tri = tri_t[both]
    v0 = verts[tri]
    e1 = verts[tri + n_tris] - v0
    e2 = verts[tri + 2 * n_tris] - v0
    det = np.abs(np.einsum("ij,ij->i", e1, np.cross(d[both], e2)))
    assert_ulp(ht.t.numpy()[both], np.asarray(hj.t)[both],
               scale=256.0 / np.maximum(det, 1e-6), n_ulp=2.0)
    t_max = rng.uniform(0.5, 20, r).astype(np.float32)
    occ_j = np.asarray(ji.occluded_brute(js_soup, *J(o, d, t_max),
                                         block=block))
    occ_t = ti.occluded_brute(ts_soup, *T(o, d, t_max), block=block).numpy()
    assert (occ_j != occ_t).sum() <= max(1, r // 1000)


def test_aabb_slab():
    """tests/test_intersect.py:101 on the port: a ray into a box enters at
    t = 4; a ray from inside hits."""
    o = torch.tensor([[0.0, 0.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    inv = tm.safe_rcp(d)
    lo = torch.tensor([[-1.0, -1.0, -1.0]])
    hi = torch.tensor([[1.0, 1.0, 1.0]])
    tn, hitm = ti.intersect_aabb(o, inv, lo, hi)
    assert bool(hitm[0])
    np.testing.assert_allclose(float(tn[0]), 4.0, rtol=1e-5)
    tn2, h2 = ti.intersect_aabb(torch.zeros((1, 3)), inv, lo, hi)
    assert bool(h2[0])


def test_intersect_aabb_equals_jax():
    """Random rays against random boxes (broadcast [R, 1] x [1, B]), with
    the default and explicit limits: entry distance and mask bit for bit."""
    rng = np.random.default_rng(11)
    o = rng.uniform(-4, 4, (256, 1, 3)).astype(np.float32)
    d = rng.normal(size=(256, 1, 3)).astype(np.float32)
    d[:8, :, 0] = 0.0                        # axis-parallel rays
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d).astype(np.float32)
    c = rng.uniform(-3, 3, (1, 64, 3)).astype(np.float32)
    h = rng.uniform(0.05, 1.5, (1, 64, 3)).astype(np.float32)
    lo, hi = c - h, c + h
    for kw in ({}, dict(t_min=0.0, t_max=2.5)):
        tn, hit = ti.intersect_aabb(*(torch.tensor(x) for x in
                                      (o, inv, lo, hi)), **kw)
        tn_j, hit_j = ji.intersect_aabb(*(jnp.asarray(x) for x in
                                          (o, inv, lo, hi)), **kw)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(tn_j))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_j))
        assert 0 < int(hit.sum()) < hit.numel()


def test_morton60_equals_jax():
    rng = np.random.default_rng(12)
    q = rng.integers(0, 1 << 20, (5000, 3))
    hi, lo = tmo.morton60(torch.as_tensor(q))
    hi_j, lo_j = jmo.morton60(jnp.asarray(q, jnp.uint32))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j).astype(
        np.int64))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j).astype(
        np.int64))
    # (hi, lo) orders as the interleaved 60-bit code
    code = (hi << 30) | lo
    bits = np.zeros(5000, dtype=object)
    for b in range(20):
        for a in range(3):
            bits = bits | (((q[:, a] >> b) & 1).astype(object) << (3 * b + a))
    np.testing.assert_array_equal(np.argsort(code.numpy(), kind="stable"),
                                  np.argsort(bits.astype(np.int64),
                                             kind="stable"))


def test_luminance_length_equals_jax():
    rng = np.random.default_rng(13)
    c = rng.uniform(0, 4, (4096, 3)).astype(np.float32)
    got = tm.luminance_length(torch.tensor(c)).numpy()
    ref = np.asarray(jm.luminance_length(jnp.asarray(c)))
    assert_ulp(got, ref, np.sqrt((c.astype(np.float64) ** 2).sum(-1)))
