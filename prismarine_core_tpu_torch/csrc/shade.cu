// The bounce loop's shading of one bounce, one lane a ray, between the
// surface at the hit and the shadow query (shade_kernel), and the NEE
// resolve after the shadow query (nee_resolve_kernel).
//
// shade_kernel records the miss, takes the hit point and the
// face-forwarded normal, picks up the emissive, evaluates the specular
// colour model, throws the three branch coins, builds the cosine, glossy
// and refracted (or mirrored) continuations, the throughput and the
// diffuse throughput, sets up next-event estimation toward one sphere
// light (the pick, the point on the sphere, the weight heuristic, the
// sphere test, the shadow ray and the factor a visible lane adds), the
// env-NEE bsdf pdf, the throughput cut and Russian roulette, writes the
// masked carry and counts the bounce's lanes.  nee_resolve_kernel adds
// the factor where the shadow ray was not occluded.
//
// The port's own kernels: the JAX package shades in XLA
// (prismarine_core_tpu/render/integrator.py:make_bounce_step), which fuses
// the elementwise work, with no Pallas body.  Written as torch code the
// same bounce is ~350 launches, each a pass over every lane.  The plain
// versions are that torch code (ops/shade.py:shade_plain,
// nee_resolve_plain) and these kernels compute the same bits: every float
// operation below is the plain version's as torch runs it on the card, in
// its order, with the build's -fmad=false and IEEE division and square
// root (__fdiv_rn, __fsqrt_rn); torch.clamp keeps a NaN, torch.minimum
// and torch.maximum propagate one; a Python float constant is the double
// rounded to float, as torch rounds it; a division by a Python float is
// torch's multiplication by the float reciprocal; x ** e takes torch's
// route for e (ops/shade.py:pow_route); sinf, cosf and powf are the CUDA
// math library's, as in torch's kernels.
//
// What bounds it on the H100: bytes.  A lane on a surface reads the carry
// (o, d, beta, radiance, alive, the miss record: 89 B with the hit's t
// and tri), the surface's fields (ns and the [R,4] material rows: 80 B)
// and its row of uniforms, and writes the next carry and the shadow ray
// with its factor (~121 B); the light table stays in L1.  The design:
//  - one lane a ray, every input read once and every output written once,
//    coalesced (a warp's 32 lanes of an [R,3] field are 384 contiguous B);
//  - a lane off a surface reads only what it copies through (the carry and
//    the miss record) and hands the shadow query its own ray, t_query 0;
//  - the material fields read as floats at their row strides, whatever
//    the layout (the surface kernel's [R,4] rows, or the textured path's
//    modulated fields): a warp's loads of one field touch the same
//    sectors as 16-byte row loads would;
//  - sphere NEE, env NEE and Russian roulette as template flags, so a
//    bounce without them carries none of their registers;
//  - the five lane counts by __syncthreads_count and one integer
//    atomicAdd a block each (integer sums: deterministic);
//  - nothing kept between the two kernels but the shadow ray and the
//    factor: nee_resolve reads radiance, factor and the occlusion bit.
#include <cstdint>

#include "common.cuh"

namespace prismarine {
namespace {

constexpr int SHADE_THREADS = 256;
constexpr int RESOLVE_THREADS = 256;

// the pointers, in ops/shade.py's INPUTS and OUTPUTS order
enum In {
  IN_O, IN_D, IN_BETA, IN_RADIANCE, IN_ALIVE, IN_PREV_PDF, IN_MISS_DIR,
  IN_MISS_BETA, IN_MISS_PDF, IN_T, IN_TRI, IN_NS, IN_ALBEDO, IN_ALPHA,
  IN_ROUGHNESS, IN_METALLIC, IN_EMISSIVE, IN_TRANSMISSION, IN_IOR, IN_U,
  IN_L_CENTER, IN_L_RADIUS, IN_L_COLOR, N_IN
};
enum Out {
  OUT_O, OUT_D, OUT_BETA, OUT_RADIANCE, OUT_ALIVE, OUT_PREV_PDF,
  OUT_MISS_DIR, OUT_MISS_BETA, OUT_MISS_PDF, OUT_SHADOW_O, OUT_LDIR,
  OUT_T_QUERY, OUT_FACTOR, OUT_P, OUT_N, OUT_DIFFUSE_BETA, OUT_COUNTS, N_OUT
};
// the integer arguments: the row strides (floats) of the material fields
// (ops/shade.py:_MATERIAL) and of the uniforms
enum Int {
  I_RAYS, I_LIGHTS, I_FLAGS, I_POW, I_S_ALBEDO, I_S_ALPHA, I_S_ROUGHNESS,
  I_S_METALLIC, I_S_EMISSIVE, I_S_TRANSMISSION, I_S_IOR, I_S_U, N_INT
};
enum Float { FL_POW_EXP, FL_MIN_THROUGHPUT, FL_RR_MIN_Q, N_FLOAT };
// flags (ops/shade.py: F_*)
constexpr int F_NEE = 1, F_ENV = 2, F_RR = 4;
// torch.pow's routes (ops/shade.py: POW_*)
enum Pow {
  POW_POWF, POW_ONE, POW_COPY, POW_SQRT, POW_RSQRT, POW_RECIP, POW_SQUARE,
  POW_CUBE, POW_INV_SQUARE
};
// the uniforms' slots (ops/sampling.py: S_*)
constexpr int S_ALPHA = 0, S_SPEC = 1, S_COS1 = 2, S_COS2 = 3, S_GLOSS = 4,
              S_LIGHT1 = 5, S_LIGHT2 = 6, S_RESERVED = 7, S_RR = 10;

// Python floats of the plain version, rounded to float as torch rounds them
#define C_LENGTH_MIN static_cast<float>(1e-30)
#define C_COS_MIN static_cast<float>(1e-6)
#define C_TIR static_cast<float>(1e-12)
#define C_DIELECTRIC static_cast<float>(0.05)
#define C_SQRT_THIRD static_cast<float>(0.57735026)
#define C_PI static_cast<float>(3.141592653589793)
#define C_GAP static_cast<float>(2.0 * 0.0005)

struct ShadeParams {
  const void* in[N_IN];
  void* out[N_OUT];
  int ints[N_INT];
  float floats[N_FLOAT];
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 v;
  v.x = x;
  v.y = y;
  v.z = z;
  return v;
}
__device__ __forceinline__ V3 ld3(const void* p, int i) {
  const float* f = static_cast<const float*>(p) + 3 * static_cast<size_t>(i);
  return v3(__ldg(f), __ldg(f + 1), __ldg(f + 2));
}
__device__ __forceinline__ void st3(void* p, int i, V3 v) {
  float* f = static_cast<float*>(p) + 3 * static_cast<size_t>(i);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
}
__device__ __forceinline__ float ldf(const void* p, size_t k) {
  return __ldg(static_cast<const float*>(p) + k);
}
// row i of an [R,3] field of row stride s, and of an [R] field
__device__ __forceinline__ V3 ld_row3(const void* p, int s, int i) {
  const size_t k = static_cast<size_t>(s) * i;
  return v3(ldf(p, k), ldf(p, k + 1), ldf(p, k + 2));
}
__device__ __forceinline__ float ld_row1(const void* p, int s, int i) {
  return ldf(p, static_cast<size_t>(s) * i);
}

// pm.dot: (a.x*b.x + a.y*b.y) + a.z*b.z
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
// pm.cross
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi): a NaN stays
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_range(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// torch.minimum / torch.maximum: NaN if either is
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
// pm.length and pm.normalize
__device__ __forceinline__ float length3(V3 v) {
  return __fsqrt_rn(clamp_min(dot3(v, v), C_LENGTH_MIN));
}
__device__ __forceinline__ V3 normalize3(V3 v) {
  const float len = length3(v);
  return v3(__fdiv_rn(v.x, len), __fdiv_rn(v.y, len), __fdiv_rn(v.z, len));
}
// pm.mix(a, b, t) = a + (b - a) * t
__device__ __forceinline__ V3 mix3(V3 a, V3 b, float t) {
  return v3(a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t,
            a.z + (b.z - a.z) * t);
}
// pm.reflect(d, n) = d - (2 * dot(d, n)) * n, given dot(d, n)
__device__ __forceinline__ V3 reflect3(V3 d, V3 n, float dn) {
  const float k = 2.0f * dn;
  return v3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z);
}

// x ** e on the route torch takes for the config's exponent
__device__ __forceinline__ float pow_torch(float x, int route, float e) {
  switch (route) {
    case POW_ONE: return 1.0f;
    case POW_COPY: return x;
    case POW_SQRT: return __fsqrt_rn(x);
    case POW_RSQRT: return rsqrtf(x);
    case POW_RECIP: return __fdiv_rn(1.0f, x);
    case POW_SQUARE: return x * x;
    case POW_CUBE: return x * x * x;
    case POW_INV_SQUARE:
      return static_cast<float>(1.0 / static_cast<double>(x * x));
    default: return powf(x, e);
  }
}

// One lane's bounce.  Sets the lane's counts: alive, on a surface, missed,
// surviving, NEE shadow lane.
template <bool NEE, bool ENV, bool RR>
__device__ __forceinline__ void shade_lane(const ShadeParams& P, int i,
                                           bool& alive, bool& on,
                                           bool& miss, bool& survives,
                                           bool& need) {
  alive = static_cast<const bool*>(P.in[IN_ALIVE])[i];
  const bool missed = static_cast<const int*>(P.in[IN_TRI])[i] < 0;
  miss = alive && missed;
  on = alive && !missed;
  survives = false;
  need = false;
  const V3 o = ld3(P.in[IN_O], i);
  const V3 d = ld3(P.in[IN_D], i);
  const V3 beta = ld3(P.in[IN_BETA], i);
  const V3 rad = ld3(P.in[IN_RADIANCE], i);

  // the miss record: direction, throughput (and bsdf pdf) at the miss
  st3(P.out[OUT_MISS_DIR], i, miss ? d : ld3(P.in[IN_MISS_DIR], i));
  st3(P.out[OUT_MISS_BETA], i, miss ? beta : ld3(P.in[IN_MISS_BETA], i));
  if (ENV) {
    static_cast<float*>(P.out[OUT_MISS_PDF])[i] =
        miss ? ldf(P.in[IN_PREV_PDF], i) : ldf(P.in[IN_MISS_PDF], i);
  }

  if (!on) {
    // the carry copied through; radiance + 0 (a -0 turns +0, as the
    // plain version's masked sum does)
    st3(P.out[OUT_O], i, o);
    st3(P.out[OUT_D], i, d);
    st3(P.out[OUT_BETA], i, beta);
    st3(P.out[OUT_RADIANCE], i,
        v3(rad.x + 0.0f, rad.y + 0.0f, rad.z + 0.0f));
    static_cast<bool*>(P.out[OUT_ALIVE])[i] = false;
    if (NEE) {
      st3(P.out[OUT_SHADOW_O], i, o);
      st3(P.out[OUT_LDIR], i, d);
      static_cast<float*>(P.out[OUT_T_QUERY])[i] = 0.0f;
      st3(P.out[OUT_FACTOR], i, v3(0.0f, 0.0f, 0.0f));
    }
    if (ENV) {
      static_cast<float*>(P.out[OUT_PREV_PDF])[i] = 0.0f;
      st3(P.out[OUT_P], i, o);
      st3(P.out[OUT_N], i, d);
      st3(P.out[OUT_DIFFUSE_BETA], i, v3(0.0f, 0.0f, 0.0f));
    }
    return;
  }

  // the surface's fields
  const V3 ns = ld3(P.in[IN_NS], i);
  const V3 albedo = ld_row3(P.in[IN_ALBEDO], P.ints[I_S_ALBEDO], i);
  const float alpha = ld_row1(P.in[IN_ALPHA], P.ints[I_S_ALPHA], i);
  const float rough = ld_row1(P.in[IN_ROUGHNESS], P.ints[I_S_ROUGHNESS], i);
  const float metal = ld_row1(P.in[IN_METALLIC], P.ints[I_S_METALLIC], i);
  const V3 emissive = ld_row3(P.in[IN_EMISSIVE], P.ints[I_S_EMISSIVE], i);
  const V3 trans =
      ld_row3(P.in[IN_TRANSMISSION], P.ints[I_S_TRANSMISSION], i);
  const float ior = ld_row1(P.in[IN_IOR], P.ints[I_S_IOR], i);
  const size_t ur = static_cast<size_t>(P.ints[I_S_U]) * i;
  const void* U = P.in[IN_U];

  // the hit point, the face-forwarded normal, the emissive pickup
  const float t = ldf(P.in[IN_T], i);
  const V3 p = v3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
  const float nd = dot3(ns, d);
  const V3 n = nd < 0.0f ? ns : v3(-ns.x, -ns.y, -ns.z);
  st3(P.out[OUT_RADIANCE], i,
      v3(rad.x + beta.x * emissive.x, rad.y + beta.y * emissive.y,
         rad.z + beta.z * emissive.z));

  // the specular colour model
  const float dn = dot3(d, n);
  const float cosmag = clamp_range(
      pow_torch(clamp_min(fabsf(dn), C_COS_MIN), P.ints[I_POW],
                P.floats[FL_POW_EXP]),
      0.0f, 1.0f);
  const float diel = 1.0f + (C_DIELECTRIC - 1.0f) * cosmag;
  const float msq = __fsqrt_rn(clamp_range(metal, 0.0f, 1.0f));
  const V3 sc = mix3(v3(diel, diel, diel), albedo, msq);
  const float spca = clamp_range(length3(sc), 0.0f, 1.0f);

  // the branch coins
  const bool pass = ldf(U, ur + S_ALPHA) < 1.0f - alpha;
  const bool spec = !pass && (ldf(U, ur + S_SPEC) < spca);
  const bool diff = !pass && !spec;

  // the cosine continuation (sampling.cosine_hemisphere)
  const float u1 = ldf(U, ur + S_COS1);
  const float up = __fsqrt_rn(u1);
  const float over = __fsqrt_rn(clamp_min(1.0f - u1, 0.0f));
  const float around = (ldf(U, ur + S_COS2) * 2.0f) * C_PI;
  const bool ax = fabsf(n.x) < C_SQRT_THIRD;
  const bool ay = fabsf(n.y) < C_SQRT_THIRD;
  const V3 perp0 = ax ? v3(1.0f, 0.0f, 0.0f)
                      : (ay ? v3(0.0f, 1.0f, 0.0f) : v3(0.0f, 0.0f, 1.0f));
  const V3 tt = normalize3(cross3(n, perp0));
  const V3 bb = cross3(n, tt);
  const float ca = cosf(around), sa = sinf(around);
  const V3 cos_dir = normalize3(
      v3(n.x * up + tt.x * ca * over + bb.x * sa * over,
         n.y * up + tt.y * ca * over + bb.y * sa * over,
         n.z * up + tt.z * ca * over + bb.z * sa * over));

  // the glossy continuation
  const float gloss = clamp_range(rough * ldf(U, ur + S_GLOSS), 0.0f, 1.0f);
  const V3 refl = reflect3(d, n, dn);
  const V3 spec_dir = normalize3(mix3(refl, cos_dir, gloss));

  // pass-through refracts (eta from entering / exiting); total internal
  // reflection falls back to the mirror direction
  const float eta = nd < 0.0f ? __fdiv_rn(1.0f, ior) : ior;
  const float k = 1.0f - eta * eta * (1.0f - dn * dn);
  const float kq = eta * dn + __fsqrt_rn(k > 0.0f ? k : 1.0f);
  V3 refr = v3(eta * d.x - kq * n.x, eta * d.y - kq * n.y,
               eta * d.z - kq * n.z);
  if (k <= 0.0f) refr = v3(0.0f, 0.0f, 0.0f);
  const bool tir = dot3(refr, refr) < C_TIR;
  const V3 pass_dir = tir ? refl : normalize3(refr);
  const bool tinted = trans.x > 0.0f || trans.y > 0.0f || trans.z > 0.0f;

  const V3 new_d = pass ? pass_dir : (spec ? spec_dir : cos_dir);
  V3 branch;
  if (pass) {
    branch = tinted ? trans : v3(1.0f, 1.0f, 1.0f);
  } else if (spec) {
    const float s = clamp_min(spca, C_COS_MIN);
    branch = v3(clamp_range(__fdiv_rn(sc.x, s), 0.0f, 1.0f),
                clamp_range(__fdiv_rn(sc.y, s), 0.0f, 1.0f),
                clamp_range(__fdiv_rn(sc.z, s), 0.0f, 1.0f));
  } else {
    branch = albedo;
  }
  V3 new_beta = v3(beta.x * branch.x, beta.y * branch.y, beta.z * branch.z);
  const V3 db = diff ? v3(beta.x * albedo.x, beta.y * albedo.y,
                          beta.z * albedo.z)
                     : v3(0.0f, 0.0f, 0.0f);

  if (NEE) {
    // one uniformly chosen sphere light: a point inside it, the
    // reference's weight heuristic, the raw shading normal's gate
    const int n_lights = P.ints[I_LIGHTS];
    const int li = min(max(__float2int_rz(ldf(U, ur + S_RESERVED) *
                                          static_cast<float>(n_lights)),
                           0),
                       n_lights - 1);
    const V3 center = ld3(P.in[IN_L_CENTER], li);
    const float radius = ldf(P.in[IN_L_RADIUS], li);
    const V3 color = ld3(P.in[IN_L_COLOR], li);
    const float nl = static_cast<float>(n_lights);
    const V3 lcolor = v3(color.x * nl, color.y * nl, color.z * nl);
    // sampling.uniform_sphere
    const float up2 = ldf(U, ur + S_LIGHT1) * 2.0f - 1.0f;
    const float over2 = __fsqrt_rn(clamp_min(1.0f - up2 * up2, 0.0f));
    const float around2 = (ldf(U, ur + S_LIGHT2) * 2.0f) * C_PI;
    const V3 sph = v3(up2, cosf(around2) * over2, sinf(around2) * over2);
    const V3 ldir = normalize3(v3(center.x + radius * sph.x - p.x,
                                  center.y + radius * sph.y - p.y,
                                  center.z + radius * sph.z - p.z));
    const float dist = length3(v3(center.x - p.x, center.y - p.y,
                                  center.z - p.z));
    // sampling.light_sampling_weight
    const float q = __fdiv_rn(radius, clamp_min(dist, C_COS_MIN));
    const float c = clamp_range(dot3(ldir, n) * 2.0f * (q * q), 0.0f, 1.0f);
    const float weight =
        1.0f - __fsqrt_rn(clamp_min(1.0f - c, C_TIR));
    const V3 so = v3(p.x + ldir.x * C_GAP, p.y + ldir.y * C_GAP,
                     p.z + ldir.z * C_GAP);
    // intersect.intersect_sphere(so, ldir, center, radius + GAP)
    const float rg = radius + C_GAP;
    const V3 to = v3(so.x - center.x, so.y - center.y, so.z - center.z);
    const float b = 2.0f * dot3(to, ldir);
    const float cc = dot3(to, to) - rg * rg;
    const float disc = b * b - 4.0f * cc;
    const float sq = __fsqrt_rn(disc > 0.0f ? disc : 1.0f);
    const float t1 = 0.5f * (-b - sq);
    const float t2 = 0.5f * (-b + sq);
    const float mn = min_nan(t1, t2), mx = max_nan(t1, t2);
    float t_light = mx >= 0.0f ? (mn >= 0.0f ? mn : mx) : INF_DIST;
    if (!(disc > 0.0f)) t_light = INF_DIST;
    need = dot3(ns, ldir) >= 0.0f && weight > 0.0f &&
           (db.x > 0.0f || db.y > 0.0f || db.z > 0.0f);
    st3(P.out[OUT_SHADOW_O], i, so);
    st3(P.out[OUT_LDIR], i, ldir);
    static_cast<float*>(P.out[OUT_T_QUERY])[i] = need ? t_light : 0.0f;
    st3(P.out[OUT_FACTOR], i,
        (need && t_light < INF_DIST)
            ? v3(db.x * weight * lcolor.x, db.y * weight * lcolor.y,
                 db.z * weight * lcolor.z)
            : v3(0.0f, 0.0f, 0.0f));
  }
  if (ENV) {
    // the continuation's bsdf pdf: cosine for diffuse lanes, 0 (a delta)
    // for specular and pass-through ones; the division by pi is torch's
    // multiplication by the float reciprocal
    static_cast<float*>(P.out[OUT_PREV_PDF])[i] =
        diff ? clamp_min(dot3(new_d, n), 0.0f) * __fdiv_rn(1.0f, C_PI)
             : 0.0f;
    st3(P.out[OUT_P], i, p);
    st3(P.out[OUT_N], i, n);
    st3(P.out[OUT_DIFFUSE_BETA], i, db);
  }

  survives = length3(new_beta) > P.floats[FL_MIN_THROUGHPUT];
  if (RR) {
    // survive with probability q = clamp(max channel, rr_min_q, 1),
    // survivors reweighted by 1/q
    const float q = clamp_range(max_nan(max_nan(new_beta.x, new_beta.y),
                                    new_beta.z),
                            P.floats[FL_RR_MIN_Q], 1.0f);
    const bool lives = ldf(U, ur + S_RR) < q;
    survives = survives && lives;
    if (lives) {
      new_beta = v3(__fdiv_rn(new_beta.x, q), __fdiv_rn(new_beta.y, q),
                    __fdiv_rn(new_beta.z, q));
    }
  }
  st3(P.out[OUT_O], i, v3(p.x + new_d.x * C_GAP, p.y + new_d.y * C_GAP,
                          p.z + new_d.z * C_GAP));
  st3(P.out[OUT_D], i, new_d);
  st3(P.out[OUT_BETA], i, new_beta);
  static_cast<bool*>(P.out[OUT_ALIVE])[i] = survives;
}

}  // namespace

template <bool NEE, bool ENV, bool RR>
__global__ void __launch_bounds__(SHADE_THREADS) shade_kernel(
    const ShadeParams P) {
  const int i = blockIdx.x * SHADE_THREADS + threadIdx.x;
  bool alive = false, on = false, miss = false, survives = false,
       need = false;
  if (i < P.ints[I_RAYS]) shade_lane<NEE, ENV, RR>(P, i, alive, on, miss,
                                                   survives, need);
  // the bounce's lane counts: a block's, then one atomic each
  const int c[5] = {__syncthreads_count(alive), __syncthreads_count(on),
                    __syncthreads_count(miss), __syncthreads_count(survives),
                    __syncthreads_count(need)};
  if (threadIdx.x < 5 && c[threadIdx.x]) {
    atomicAdd(static_cast<int*>(P.out[OUT_COUNTS]) + threadIdx.x,
              c[threadIdx.x]);
  }
}

__global__ void __launch_bounds__(RESOLVE_THREADS) nee_resolve_kernel(
    const float* __restrict__ radiance, const float* __restrict__ factor,
    const bool* __restrict__ occ, float* __restrict__ out, int n_floats) {
  const int e = blockIdx.x * RESOLVE_THREADS + threadIdx.x;
  if (e >= n_floats) return;
  // radiance + where(occ, 0, factor): the occluded lane adds +0 unread
  out[e] = radiance[e] + (occ[e / 3] ? 0.0f : factor[e]);
}

}  // namespace prismarine

namespace {

template <bool NEE, bool ENV>
void launch_rr(const prismarine::ShadeParams& P, bool rr, dim3 grid,
               cudaStream_t s) {
  using namespace prismarine;
  if (rr) {
    shade_kernel<NEE, ENV, true><<<grid, SHADE_THREADS, 0, s>>>(P);
  } else {
    shade_kernel<NEE, ENV, false><<<grid, SHADE_THREADS, 0, s>>>(P);
  }
}

}  // namespace

// Launch shade_kernel on ``stream``; returns the first CUDA error.
// ``in``: the input pointers in ops/shade.py's INPUTS order; ``out``: the
// output pointers in its OUTPUTS order (null where the flags write
// nothing); ``ints``: rays, lights, flags, the pow route, the row strides
// of albedo, alpha, roughness, metallic, emissive, transmission, ior and
// the uniforms;
// ``floats``: the pow exponent, min_throughput, rr_min_q.  The counts
// i32[5] are zeroed on the stream first.
extern "C" int shade_launch(const void* const* in, void* const* out,
                            const int* ints, const float* floats,
                            void* stream) {
  using namespace prismarine;
  ShadeParams P;
  for (int k = 0; k < N_IN; ++k) P.in[k] = in[k];
  for (int k = 0; k < N_OUT; ++k) P.out[k] = out[k];
  for (int k = 0; k < N_INT; ++k) P.ints[k] = ints[k];
  for (int k = 0; k < N_FLOAT; ++k) P.floats[k] = floats[k];
  const int n = P.ints[I_RAYS];
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(P.out[OUT_COUNTS], 0, 5 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + SHADE_THREADS - 1) / SHADE_THREADS);
  const int f = P.ints[I_FLAGS];
  const bool nee = f & F_NEE, env = f & F_ENV, rr = f & F_RR;
  if (nee && env) {
    launch_rr<true, true>(P, rr, grid, s);
  } else if (nee) {
    launch_rr<true, false>(P, rr, grid, s);
  } else if (env) {
    launch_rr<false, true>(P, rr, grid, s);
  } else {
    launch_rr<false, false>(P, rr, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch nee_resolve_kernel on ``stream``: out f32[R,3] = radiance +
// (occ ? 0 : factor); returns cudaGetLastError().
extern "C" int nee_resolve_launch(const void* radiance, const void* factor,
                                  const void* occ, void* out, int n_rays,
                                  void* stream) {
  using namespace prismarine;
  if (n_rays <= 0) return 0;
  const int n = 3 * n_rays;
  const dim3 grid((n + RESOLVE_THREADS - 1) / RESOLVE_THREADS);
  nee_resolve_kernel<<<grid, RESOLVE_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(radiance), static_cast<const float*>(factor),
      static_cast<const bool*>(occ), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
