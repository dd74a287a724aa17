// The texture maps at each ray's hit, in one pass: for each kind a
// material may bind (diffuse, specular, emissive, bump), the bilinear
// fetch of the hit material's map at the hit's uv and its use there: the
// diffuse map scales the albedo (alpha included), the specular map's G and
// B the roughness and the metallic, the emissive map the emission, and the
// bump map's tangent-space normal replaces the shading normal.
//
// The port's own kernel: it replaces no Pallas kernel, since the JAX
// package fetches in XLA (prismarine_core_tpu/models/textures.py:
// sample_bilinear, called from render/integrator.py:_interpolate_surface),
// which fuses the fetch's arithmetic around its gathers.  Written as torch
// code the same step is ~50 launches a bound kind and bounce, each a pass
// over every lane.  The plain version is that torch code
// (ops/texture.py:texture_plain, on models/textures.py:sample_bilinear),
// and this kernel computes the same fields bit for bit, missed lanes
// included: every float operation below is the plain version's, in its
// order, with the build's -fmad=false and IEEE division and square root;
// torch.remainder is fmod plus the divisor where the signs differ, the
// float-to-int conversion truncates (both as torch's CUDA kernels do), and
// the 1e-30 of pm.normalize is the Python double rounded to float.
//
// What bounds it on the H100: bytes, and the latency of dependent
// gathers.  Per lane it has to read the uv, the shading normal, the
// tangent, the material's four texture ids and the fields the maps
// modulate (~100 B), four texels of 16 B for each bound kind, and write the
// modulated fields (~40 B): ~300 B a lane with three kinds bound.  The
// design:
//  - one lane a ray, every input read once for all kinds, coalesced;
//  - each fetch reads its four texels as four float4 loads from one
//    64-byte row of the stack's corner-packed quads
//    (models/textures.py:TextureStack.quad, packed once by
//    ops/texture.py:_quads_of for a stack without them): one aligned
//    transaction and one address a fetch, against two rows of the dense
//    [N, H, W, 4] texels and the wrap of x0 + 1 and y0 + 1.  Measured at
//    the 720p bounce-1 hits of the textured benchmark cell, the quads took
//    0.349 ms and the dense texels 0.440 (bounce 2: 0.305 against 0.414),
//    though the quads are four times the footprint (1.21 GB against 0.30)
//    against a 50 MB L2: each fetch's latency, not the footprint, sets the
//    pace;
//  - a lane whose material binds no map of a kind skips that fetch (its
//    field passes through), and a kind no material binds is compiled in but
//    never entered (a flag from the host's kinds_bound; no extra sync);
//  - the four texel loads of a fetch are independent, issued together.
#include "common.cuh"

namespace prismarine {

// the texture stack as the kernel reads it
struct TextureStack {
  const float4* quad;   // f32[n, h, w, 16]: texels (y, x), (y, x+1),
                        // (y+1, x), (y+1, x+1), wrapped at the native size
  const int2* sizes;    // i32[n, 2] native (w, h), or null: every texture
                        // fills the stack
  int n, h, w;
};

namespace {

constexpr int TEXTURE_THREADS = 256;
// kinds_bound's order as bits of the launch's ``kinds``
constexpr int K_DIFFUSE = 1, K_SPECULAR = 2, K_EMISSIVE = 4, K_BUMP = 8;
// pm.length's clamp: a Python float rounded to float
#define LENGTH_MIN static_cast<float>(1e-30)

// torch.remainder(a, 1.0) of a float: fmod, plus the divisor where the
// remainder is nonzero and its sign differs from the divisor's
__device__ __forceinline__ float wrap_unit(float a) {
  float m = fmodf(a, 1.0f);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}

// torch.remainder of int32 by a positive int32
__device__ __forceinline__ int wrap_int(int a, int b) {
  int r = a % b;
  if (r != 0 && (r < 0) != (b < 0)) r += b;
  return r;
}

__device__ __forceinline__ float4 blend(float4 c00, float4 c10, float4 c01,
                                        float4 c11, float fx, float fy) {
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  return make_float4(
      (c00.x * gx + c10.x * fx) * gy + (c01.x * gx + c11.x * fx) * fy,
      (c00.y * gx + c10.y * fx) * gy + (c01.y * gx + c11.y * fx) * fy,
      (c00.z * gx + c10.z * fx) * gy + (c01.z * gx + c11.z * fx) * fy,
      (c00.w * gx + c10.w * fx) * gy + (c01.w * gx + c11.w * fx) * fy);
}

// models/textures.py:sample_bilinear at one lane with id >= 0: the texture
// clamped into the stack, wrap addressing at its native size
__device__ __forceinline__ float4 bilinear(const TextureStack& s, int id,
                                           float u0, float v0) {
  const int tid = min(id, s.n - 1);
  int wi = s.w, hi = s.h;
  if (s.sizes != nullptr) {
    const int2 wh = __ldg(s.sizes + tid);
    wi = wh.x;
    hi = wh.y;
  }
  const float x = wrap_unit(u0) * static_cast<float>(wi) - 0.5f;
  const float y = wrap_unit(v0) * static_cast<float>(hi) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const int x0i = wrap_int(static_cast<int>(x0), wi);
  const int y0i = wrap_int(static_cast<int>(y0), hi);
  const float4* q =
      s.quad + ((static_cast<size_t>(tid) * s.h + y0i) * s.w + x0i) * 4;
  const float4 c00 = __ldg(q), c10 = __ldg(q + 1);
  const float4 c01 = __ldg(q + 2), c11 = __ldg(q + 3);
  return blend(c00, c10, c01, c11, x - x0, y - y0);
}

// pm.normalize: v / sqrt(clamp((x*x + y*y) + z*z, min=1e-30))
__device__ __forceinline__ float3 normalize3(float x, float y, float z) {
  float dd = (x * x + y * y) + z * z;
  dd = isnan(dd) ? dd : fmaxf(dd, LENGTH_MIN);
  const float len = __fsqrt_rn(dd);
  return make_float3(__fdiv_rn(x, len), __fdiv_rn(y, len),
                     __fdiv_rn(z, len));
}

__device__ __forceinline__ float3 load3(const float* p, int i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

__device__ __forceinline__ void store3(float* p, int i, float3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

}  // namespace

__global__ void __launch_bounds__(TEXTURE_THREADS) texture_fields_kernel(
    TextureStack stack, const float2* __restrict__ uvs,
    const float* __restrict__ ns, const float* __restrict__ tang,
    const float4* __restrict__ diffuse, const float4* __restrict__ specular,
    const float4* __restrict__ emissive,
    const int* __restrict__ tex_diffuse, const int* __restrict__ tex_specular,
    const int* __restrict__ tex_emissive, const int* __restrict__ tex_bump,
    float* __restrict__ out_ns, float4* __restrict__ out_albedo,
    float* __restrict__ out_emissive, float* __restrict__ out_rough,
    float* __restrict__ out_metal, int n_rays, int kinds) {
  const int i = blockIdx.x * TEXTURE_THREADS + threadIdx.x;
  if (i >= n_rays) return;
  const float2 uv = uvs[i];

  if (kinds & K_BUMP) {
    // tangent-space normal mapping: tang*nt.x + cross(ns, tang)*nt.y +
    // ns*nt.z, normalized, with nt = 2*tex - 1
    const float3 n = load3(ns, i);
    const int id = tex_bump[i];
    float3 out = n;
    if (id >= 0) {
      const float3 t = load3(tang, i);
      const float4 c = bilinear(stack, id, uv.x, uv.y);
      const float ntx = c.x * 2.0f - 1.0f, nty = c.y * 2.0f - 1.0f,
                  ntz = c.z * 2.0f - 1.0f;
      const float bx = n.y * t.z - n.z * t.y, by = n.z * t.x - n.x * t.z,
                  bz = n.x * t.y - n.y * t.x;
      out = normalize3((t.x * ntx + bx * nty) + n.x * ntz,
                       (t.y * ntx + by * nty) + n.y * ntz,
                       (t.z * ntx + bz * nty) + n.z * ntz);
    }
    store3(out_ns, i, out);
  }
  if (kinds & K_DIFFUSE) {
    float4 a = diffuse[i];
    const int id = tex_diffuse[i];
    if (id >= 0) {
      const float4 c = bilinear(stack, id, uv.x, uv.y);
      a = make_float4(a.x * c.x, a.y * c.y, a.z * c.z, a.w * c.w);
    }
    out_albedo[i] = a;
  }
  if (kinds & K_EMISSIVE) {
    const float4 e = emissive[i];
    float3 out = make_float3(e.x, e.y, e.z);
    const int id = tex_emissive[i];
    if (id >= 0) {
      const float4 c = bilinear(stack, id, uv.x, uv.y);
      out = make_float3(e.x * c.x, e.y * c.y, e.z * c.z);
    }
    store3(out_emissive, i, out);
  }
  if (kinds & K_SPECULAR) {
    const float4 sp = specular[i];
    float rough = sp.y, metal = sp.z;
    const int id = tex_specular[i];
    if (id >= 0) {
      const float4 c = bilinear(stack, id, uv.x, uv.y);
      rough = rough * c.y;
      metal = metal * c.z;
    }
    out_rough[i] = rough;
    out_metal[i] = metal;
  }
}

}  // namespace prismarine

// Launch on ``stream``; returns cudaGetLastError().  Pointers: the
// stack's corner quads f32[n_tex, h, w, 16] and its size table
// i32[n_tex, 2] (or null), the uv f32[R, 2], the shading normal and the
// tangent f32[R, 3], the material's diffuse, specular and emissive rows
// f32[R, 4], its texture ids i32[R] (diffuse, specular, emissive, bump),
// then the outputs: the shading normal f32[R, 3], the albedo f32[R, 4],
// the emission f32[R, 3], the roughness and the metallic f32[R].
// ``kinds``: bit 0 diffuse, 1 specular, 2 emissive, 3 bump; a kind's
// inputs are read and its outputs written only with its bit (the others
// may be null).
extern "C" int texture_fields_launch(
    const void* quad, const void* sizes, const void* uv, const void* ns,
    const void* tang, const void* diffuse, const void* specular,
    const void* emissive, const void* tex_diffuse, const void* tex_specular,
    const void* tex_emissive, const void* tex_bump, void* out_ns,
    void* out_albedo, void* out_emissive, void* out_rough, void* out_metal,
    int n_rays, int n_tex, int h, int w, int kinds, void* stream) {
  using namespace prismarine;
  if (n_rays <= 0) return 0;
  const TextureStack stack{static_cast<const float4*>(quad),
                    static_cast<const int2*>(sizes), n_tex, h, w};
  const dim3 grid((n_rays + TEXTURE_THREADS - 1) / TEXTURE_THREADS);
  texture_fields_kernel<<<grid, TEXTURE_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      stack, static_cast<const float2*>(uv), static_cast<const float*>(ns),
      static_cast<const float*>(tang), static_cast<const float4*>(diffuse),
      static_cast<const float4*>(specular),
      static_cast<const float4*>(emissive),
      static_cast<const int*>(tex_diffuse),
      static_cast<const int*>(tex_specular),
      static_cast<const int*>(tex_emissive),
      static_cast<const int*>(tex_bump), static_cast<float*>(out_ns),
      static_cast<float4*>(out_albedo), static_cast<float*>(out_emissive),
      static_cast<float*>(out_rough), static_cast<float*>(out_metal), n_rays,
      kinds);
  return static_cast<int>(cudaGetLastError());
}
