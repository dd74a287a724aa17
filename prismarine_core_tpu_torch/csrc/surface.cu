// The surface at each ray's hit, in one pass: the hit triangle's vertices,
// shading normals and material row, the interpolated shading normal (the
// geometric one where it is not finite), the geometric normal, the uv
// and, where a bump map is bound, the tangent.
//
// The port's own kernel: the JAX package interpolates the surface in XLA
// (prismarine_core_tpu/render/integrator.py:_interpolate_surface), which
// fuses the gathers and the arithmetic, with no Pallas body.  Written as
// torch code the same step is 7 gathers from the triangle soup, 9 from the
// material table and about 45 elementwise launches a bounce, each a pass
// over every lane.  The plain version is that torch code
// (ops/surface.py:surface_fields_plain), and this kernel computes the same
// fields bit for bit: every float operation below is the plain version's,
// in its order, with the build's -fmad=false and IEEE division and square
// root (__fdiv_rn, __fsqrt_rn); torch.clamp(min=) keeps a NaN, and the
// 1e-30 and 1e-12 constants are the plain version's doubles rounded to
// float, as torch rounds them.
//
// What bounds it on the H100: bytes.  Per lane it has to read the hit
// (tri, u, v: 12 B) and write the fields shading reads (84 B); the soup's
// records (96 B a triangle: ~13 MB on the hall) and the material table
// stay in the 50 MB L2.  The design:
//  - one lane a ray, the hit read coalesced, tri clamped to 0 on a miss
//    (the plain version's clamp: a missed lane's fields are row 0's);
//  - packed soup records (ops/surface.py:pack_soup): float4(v0.xyz,
//    mat_id), float4(v1.xyz, 0), float4(v2.xyz, 0), float4(n0.xyz, 0),
//    float4(n1.xyz, 0), float4(n2.xyz, 0), the id as float bits: six
//    16-byte loads a lane where the soup's 12-byte rows take scalar loads;
//    the texcoords in records of their own (pack_uvs: float4(t0, t1),
//    float4(t2, 0, 0)), read only on a textured scene;
//  - packed material records (pack_materials): float4 diffuse, specular,
//    emissive, transmission, then float4(ior, tex_diffuse, tex_specular,
//    tex_emissive) and float4(tex_bump, 0, 0, 0), read through the
//    read-only cache: the table has a handful of rows;
//  - the material's 16-byte rows written whole as float4, so the caller's
//    albedo, alpha, roughness, metallic, emissive and transmission are
//    the same column views of them as the plain version's gathered rows.
#include "common.cuh"

namespace prismarine {
namespace {

constexpr int SURFACE_THREADS = 256;
constexpr int SOUP_F4 = 6;            // float4s of a soup record
constexpr int UV_F4 = 2;              // float4s of a texcoord record
constexpr int MAT_F4 = 6;             // float4s of a material record
// pm.length's clamp and pm.safe_rcp's eps: Python floats rounded to float
#define LENGTH_MIN static_cast<float>(1e-30)
#define RCP_EPS static_cast<float>(1e-12)

// pm.normalize: v / sqrt(clamp((x*x + y*y) + z*z, min=1e-30))
__device__ __forceinline__ float3 normalize3(float x, float y, float z) {
  float dd = (x * x + y * y) + z * z;
  dd = isnan(dd) ? dd : fmaxf(dd, LENGTH_MIN);
  const float len = __fsqrt_rn(dd);
  return make_float3(__fdiv_rn(x, len), __fdiv_rn(y, len),
                     __fdiv_rn(z, len));
}

__device__ __forceinline__ void store3(float* out, int i, float3 v) {
  out[3 * i] = v.x;
  out[3 * i + 1] = v.y;
  out[3 * i + 2] = v.z;
}

}  // namespace

__global__ void __launch_bounds__(SURFACE_THREADS) surface_fields_kernel(
    const float4* __restrict__ soup, const float4* __restrict__ uvs,
    const float4* __restrict__ mats, const int* __restrict__ hit_tri,
    const float* __restrict__ hit_u, const float* __restrict__ hit_v,
    float* __restrict__ out_ns, float* __restrict__ out_ng,
    float2* __restrict__ out_uv, float* __restrict__ out_tang,
    float4* __restrict__ out_diffuse, float4* __restrict__ out_specular,
    float4* __restrict__ out_emissive, float4* __restrict__ out_transmission,
    float* __restrict__ out_ior, int* __restrict__ out_tex, int n_rays,
    int textured, int bump) {
  const int i = blockIdx.x * SURFACE_THREADS + threadIdx.x;
  if (i >= n_rays) return;
  const int tri = max(hit_tri[i], 0);
  const float u = hit_u[i];
  const float v = hit_v[i];
  const float w = (1.0f - u) - v;

  const float4* rec = soup + static_cast<size_t>(tri) * SOUP_F4;
  const float4 v0 = __ldg(rec);
  const float4 v1 = __ldg(rec + 1);
  const float4 v2 = __ldg(rec + 2);
  const float4 n0 = __ldg(rec + 3);
  const float4 n1 = __ldg(rec + 4);
  const float4 n2 = __ldg(rec + 5);

  // the shading normal: (w*n0 + u*n1) + v*n2, normalized
  const float3 ns = normalize3((w * n0.x + u * n1.x) + v * n2.x,
                               (w * n0.y + u * n1.y) + v * n2.y,
                               (w * n0.z + u * n1.z) + v * n2.z);
  // the geometric normal: cross(v1 - v0, v2 - v0), normalized
  const float e1x = v1.x - v0.x, e1y = v1.y - v0.y, e1z = v1.z - v0.z;
  const float e2x = v2.x - v0.x, e2y = v2.y - v0.y, e2z = v2.z - v0.z;
  const float3 ng = normalize3(e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                               e1x * e2y - e1y * e2x);
  const bool finite = isfinite(ns.x) && isfinite(ns.y) && isfinite(ns.z);
  store3(out_ns, i, finite ? ns : ng);
  store3(out_ng, i, ng);

  float2 uv = make_float2(0.0f, 0.0f);
  if (textured) {
    const float4 c01 = __ldg(uvs + static_cast<size_t>(tri) * UV_F4);
    const float4 c2 = __ldg(uvs + static_cast<size_t>(tri) * UV_F4 + 1);
    uv = make_float2((w * c01.x + u * c01.z) + v * c2.x,
                     (w * c01.y + u * c01.w) + v * c2.y);
    if (bump) {
      // the tangent from the uv derivatives (pm.safe_rcp of their det)
      const float d1x = c01.z - c01.x, d1y = c01.w - c01.y;
      const float d2x = c2.x - c01.x, d2y = c2.y - c01.y;
      const float det = d1x * d2y - d1y * d2x;
      const float g = fabsf(det) < RCP_EPS ? (det < 0.0f ? -RCP_EPS : RCP_EPS)
                                           : det;
      const float rdet = __fdiv_rn(1.0f, g);
      store3(out_tang, i, normalize3((e1x * d2y - e2x * d1y) * rdet,
                                     (e1y * d2y - e2y * d1y) * rdet,
                                     (e1z * d2y - e2z * d1y) * rdet));
    }
  }
  out_uv[i] = uv;

  const float4* m = mats + static_cast<size_t>(__float_as_int(v0.w)) * MAT_F4;
  out_diffuse[i] = __ldg(m);
  out_specular[i] = __ldg(m + 1);
  out_emissive[i] = __ldg(m + 2);
  out_transmission[i] = __ldg(m + 3);
  const float4 q = __ldg(m + 4);
  out_ior[i] = q.x;
  out_tex[i] = __float_as_int(q.y);
  out_tex[n_rays + i] = __float_as_int(q.z);
  out_tex[2 * n_rays + i] = __float_as_int(q.w);
  out_tex[3 * n_rays + i] = __float_as_int(__ldg(m + 5).x);
}

}  // namespace prismarine

// Launch on ``stream``; returns cudaGetLastError().  Pointers: the packed
// soup, texcoord and material records, the hit (tri i32[R], u, v f32[R]),
// then the outputs ns, ng f32[R,3], uv f32[R,2], tang f32[R,3] (written
// only with ``bump``), diffuse, specular, emissive, transmission f32[R,4],
// ior f32[R] and the texture ids i32[4,R].  ``textured``: interpolate the
// uv (zeros otherwise); ``bump``: also the tangent (needs ``textured``).
extern "C" int surface_fields_launch(
    const void* soup, const void* uvs, const void* mats, const void* tri,
    const void* u, const void* v, void* ns, void* ng, void* uv, void* tang,
    void* diffuse, void* specular, void* emissive, void* transmission,
    void* ior, void* tex, int n_rays, int textured, int bump, void* stream) {
  using namespace prismarine;
  if (n_rays <= 0) return 0;
  const dim3 grid((n_rays + SURFACE_THREADS - 1) / SURFACE_THREADS);
  surface_fields_kernel<<<grid, SURFACE_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(soup), static_cast<const float4*>(uvs),
      static_cast<const float4*>(mats), static_cast<const int*>(tri),
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<float*>(ns), static_cast<float*>(ng),
      static_cast<float2*>(uv), static_cast<float*>(tang),
      static_cast<float4*>(diffuse), static_cast<float4*>(specular),
      static_cast<float4*>(emissive), static_cast<float4*>(transmission),
      static_cast<float*>(ior), static_cast<int*>(tex), n_rays, textured,
      bump);
  return static_cast<int>(cudaGetLastError());
}
