// Fused (ray tile x superblock) Moller-Trumbore pair intersector, forms
// "mt" and "mt2" (wrappers: ops/sb_intersect.py sb_intersect and
// sb_intersect_mt2).
//
// Replaces prismarine_core_tpu/ops/pallas_intersect.py:_sb_kernel (form
// "mt") and _sb_kernel_mt2 (form "mt2"), driven by
// pallas_sb_intersect_windowed: for each pair and each set bit k of its
// 8-bit mask, a 128-ray x 128-triangle Moller-Trumbore of the pair's tile
// against sub-block k.  Each ray keeps its closest (t, slot),
// slot = sb*1024 + k*128 + lane, starting from the prior result or from
// (t_cap, -1); only t strictly below the running best replaces it, so a
// hit at exactly t_cap is rejected.  Tie rule: among equal t the earliest
// (pair, k, lane) in list order wins.
//
// What bounds it on the H100: the fp32 issue rate.  Every live sub-block
// is 16K ray-triangle tests of 46 fp32 operations, each its own
// instruction under -fmad=false, plus the reciprocal, the predicate and
// the fold; the planes it reads (5 KB per sub-block) are tiny next to
// that.
//
// Form "mt" runs on the balanced walk of sb_walk.cuh (work units of live
// sub-blocks over a persistent grid, 64-bit keys folded with atomicMin,
// four rays per thread, triangle-major staging read as LDS.128, a
// warp-uniform skip of the test's second half); FormMT below is its
// staged layout and test body.
//
// Form "mt2" (one block per ray tile walking the tile's whole run of the
// tile-major list in order, one ray per thread): each group of two
// sub-blocks (k0, k0+1) runs in one region when either mask bit is set.
// Both Moller-Trumbore chains are computed in one loop body over 2 x 10
// staged plane rows (10 KB), so the compiler can interleave two
// independent dependency chains; the dead sub-block's result is dropped.
// Each chain keeps its own first-minimum (t, lane) over the region, and k0
// folds into the running best before k0+1: the sequential fold of the
// tie rule, so "mt2" equals "mt" bit for bit, ties included.  The math is
// the Pallas body's, operation for operation, and the library is built
// with -fmad=false, so both equal the plain version bit for bit.
#include "sb_walk.cuh"

namespace prismarine {

// Moller-Trumbore of one ray against one triangle: t, or INF_DIST on a
// miss (the Pallas body's operation order).  kSkip (the walk): when no
// lane of the warp passes |det| >= eps, 0 <= u <= 1 and valid,
// the rest is not computed.  Each of those failing implies the full
// predicate fails (u > 1 with v >= 0 gives u + v > 1, as rounding is
// monotone), so the result is INF_DIST either way.
template <bool kSkip>
__device__ __forceinline__ float mt_eval(float v0x, float v0y, float v0z,
                                         float e1x, float e1y, float e1z,
                                         float e2x, float e2y, float e2z,
                                         float valid, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz) {
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv = 1.0f / (fabsf(det) < DET_EPS ? DET_EPS : det);
  const float sx = ox - v0x;
  const float sy = oy - v0y;
  const float sz = oz - v0z;
  const float uu = (sx * px + sy * py + sz * pz) * inv;
  if (kSkip && !__any_sync(0xffffffffu, (fabsf(det) >= DET_EPS) &&
                                            (uu >= 0.0f) && (uu <= 1.0f) &&
                                            (valid > 0.5f)))
    return INF_DIST;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float vv = (dx * qx + dy * qy + dz * qz) * inv;
  const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
  const bool ok = (fabsf(det) >= DET_EPS) && (uu >= 0.0f) && (vv >= 0.0f) &&
                  (uu + vv <= 1.0f) && (tt > PZERO) && (valid > 0.5f);
  return ok ? tt : INF_DIST;
}

// The walk's form "mt": triangle j staged as 12 floats (plane rows 0..9,
// two pad), read as three LDS.128.
struct FormMT {
  static constexpr int W = 12;
  static constexpr int R = 4;                   // rays per thread
  struct Ray {
    float ox, oy, oz, dx, dy, dz;
    __device__ __forceinline__ void load(const float* r) {
      ox = r[RC_OX], oy = r[RC_OY], oz = r[RC_OZ];
      dx = r[RC_DX], dy = r[RC_DY], dz = r[RC_DZ];
    }
  };
  // thread t copies triangle t of sub-block k of superblock sb
  __device__ __forceinline__ static void stage(float* dst,
                                               const float* planes, int sb,
                                               int k, int t) {
    const float* src = planes + static_cast<size_t>(sb) * PLANE_ROWS * SB_LANES
                       + k * BLOCK + t;
#pragma unroll
    for (int c = 0; c < TC_USED; ++c) dst[c] = __ldg(src + c * SB_LANES);
  }
  __device__ __forceinline__ static float test(const float4* op,
                                               const Ray& r) {
    return mt_eval<true>(op[0].x, op[0].y, op[0].z, op[0].w, op[1].x,
                         op[1].y, op[1].z, op[1].w, op[2].x, op[2].y, r.ox,
                         r.oy, r.oz, r.dx, r.dy, r.dz);
  }
};

// Moller-Trumbore of one ray against staged sub-block row j of "mt2"
__device__ __forceinline__ float mt_test(const float (*tri)[BLOCK], int j,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz) {
  return mt_eval<false>(tri[TC_V0X][j], tri[TC_V0Y][j], tri[TC_V0Z][j],
                        tri[TC_E1X][j], tri[TC_E1Y][j], tri[TC_E1Z][j],
                        tri[TC_E2X][j], tri[TC_E2Y][j], tri[TC_E2Z][j],
                        tri[TC_VALID][j], ox, oy, oz, dx, dy, dz);
}

__global__ void __launch_bounds__(TILE)
sb_intersect_mt2_kernel(const int* __restrict__ tile_start,
                        const int* __restrict__ pair_sb,
                        const int* __restrict__ pair_mask,
                        const int* __restrict__ n_real,
                        const float* __restrict__ rays,
                        const float* __restrict__ planes,
                        const float* __restrict__ prior_t,
                        const int* __restrict__ prior_slot,
                        float* __restrict__ out_t, int* __restrict__ out_slot) {
  __shared__ float s_tri[2][TC_USED][BLOCK];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t row = static_cast<size_t>(tile) * TILE + lane;
  const float* r = rays + row * RAY_COLS;
  const float ox = r[RC_OX], oy = r[RC_OY], oz = r[RC_OZ];
  const float dx = r[RC_DX], dy = r[RC_DY], dz = r[RC_DZ];
  float best_t;
  int best_slot;
  if (prior_t != nullptr) {
    best_t = prior_t[row];
    best_slot = prior_slot[row];
  } else {
    best_t = r[RC_TCAP];
    best_slot = -1;
  }
  const int nr = *n_real;
  const int p_end = min(tile_start[tile + 1], nr);
  for (int p = min(tile_start[tile], nr); p < p_end; ++p) {
    const int mask = pair_mask[p];              // uniform over the block
    const int sb = pair_sb[p];
    const float* pl = planes + static_cast<size_t>(sb) * PLANE_ROWS * SB_LANES;
    for (int k0 = 0; k0 < SB; k0 += 2) {
      const int bits = (mask >> k0) & 3;
      if (bits == 0) continue;
      __syncthreads();                          // last region consumed
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < TC_USED; ++c)
          s_tri[h][c][lane] = pl[c * SB_LANES + (k0 + h) * BLOCK + lane];
      __syncthreads();
      const int slot_base = sb * SB_LANES + k0 * BLOCK;
      // per-chain first minimum over the region (+inf lies above every
      // tested t, so the first lane holding the minimum wins)
      float ta = __int_as_float(0x7f800000), tb = ta;
      int ja = 0, jb = 0;
      for (int j = 0; j < BLOCK; ++j) {
        const float t0 = mt_test(s_tri[0], j, ox, oy, oz, dx, dy, dz);
        const float t1 = mt_test(s_tri[1], j, ox, oy, oz, dx, dy, dz);
        if (t0 < ta) {
          ta = t0;
          ja = j;
        }
        if (t1 < tb) {
          tb = t1;
          jb = j;
        }
      }
      if ((bits & 1) && ta < best_t) {         // k0 folds first
        best_t = ta;
        best_slot = slot_base + ja;
      }
      if ((bits & 2) && tb < best_t) {
        best_t = tb;
        best_slot = slot_base + BLOCK + jb;
      }
    }
  }
  out_t[row] = best_t;
  out_slot[row] = best_slot;
}

}  // namespace prismarine

extern "C" int sb_intersect_launch(
    const void* tile_start, const void* pair_tile, const void* pair_sb,
    const void* pair_mask, const void* n_real, const void* rays,
    const void* planes, const void* prior_t, const void* prior_slot,
    void* keys, void* csum, void* unit_pair, void* out_t, void* out_slot,
    int n_rows, int n_pairs, int unit, void* stream) {
  return prismarine::walk_launch<prismarine::FormMT>(
      tile_start, pair_tile, pair_sb, pair_mask, n_real, rays, planes,
      prior_t, prior_slot, keys, csum, unit_pair, out_t, out_slot, n_rows,
      n_pairs, unit, stream);
}

extern "C" int sb_intersect_mt2_launch(const void* tile_start,
                                       const void* pair_sb,
                                       const void* pair_mask,
                                       const void* n_real, const void* rays,
                                       const void* planes, const void* prior_t,
                                       const void* prior_slot, void* out_t,
                                       void* out_slot, int n_tiles,
                                       void* stream) {
  using namespace prismarine;
  if (n_tiles > 0) {
    sb_intersect_mt2_kernel<<<n_tiles, TILE, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile_start), static_cast<const int*>(pair_sb),
        static_cast<const int*>(pair_mask), static_cast<const int*>(n_real),
        static_cast<const float*>(rays), static_cast<const float*>(planes),
        static_cast<const float*>(prior_t),
        static_cast<const int*>(prior_slot), static_cast<float*>(out_t),
        static_cast<int*>(out_slot));
  }
  return static_cast<int>(cudaGetLastError());
}
