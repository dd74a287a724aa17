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
// Both forms run on the balanced walk of sb_walk.cuh (work units of live
// sub-blocks over a persistent grid, 64-bit keys folded with atomicMin,
// triangle-major staging read as LDS.128, a warp-uniform skip of the
// test's second half).  FormMT below is the staged layout and test body,
// four rays per thread, one sub-block a stage.  FormMT2 keeps the TPU
// form's one idea, two independent Moller-Trumbore chains in one loop
// body: a stage holds two live sub-blocks of one ray tile (one at a tile
// boundary or a unit's end, with the second chain off), each thread tests
// two rays against triangle jj of both, and each chain folds and votes its
// skip on its own (the tie rule: sb_walk.cuh).  The TPU kernel ran each
// 2-bit group of the mask and dropped a dead sub-block's grids; the walk
// stages only live ones.  The math is the Pallas body's, operation for
// operation, and the library is built with -fmad=false, so both forms
// equal the plain version bit for bit.
#include "sb_walk.cuh"

namespace prismarine {

// Moller-Trumbore of one ray against one triangle: t, or INF_DIST on a
// miss (the Pallas body's operation order).  When no lane of the warp
// passes |det| >= eps, 0 <= u <= 1 and valid, the rest is not computed:
// each of those failing implies the full predicate fails (u > 1 with
// v >= 0 gives u + v > 1, as rounding is monotone), so the result is
// INF_DIST either way.
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
  if (!__any_sync(0xffffffffu, (fabsf(det) >= DET_EPS) && (uu >= 0.0f) &&
                                  (uu <= 1.0f) && (valid > 0.5f)))
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
  static constexpr int CHAINS = 1;              // sub-blocks per stage
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
    return mt_eval(op[0].x, op[0].y, op[0].z, op[0].w, op[1].x, op[1].y,
                   op[1].z, op[1].w, op[2].x, op[2].y, r.ox, r.oy, r.oz,
                   r.dx, r.dy, r.dz);
  }
};

// The walk's form "mt2": FormMT's layout and test, two chains a stage
// (both sub-blocks in one staging buffer, 24 KB for the two buffers)
struct FormMT2 : FormMT {
  static constexpr int R = 2;                   // rays per thread
  static constexpr int CHAINS = 2;
};

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

extern "C" int sb_intersect_mt2_launch(
    const void* tile_start, const void* pair_tile, const void* pair_sb,
    const void* pair_mask, const void* n_real, const void* rays,
    const void* planes, const void* prior_t, const void* prior_slot,
    void* keys, void* csum, void* unit_pair, void* out_t, void* out_slot,
    int n_rows, int n_pairs, int unit, void* stream) {
  return prismarine::walk_launch<prismarine::FormMT2>(
      tile_start, pair_tile, pair_sb, pair_mask, n_real, rays, planes,
      prior_t, prior_slot, keys, csum, unit_pair, out_t, out_slot, n_rows,
      n_pairs, unit, stream);
}
