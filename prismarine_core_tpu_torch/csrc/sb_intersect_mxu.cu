// Fused (ray tile x superblock) pair intersector, form "mxu": the
// determinant form of Moller-Trumbore (wrapper: ops/sb_intersect.py
// sb_intersect_mxu).
//
// Replaces prismarine_core_tpu/ops/pallas_intersect.py:_sb_kernel_mxu.
// det and the u, v and t numerators are linear in the ray row
// [o, d, 1, c], c = (o - center) x d (columns RC_O*, RC_D*, RC_ONE, RC_C*
// of the ray matrix), so for each live sub-block the TPU kernel computed
// all four [128, 128] grids as ONE [128,16] x [16,512] product on its
// matrix unit against the coefficient planes of mxu_planes_from_planes
// (f32[nsb+1, 16, 4096]; sub-block k's lanes [512k, 512k+512) hold the
// groups [det | u_num | v_num | t_num]).  Then: the reciprocal, the
// predicate (|det| >= 1e-10, u, v >= 0, u + v <= 1, t > PZERO) and the
// fold.  Invalid and sentinel slots have all-zero coefficients, so det = 0
// rejects them and no valid row is read.  Result and tie rule are those
// of sb_intersect.cu: per ray the closest (t, slot) from the prior or
// (t_cap, -1), strict <, earliest (pair, k, lane) wins at equal t.
//
// Precision: the sums must be true fp32.  The TPU needed
// Precision.HIGHEST, since single-pass bf16 lost 10% of the hits on these
// cancelling sums; TF32 keeps even fewer bits than that, and 3xTF32 is
// not bit-exact fp32 and no faster here: the dense [128,16]x[16,512]
// product is 2.1 MFLOP per sub-block of which 0.62 are the useful terms,
// and the epilogue stays on the CUDA cores.  So this kernel uses no tensor
// cores: each thread sums its rays' products on the CUDA cores in the
// fixed order of ops/sb_intersect.py:MXU_TERMS, skipping the coefficient
// rows that are zero by construction (19 of the 64 are not), and the
// library is built with -fmad=false, so t and slot equal the plain
// version's bit for bit.
//
// What bounds it on the H100: the fp32 issue rate, as for "mt": 16K tests
// of 39 operations per live sub-block (the 19 products and 15 adds of the
// four sums, the reciprocal, three scalings and u + v; mt needs 46),
// against 9.5 KB of coefficients.
//
// Design: the balanced walk of sb_walk.cuh; FormMXU below stages a
// sub-block's 19 used coefficient rows triangle-major (20 floats per
// triangle, five LDS.128) and holds the test body.
#include "sb_walk.cuh"

namespace prismarine {

constexpr int MXU_Q = 4;                        // det, u_num, v_num, t_num
constexpr int MXU_LANES = SB * MXU_Q * BLOCK;   // coefficient plane width
constexpr int MXU_USED = 19;                    // (row, quantity) terms read

struct FormMXU {
  static constexpr int W = 20;
  static constexpr int R = 2;   // rays per thread (at 4: 101 registers)
  static constexpr int CHAINS = 1;  // sub-blocks per stage
  struct Ray {
    float dx, dy, dz, cx, cy, cz, ox, oy, oz, one;
    __device__ __forceinline__ void load(const float* r) {
      dx = r[RC_DX], dy = r[RC_DY], dz = r[RC_DZ];
      cx = r[RC_CX], cy = r[RC_CY], cz = r[RC_CZ];
      ox = r[RC_OX], oy = r[RC_OY], oz = r[RC_OZ];
      one = r[RC_ONE];
    }
  };
  // thread t copies triangle t's 19 terms of sub-block k of superblock sb
  __device__ __forceinline__ static void stage(float* dst, const float* coef,
                                               int sb, int k, int t) {
    // the MXU_TERMS order of ops/sb_intersect.py: (ray column, quantity)
    constexpr int row[MXU_USED] = {
        RC_DX, RC_DY, RC_DZ,                                   // det
        RC_DX, RC_DY, RC_DZ, RC_CX, RC_CY, RC_CZ,              // u_num
        RC_DX, RC_DY, RC_DZ, RC_CX, RC_CY, RC_CZ,              // v_num
        RC_OX, RC_OY, RC_OZ, RC_ONE};                          // t_num
    constexpr int qty[MXU_USED] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 2,
                                   2, 2, 2, 2, 2, 3, 3, 3, 3};
    const float* src = coef + static_cast<size_t>(sb) * PLANE_ROWS * MXU_LANES
                       + k * MXU_Q * BLOCK + t;
#pragma unroll
    for (int c = 0; c < MXU_USED; ++c)
      dst[c] = __ldg(src + row[c] * MXU_LANES + qty[c] * BLOCK);
  }
  __device__ __forceinline__ static float test(const float4* op,
                                               const Ray& r) {
    const float4 a = op[0], b = op[1], c = op[2], d = op[3], e = op[4];
    const float det = r.dx * a.x + r.dy * a.y + r.dz * a.z;
    const float un = r.dx * a.w + r.dy * b.x + r.dz * b.y + r.cx * b.z +
                     r.cy * b.w + r.cz * c.x;
    const float inv = 1.0f / (fabsf(det) < DET_EPS ? DET_EPS : det);
    const float uu = un * inv;
    // the warp-uniform skip of sb_intersect.cu's mt_eval (no valid row
    // here: invalid slots have det = 0)
    if (!__any_sync(0xffffffffu,
                    (fabsf(det) >= DET_EPS) && (uu >= 0.0f) && (uu <= 1.0f)))
      return INF_DIST;
    const float vn = r.dx * c.y + r.dy * c.z + r.dz * c.w + r.cx * d.x +
                     r.cy * d.y + r.cz * d.z;
    const float tn = r.ox * d.w + r.oy * e.x + r.oz * e.y + r.one * e.z;
    const float vv = vn * inv;
    const float tt = tn * inv;
    const bool ok = (fabsf(det) >= DET_EPS) && (uu >= 0.0f) &&
                    (vv >= 0.0f) && (uu + vv <= 1.0f) && (tt > PZERO);
    return ok ? tt : INF_DIST;
  }
};

}  // namespace prismarine

extern "C" int sb_intersect_mxu_launch(
    const void* tile_start, const void* pair_tile, const void* pair_sb,
    const void* pair_mask, const void* n_real, const void* rays,
    const void* coef, const void* prior_t, const void* prior_slot,
    void* keys, void* csum, void* unit_pair, void* out_t, void* out_slot,
    int n_rows, int n_pairs, int unit, void* stream) {
  return prismarine::walk_launch<prismarine::FormMXU>(
      tile_start, pair_tile, pair_sb, pair_mask, n_real, rays, coef,
      prior_t, prior_slot, keys, csum, unit_pair, out_t, out_slot, n_rows,
      n_pairs, unit, stream);
}
