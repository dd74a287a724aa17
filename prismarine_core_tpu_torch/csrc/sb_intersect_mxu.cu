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
// rejects them and no valid row is read.  Result, tie rule and walk are
// those of sb_intersect.cu: per ray the closest (t, slot) from the prior
// or (t_cap, -1), strict <, earliest (pair, k, lane) wins at equal t.
//
// Precision: the sums must be true fp32.  The TPU needed
// Precision.HIGHEST, since single-pass bf16 lost 10% of the hits on these
// cancelling sums; TF32 keeps even fewer bits than that.  So this kernel
// uses no tensor cores: each thread sums its ray's products on the CUDA
// cores in the fixed order of ops/sb_intersect.py:MXU_TERMS, skipping the
// coefficient rows that are zero by construction (19 of the 64 are not),
// and the library is built with -fmad=false, so t and slot equal the
// plain version's bit for bit.
//
// What bounds it on the H100: fp32 arithmetic, as for "mt": 16K tests of
// 39 operations per live sub-block (the 19 products and 15 adds of the
// four sums, the reciprocal, three scalings and u + v; mt needs 46),
// against 9.5 KB of coefficients.
//
// Design: one block owns one ray tile and walks its run of the tile-major
// pair list, one thread per ray (sb_intersect.cu's layout).  Each live
// sub-block's 19 used coefficient rows are staged in shared memory
// (9.5 KB) and read as broadcasts.  A tensor-core form (3xTF32 mma) is
// later work.
#include "common.cuh"

namespace prismarine {

constexpr int MXU_Q = 4;                        // det, u_num, v_num, t_num
constexpr int MXU_LANES = SB * MXU_Q * BLOCK;   // coefficient plane width
constexpr int MXU_USED = 19;                    // (row, quantity) terms read

__global__ void __launch_bounds__(TILE)
sb_intersect_mxu_kernel(const int* __restrict__ tile_start,
                        const int* __restrict__ pair_sb,
                        const int* __restrict__ pair_mask,
                        const int* __restrict__ n_real,
                        const float* __restrict__ rays,
                        const float* __restrict__ coef,
                        const float* __restrict__ prior_t,
                        const int* __restrict__ prior_slot,
                        float* __restrict__ out_t, int* __restrict__ out_slot) {
  __shared__ float s_c[MXU_USED][BLOCK];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t row = static_cast<size_t>(tile) * TILE + lane;
  const float* r = rays + row * RAY_COLS;
  const float ox = r[RC_OX], oy = r[RC_OY], oz = r[RC_OZ];
  const float dx = r[RC_DX], dy = r[RC_DY], dz = r[RC_DZ];
  const float one = r[RC_ONE];
  const float cx = r[RC_CX], cy = r[RC_CY], cz = r[RC_CZ];
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
    for (int k = 0; k < SB; ++k) {
      if (((mask >> k) & 1) == 0) continue;
      const float* base = coef + static_cast<size_t>(sb) * PLANE_ROWS * MXU_LANES
                          + k * MXU_Q * BLOCK + lane;
      auto at = [&](int rc, int q) { return base[rc * MXU_LANES + q * BLOCK]; };
      __syncthreads();                          // last sub-block consumed
      // the MXU_TERMS order of ops/sb_intersect.py
      s_c[0][lane] = at(RC_DX, 0);
      s_c[1][lane] = at(RC_DY, 0);
      s_c[2][lane] = at(RC_DZ, 0);
      s_c[3][lane] = at(RC_DX, 1);
      s_c[4][lane] = at(RC_DY, 1);
      s_c[5][lane] = at(RC_DZ, 1);
      s_c[6][lane] = at(RC_CX, 1);
      s_c[7][lane] = at(RC_CY, 1);
      s_c[8][lane] = at(RC_CZ, 1);
      s_c[9][lane] = at(RC_DX, 2);
      s_c[10][lane] = at(RC_DY, 2);
      s_c[11][lane] = at(RC_DZ, 2);
      s_c[12][lane] = at(RC_CX, 2);
      s_c[13][lane] = at(RC_CY, 2);
      s_c[14][lane] = at(RC_CZ, 2);
      s_c[15][lane] = at(RC_OX, 3);
      s_c[16][lane] = at(RC_OY, 3);
      s_c[17][lane] = at(RC_OZ, 3);
      s_c[18][lane] = at(RC_ONE, 3);
      __syncthreads();
      const int slot_base = sb * SB_LANES + k * BLOCK;
#pragma unroll 2
      for (int j = 0; j < BLOCK; ++j) {
        const float det = dx * s_c[0][j] + dy * s_c[1][j] + dz * s_c[2][j];
        const float un = dx * s_c[3][j] + dy * s_c[4][j] + dz * s_c[5][j] +
                         cx * s_c[6][j] + cy * s_c[7][j] + cz * s_c[8][j];
        const float vn = dx * s_c[9][j] + dy * s_c[10][j] + dz * s_c[11][j] +
                         cx * s_c[12][j] + cy * s_c[13][j] + cz * s_c[14][j];
        const float tn = ox * s_c[15][j] + oy * s_c[16][j] + oz * s_c[17][j] +
                         one * s_c[18][j];
        const float inv = 1.0f / (fabsf(det) < DET_EPS ? DET_EPS : det);
        const float uu = un * inv;
        const float vv = vn * inv;
        float tt = tn * inv;
        const bool ok = (fabsf(det) >= DET_EPS) && (uu >= 0.0f) &&
                        (vv >= 0.0f) && (uu + vv <= 1.0f) && (tt > PZERO);
        tt = ok ? tt : INF_DIST;
        if (tt < best_t) {
          best_t = tt;
          best_slot = slot_base + j;
        }
      }
    }
  }
  out_t[row] = best_t;
  out_slot[row] = best_slot;
}

}  // namespace prismarine

extern "C" int sb_intersect_mxu_launch(const void* tile_start,
                                       const void* pair_sb,
                                       const void* pair_mask,
                                       const void* n_real, const void* rays,
                                       const void* coef, const void* prior_t,
                                       const void* prior_slot, void* out_t,
                                       void* out_slot, int n_tiles,
                                       void* stream) {
  using namespace prismarine;
  if (n_tiles > 0) {
    sb_intersect_mxu_kernel<<<n_tiles, TILE, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile_start), static_cast<const int*>(pair_sb),
        static_cast<const int*>(pair_mask), static_cast<const int*>(n_real),
        static_cast<const float*>(rays), static_cast<const float*>(coef),
        static_cast<const float*>(prior_t),
        static_cast<const int*>(prior_slot), static_cast<float*>(out_t),
        static_cast<int*>(out_slot));
  }
  return static_cast<int>(cudaGetLastError());
}
