// The two cull kernels of the packet query (wrappers: ops/cull.py).
//
// block_cull replaces prismarine_core_tpu/ops/pallas_cull.py:_cull_kernel
// (driven by pallas_block_cull): for each 128-ray tile and each box lane,
// the minimum over the tile's rays of the slab entry distance (INF_DIST if
// no ray passes).  Tiles >= *n_live write INF_DIST untested.
//   What bounds it on the H100: arithmetic.  At the bench frame (7200 tiles
//   x 256 superblock boxes) it does 236M ray-box slab tests (~25 flops
//   each) and moves only ~7 MB (rays read once per box chunk, 7 MB of
//   output), so it sits far above the bandwidth roofline.
//   Design: one block per (tile, 128-box chunk), one box per thread; the
//   tile's 7 used ray columns are staged once in shared memory (3.5 KB)
//   and every thread streams them as broadcasts, keeping its box in
//   registers.  n_live is read on the device, so the caller never syncs.
//
// pair_cull replaces pallas_cull.py:_pair_cull_kernel (driven by
// pallas_pair_cull): for each (tile, superblock) pair, bit k of its mask is
// set when some ray of the pair's tile passes block k's slab test.  Pairs
// >= *n_real get mask 0.
//   What bounds it: arithmetic again (128 rays x 8 boxes per pair, ~10^5
//   pairs per query at the bench frame); the ray tile is read from L1/L2.
//   Design: 128 threads = 16 pairs x 8 boxes; every pair carries its own
//   tile, so the list needs no tile alignment (the TPU kernel's cpps
//   alignment padding is gone).  The 8 bits of a pair live in 8 adjacent
//   lanes of one warp and are OR-ed with three shuffles.
#include "common.cuh"

namespace prismarine {

constexpr int PAIRS_PER_BLOCK = TILE / SB;   // 16 pairs x 8 boxes

__global__ void __launch_bounds__(TILE)
block_cull_kernel(const float* __restrict__ rays,
                  const float* __restrict__ box_rows,
                  const int* __restrict__ n_live,
                  float* __restrict__ out, int nb_pad) {
  __shared__ float s_ray[7][TILE];   // ox oy oz ivx ivy ivz t_cap
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int box = blockIdx.y * TILE + lane;
  float* dst = out + static_cast<size_t>(tile) * nb_pad + box;
  if (tile >= *n_live) {             // uniform over the block
    *dst = INF_DIST;
    return;
  }
  const float* r = rays + (static_cast<size_t>(tile) * TILE + lane) * RAY_COLS;
  s_ray[0][lane] = r[RC_OX];
  s_ray[1][lane] = r[RC_OY];
  s_ray[2][lane] = r[RC_OZ];
  s_ray[3][lane] = r[RC_IVX];
  s_ray[4][lane] = r[RC_IVY];
  s_ray[5][lane] = r[RC_IVZ];
  s_ray[6][lane] = r[RC_TCAP];
  __syncthreads();
  const float lox = box_rows[0 * nb_pad + box];
  const float loy = box_rows[1 * nb_pad + box];
  const float loz = box_rows[2 * nb_pad + box];
  const float hix = box_rows[3 * nb_pad + box];
  const float hiy = box_rows[4 * nb_pad + box];
  const float hiz = box_rows[5 * nb_pad + box];
  float best = INF_DIST;
#pragma unroll 4
  for (int j = 0; j < TILE; ++j) {
    best = fminf(best, slab_entry(s_ray[0][j], s_ray[1][j], s_ray[2][j],
                                  s_ray[3][j], s_ray[4][j], s_ray[5][j],
                                  s_ray[6][j], lox, loy, loz, hix, hiy, hiz));
  }
  *dst = best;
}

__global__ void __launch_bounds__(TILE)
pair_cull_kernel(const int* __restrict__ pair_tile,
                 const int* __restrict__ pair_sb,
                 const int* __restrict__ n_real,
                 const float* __restrict__ rays,
                 const float* __restrict__ sb_boxes,
                 int* __restrict__ out, int n_pairs) {
  const int p = blockIdx.x * PAIRS_PER_BLOCK + threadIdx.x / SB;
  const int k = threadIdx.x % SB;
  unsigned bit = 0;
  if (p < n_pairs && p < *n_real) {
    const float* b = sb_boxes + static_cast<size_t>(pair_sb[p]) * BOX_ROWS * SB;
    const float lox = b[0 * SB + k], loy = b[1 * SB + k], loz = b[2 * SB + k];
    const float hix = b[3 * SB + k], hiy = b[4 * SB + k], hiz = b[5 * SB + k];
    const float* r = rays + static_cast<size_t>(pair_tile[p]) * TILE * RAY_COLS;
    float best = INF_DIST;
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      const float* rj = r + j * RAY_COLS;
      best = fminf(best, slab_entry(rj[RC_OX], rj[RC_OY], rj[RC_OZ],
                                    rj[RC_IVX], rj[RC_IVY], rj[RC_IVZ],
                                    rj[RC_TCAP], lox, loy, loz, hix, hiy,
                                    hiz));
    }
    bit = best < INF_DIST ? (1u << k) : 0u;
  }
  // every lane reaches the shuffles; a pair's 8 lanes are adjacent
  bit |= __shfl_xor_sync(0xffffffffu, bit, 1);
  bit |= __shfl_xor_sync(0xffffffffu, bit, 2);
  bit |= __shfl_xor_sync(0xffffffffu, bit, 4);
  if (k == 0 && p < n_pairs) out[p] = static_cast<int>(bit);
}

}  // namespace prismarine

extern "C" int block_cull_launch(const void* rays, const void* box_rows,
                                 const void* n_live, void* out, int n_tiles,
                                 int nb_pad, void* stream) {
  using namespace prismarine;
  if (n_tiles > 0 && nb_pad > 0) {
    const dim3 grid(n_tiles, nb_pad / TILE);
    block_cull_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rays), static_cast<const float*>(box_rows),
        static_cast<const int*>(n_live), static_cast<float*>(out), nb_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pair_cull_launch(const void* pair_tile, const void* pair_sb,
                                const void* n_real, const void* rays,
                                const void* sb_boxes, void* out, int n_pairs,
                                void* stream) {
  using namespace prismarine;
  if (n_pairs > 0) {
    const int blocks = (n_pairs + PAIRS_PER_BLOCK - 1) / PAIRS_PER_BLOCK;
    pair_cull_kernel<<<blocks, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(pair_tile), static_cast<const int*>(pair_sb),
        static_cast<const int*>(n_real), static_cast<const float*>(rays),
        static_cast<const float*>(sb_boxes), static_cast<int*>(out), n_pairs);
  }
  return static_cast<int>(cudaGetLastError());
}
