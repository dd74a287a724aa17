// The two cull kernels of the packet query (wrappers: ops/cull.py).
//
// block_cull replaces prismarine_core_tpu/ops/pallas_cull.py:_cull_kernel
// (driven by pallas_block_cull): for each 128-ray tile and each box lane,
// the minimum over the tile's rays of the slab entry distance (INF_DIST if
// no ray passes).  Tiles >= *n_live write INF_DIST untested.
//
// pair_cull replaces pallas_cull.py:_pair_cull_kernel (driven by
// pallas_pair_cull): for each (tile, superblock) pair, bit k of its mask is
// set when some ray of the pair's tile passes block k's slab test.  Pairs
// >= *n_real get mask 0.  The list needs no tile alignment (the TPU
// kernel's cpps padding is gone).
//
// What bounds them on the H100: at the bench frame nearly every (tile, box)
// test fails (93% of the live superblock entries at bounce 1), so testing
// all 128 rays against every box is work the answer does not need.  Both
// kernels first reject whole (tile, box) entries with an interval test on
// the tile's ray bounds, then run the exact slab test only on the
// survivors; what is left is bounded by reading the ray tiles they need
// (64 B a ray), and the kernels run well below that bound, held by
// instruction issue and the latency of short dependent chains (PERF.md,
// section 6).
//
// The reject (tile_rejects; plain torch: ops/cull.py:tile_reject, which
// decides exactly as this code does).  Over the tile's live lanes
// (t_cap > 0) the kernel takes per axis the origin range [omin, omax] and
// the inverse-direction range [ivmin, ivmax], and the largest t_cap.  On an
// axis where iv has one strict sign over the tile (ivmin > 0 or ivmax < 0)
// every ray's near slab distance is the rounded (plane - o) * iv at its
// near plane (lo for iv > 0, hi for iv < 0) and its far one at the other.
// IEEE rounding is monotone, so each rounded step is monotone in o and in
// iv, and the same rounded formula at the corners of the two ranges bounds
// every ray's value:
//     near >= NL = min((p_near - o_near) * ivmin, (p_near - o_near) * ivmax)
//     far  <= FU = max((p_far - o_far) * ivmin, (p_far - o_far) * ivmax)
// with o_near = omax, o_far = omin for iv > 0 (swapped for iv < 0).  With
// NL the max over the taking axes and FU the min, every ray of the tile
// fails the slab test when NL > FU (tn > tf), FU < 0 (tf < 0 <= max(tn, 0))
// or NL > max t_cap (tn > t_cap).  No directed rounding is needed: the
// bound is the kernel's own rounded arithmetic at a corner (-fmad=false
// keeps every step rounded).  An axis whose iv range holds both signs or a
// zero takes no part; a box with lo > hi on an axis (the padding lanes of
// box_rows_from_blocks) is never rejected; a tile with a non-finite o or iv
// on a live lane rejects nothing; a tile with no live lane passes no box.
//
// Design.  block_cull: one 128-thread block per tile.  Each thread loads
// one ray row (three 16-byte loads), the block reduces the bounds (warp
// shuffles, then shared memory), and each lane then keeps 4 of the tile's
// rays in registers.  Boxes go by in chunks of 256: each thread rejects its
// boxes (writing INF_DIST) or appends them to a shared survivor list
// (ballot + popc); the 4 warps take the survivors in turn, 4 slab tests a
// lane, fminf, and a 5-step shuffle fminf (order-free, so the bits of the
// plain version's min are kept).  pair_cull: each warp walks 16
// consecutive pairs of the tile-major list, reading their indices at once
// (one pair a lane) and each next pair's blocks while it tests the current
// one; it reloads its 4 rays a lane and the tile's bounds only when the
// tile changes; lane l rejects block l % 8, a ballot gives the survivors,
// and each survivor's rays are tested 32 at a time with __any_sync after
// each group, stopping at the first group with a ray that passes.
#include <math_constants.h>

#include "common.cuh"

namespace prismarine {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = TILE / 32;          // block_cull: warps per tile
constexpr int RPL = TILE / 32;            // rays of the tile per lane
constexpr int BOX_CHUNK = 256;            // block_cull: boxes per pass
constexpr int PAIRS_PER_WARP = 16;        // pair_cull: pairs a warp walks

// A ray's columns as the slab test reads them.
struct Ray {
  float o[3], iv[3], tc;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        size_t row) {
  const float4* r = reinterpret_cast<const float4*>(rays + row * RAY_COLS);
  const float4 a = __ldg(r), c = __ldg(r + 1), e = __ldg(r + 2);
  // columns: a = ox oy oz dx, c = dy dz t_cap one, e = ivx ivy ivz cx
  return Ray{{a.x, a.y, a.z}, {e.x, e.y, e.z}, c.z};
}

__device__ __forceinline__ float slab(const Ray& r, const float lo[3],
                                      const float hi[3]) {
  return slab_entry(r.o[0], r.o[1], r.o[2], r.iv[0], r.iv[1], r.iv[2], r.tc,
                    lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]);
}

// Bounds of the live rays (t_cap > 0) seen so far: 13 floats and a flag.
struct Bounds {
  float v[13];   // omin[3] -omax[3] ivmin[3] -ivmax[3] -tcmax: all min-folds
  bool bad;      // a live ray with a non-finite o or iv component
};

__device__ __forceinline__ void bounds_init(Bounds& b) {
#pragma unroll
  for (int i = 0; i < 12; ++i) b.v[i] = CUDART_INF_F;
  b.v[12] = -0.0f;               // -tcmax: no live ray yet
  b.bad = false;
}

__device__ __forceinline__ void bounds_add(Bounds& b, const Ray& r) {
  if (!(r.tc > 0.0f)) return;    // dead lanes (t_cap <= 0 or NaN)
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.v[a] = fminf(b.v[a], r.o[a]);
    b.v[3 + a] = fminf(b.v[3 + a], -r.o[a]);
    b.v[6 + a] = fminf(b.v[6 + a], r.iv[a]);
    b.v[9 + a] = fminf(b.v[9 + a], -r.iv[a]);
    b.bad |= !(isfinite(r.o[a]) && isfinite(r.iv[a]));
  }
  b.v[12] = fminf(b.v[12], -r.tc);
}

// Fold the bounds over the warp; every lane gets the result.
__device__ __forceinline__ void bounds_warp(Bounds& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 13; ++i)
      b.v[i] = fminf(b.v[i], __shfl_xor_sync(FULL, b.v[i], off));
  }
  b.bad = __any_sync(FULL, b.bad);
}

// The reject's view of a tile (see the note at the top).
struct TileReject {
  float o_near[3], o_far[3], iv_lo[3], iv_hi[3];
  bool pos[3], takes[3];
  float tc_max;
  bool none_live, no_reject;
};

__device__ __forceinline__ TileReject tile_reject_of(const Bounds& b) {
  TileReject t;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float omin = b.v[a], omax = -b.v[3 + a];
    t.iv_lo[a] = b.v[6 + a];
    t.iv_hi[a] = -b.v[9 + a];
    t.pos[a] = t.iv_lo[a] > 0.0f;
    t.takes[a] = t.pos[a] || t.iv_hi[a] < 0.0f;
    t.o_near[a] = t.pos[a] ? omax : omin;
    t.o_far[a] = t.pos[a] ? omin : omax;
  }
  t.tc_max = -b.v[12];
  t.none_live = !(t.tc_max > 0.0f);
  t.no_reject = b.bad;
  return t;
}

// True when no live ray of the tile can pass the box (lo, hi).
__device__ __forceinline__ bool tile_rejects(const TileReject& t,
                                             const float lo[3],
                                             const float hi[3]) {
  if (t.none_live) return true;
  if (t.no_reject) return false;
  if (!(lo[0] <= hi[0] && lo[1] <= hi[1] && lo[2] <= hi[2])) return false;
  float nl = -CUDART_INF_F, fu = CUDART_INF_F;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (!t.takes[a]) continue;
    const float dn = (t.pos[a] ? lo[a] : hi[a]) - t.o_near[a];
    const float df = (t.pos[a] ? hi[a] : lo[a]) - t.o_far[a];
    nl = fmaxf(nl, fminf(dn * t.iv_lo[a], dn * t.iv_hi[a]));
    fu = fminf(fu, fmaxf(df * t.iv_lo[a], df * t.iv_hi[a]));
  }
  return nl > fu || fu < 0.0f || nl > t.tc_max;
}

__global__ void __launch_bounds__(TILE)
block_cull_kernel(const float* __restrict__ rays,
                  const float* __restrict__ box_rows,
                  const int* __restrict__ n_live,
                  float* __restrict__ out, int nb_pad) {
  __shared__ Ray s_ray[TILE];
  __shared__ float s_part[WARPS][13];
  __shared__ bool s_bad[WARPS];
  __shared__ int s_list[BOX_CHUNK];
  __shared__ int s_count;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* dst = out + static_cast<size_t>(tile) * nb_pad;
  if (tile >= *n_live) {             // uniform over the block
    for (int b = tid; b < nb_pad; b += TILE) dst[b] = INF_DIST;
    return;
  }

  // the tile's rays: one row a thread, then bounds over the live lanes
  const Ray mine = load_ray(rays, static_cast<size_t>(tile) * TILE + tid);
  s_ray[tid] = mine;
  Bounds bd;
  bounds_init(bd);
  bounds_add(bd, mine);
  bounds_warp(bd);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 13; ++i) s_part[warp][i] = bd.v[i];
    s_bad[warp] = bd.bad;
  }
  if (tid == 0) s_count = 0;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
#pragma unroll
    for (int i = 0; i < 13; ++i) bd.v[i] = fminf(bd.v[i], s_part[w][i]);
    bd.bad |= s_bad[w];
  }
  const TileReject tr = tile_reject_of(bd);
  Ray r[RPL];                        // lane keeps rays lane + 32 j
#pragma unroll
  for (int j = 0; j < RPL; ++j) r[j] = s_ray[lane + 32 * j];

  for (int base = 0; base < nb_pad; base += BOX_CHUNK) {
    const int end = min(base + BOX_CHUNK, nb_pad);
    // reject, or list the box (nb_pad % TILE == 0: every lane iterates)
    for (int b = base + tid; b < end; b += TILE) {
      const float lo[3] = {box_rows[b], box_rows[nb_pad + b],
                           box_rows[2 * nb_pad + b]};
      const float hi[3] = {box_rows[3 * nb_pad + b], box_rows[4 * nb_pad + b],
                           box_rows[5 * nb_pad + b]};
      const bool keep = !tile_rejects(tr, lo, hi);
      if (!keep) dst[b] = INF_DIST;
      const unsigned m = __ballot_sync(FULL, keep);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(&s_count, __popc(m));
      at = __shfl_sync(FULL, at, 0);
      if (keep) s_list[at + __popc(m & ((1u << lane) - 1u))] = b;
    }
    __syncthreads();
    const int n = s_count;
    // the exact test of the survivors, one box a warp at a time
    for (int i = warp; i < n; i += WARPS) {
      const int b = s_list[i];
      const float lo[3] = {box_rows[b], box_rows[nb_pad + b],
                           box_rows[2 * nb_pad + b]};
      const float hi[3] = {box_rows[3 * nb_pad + b], box_rows[4 * nb_pad + b],
                           box_rows[5 * nb_pad + b]};
      float best = INF_DIST;
#pragma unroll
      for (int j = 0; j < RPL; ++j) best = fminf(best, slab(r[j], lo, hi));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        best = fminf(best, __shfl_xor_sync(FULL, best, off));
      if (lane == 0) dst[b] = best;
    }
    __syncthreads();                 // the list is read before its reset
    if (tid == 0) s_count = 0;
    __syncthreads();
  }
}

__device__ __forceinline__ void load_block(const float* __restrict__ sb_boxes,
                                           int sb, int k, float lo[3],
                                           float hi[3]) {
  const float* b = sb_boxes + static_cast<size_t>(sb) * BOX_ROWS * SB + k;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = __ldg(b + a * SB);
    hi[a] = __ldg(b + (3 + a) * SB);
  }
}

__global__ void __launch_bounds__(TILE)
pair_cull_kernel(const int* __restrict__ pair_tile,
                 const int* __restrict__ pair_sb,
                 const int* __restrict__ n_real,
                 const float* __restrict__ rays,
                 const float* __restrict__ sb_boxes,
                 int* __restrict__ out, int n_pairs) {
  const int lane = threadIdx.x & 31;
  const int k = lane % SB;
  const int p0 = (blockIdx.x * WARPS + threadIdx.x / 32) * PAIRS_PER_WARP;
  const int p1 = min(p0 + PAIRS_PER_WARP, n_pairs);
  const int n = max(min(p1, *n_real), p0) - p0;   // the warp's real pairs
  if (p0 + n + lane < p1) out[p0 + n + lane] = 0;  // pairs >= n_real
  // the warp's pair indices, one pair a lane, read at once
  int my_tile = 0, my_sb = 0;
  if (lane < n) {
    my_tile = pair_tile[p0 + lane];
    my_sb = pair_sb[p0 + lane];
  }
  int cur = -1;                      // the tile whose rays the lanes hold
  Ray r[RPL];
  TileReject tr;
  float lo[3], hi[3];                // this pair's block k
  if (n > 0) load_block(sb_boxes, __shfl_sync(FULL, my_sb, 0), k, lo, hi);
  for (int i = 0; i < n; ++i) {      // uniform over the warp
    const int tile = __shfl_sync(FULL, my_tile, i);
    const int next_sb = __shfl_sync(FULL, my_sb, min(i + 1, n - 1));
    float nlo[3], nhi[3];            // the next pair's, loaded ahead
    load_block(sb_boxes, next_sb, k, nlo, nhi);
    if (tile != cur) {
      Bounds bd;
      bounds_init(bd);
#pragma unroll
      for (int j = 0; j < RPL; ++j) {
        r[j] = load_ray(rays, static_cast<size_t>(tile) * TILE + lane + 32 * j);
        bounds_add(bd, r[j]);
      }
      bounds_warp(bd);
      tr = tile_reject_of(bd);
      cur = tile;
    }
    unsigned left = __ballot_sync(FULL, !tile_rejects(tr, lo, hi)) & 0xFFu;
    unsigned bits = 0;
    while (left) {                   // the survivors, in order
      const int kk = __ffs(left) - 1;
      left &= left - 1u;
      float blo[3], bhi[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        blo[a] = __shfl_sync(FULL, lo[a], kk);
        bhi[a] = __shfl_sync(FULL, hi[a], kk);
      }
#pragma unroll
      for (int j = 0; j < RPL; ++j) {
        if (__any_sync(FULL, slab(r[j], blo, bhi) < INF_DIST)) {
          bits |= 1u << kk;
          break;
        }
      }
    }
    if (lane == 0) out[p0 + i] = static_cast<int>(bits);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = nlo[a];
      hi[a] = nhi[a];
    }
  }
}

}  // namespace prismarine

extern "C" int block_cull_launch(const void* rays, const void* box_rows,
                                 const void* n_live, void* out, int n_tiles,
                                 int nb_pad, void* stream) {
  using namespace prismarine;
  if (n_tiles > 0 && nb_pad > 0) {
    block_cull_kernel<<<n_tiles, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
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
    constexpr int per_block = WARPS * PAIRS_PER_WARP;
    const int blocks = (n_pairs + per_block - 1) / per_block;
    pair_cull_kernel<<<blocks, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(pair_tile), static_cast<const int*>(pair_sb),
        static_cast<const int*>(n_real), static_cast<const float*>(rays),
        static_cast<const float*>(sb_boxes), static_cast<int*>(out), n_pairs);
  }
  return static_cast<int>(cudaGetLastError());
}
