// The balanced walk of the pair intersectors "mt", "mt2" and "mxu": one
// design for all three, each form supplying the staged layout, the body
// of one ray-triangle test, its rays per thread and its chains per stage
// (sb_intersect.cu: FormMT, FormMT2; sb_intersect_mxu.cu: FormMXU).
//
// Function (as the plain versions in ops/sb_intersect.py): per ray row,
// the closest (t, slot) after a tile-major pair list, from the prior or
// from (t_cap, -1), strict <; among equal t the earliest (pair, k, lane)
// in list order wins; a miss folds as INF_DIST; pairs at or beyond n_real
// are ignored.
//
// What bounds it on the H100: the issue rate.  Under -fmad=false each add
// and multiply of a test is its own instruction; on top come the IEEE
// reciprocal, the predicate and the fold, and the operands' shared-memory
// loads.  The design spends as few issue slots per test as it can, and
// keeps every SM busy until the end:
//
// * Work units: runs of `unit` consecutive live (pair, k) sub-blocks of
//   the list, across tile boundaries (the wrapper passes WALK_UNIT of
//   ops/sb_intersect.py, which its torch emulation of the walk uses too).
//   A one-block plan kernel takes the prefix sum of the masks' popcounts
//   (csum) and, for every unit, the pair it starts in (unit_pair).  A
//   persistent grid (the SMs times the resident blocks per SM) takes
//   units from a counter in device memory; the unit count is read there
//   too, so the host never waits.
// * Keys: every ray row holds one 64-bit key, (bits of t) << 32 |
//   (p - tile_start[tile]) * 1024 + k * 128 + lane + 1.  Positive floats
//   order like their bits, so the minimum key is the closest t with the
//   earliest (pair, k, lane) among equal t.  The init kernel writes (bits
//   of the prior t or t_cap, 0), so an equal t never replaces it (the
//   strict <); a t <= 0 or NaN maps to 0 and nothing replaces it.  A
//   block folds its rays' (t, index) in registers and flushes one 64-bit
//   atomicMin per ray when the tile changes and at the unit's end;
//   atomicMin does not depend on order, so the result is deterministic.
//   The decode kernel returns the prior (t, slot) where the low word is 0,
//   else t from the high word and slot = pair_sb[tile_start + (low-1) >>
//   10] * 1024 + ((low-1) & 1023).
// * Fewer slots per test: each thread owns Form::R rays, so each staged
//   operand serves R tests.  All lanes of a warp test the same triangle,
//   so an operand is a broadcast; a sub-block is staged triangle-major
//   (Form::W floats per triangle), so one LDS.128 brings four operands.
//   The warps of a block split the sub-block's 128 triangles and the
//   tile's rays (WalkShape); the triangle groups meet in shared memory at
//   the flush.
// * Fewer tests computed in full: the form's test skips its second half
//   (v and t) when no lane of the warp passes the first (|det| >= eps and
//   0 <= u <= 1), which implies the full predicate fails.
// * Stages and chains: a stage is what one barrier stages and the block
//   then tests.  With Form::CHAINS = 1 ("mt", "mxu") it is one live
//   sub-block.  With 2 ("mt2") it is the next two live sub-blocks of the
//   unit when both lie in one ray tile, else one (a tile boundary, or
//   the unit's last sub-block): each thread then tests its rays against
//   triangle jj of both sub-blocks in one loop body, two independent
//   Moller-Trumbore chains, and a lone stage runs only the first chain
//   (a block-uniform branch; nothing is computed and dropped).  Each
//   chain keeps its own (t, index) per ray, folded with a strict < in
//   list order, and votes its own skip; the chains meet as keys at the
//   flush, where the key minimum is the closest t, then the earliest
//   (pair, k, lane).  (One running best shared by the chains would fold
//   the second sub-block's triangle jj before the first's jj + 1 and
//   could keep the later of two equal t.)
// * Staging: each thread copies its triangle's operands (of each of the
//   stage's sub-blocks) into shared memory right before the stage is
//   tested; the other resident blocks of the SM hide the loads (a
//   cp.async copy of the next sub-block measured slower on the H100,
//   PERF.md).  Stage s goes into buffer s & 1, so one barrier per stage
//   suffices: a thread stages s + 2 only after the barrier of s + 1,
//   which every thread reaches after testing s.
//
// The test bodies are the plain versions' operation order, and the
// library is built with -fmad=false, so (t, slot) equal the plain
// versions' bit for bit.
#pragma once

#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace prismarine {

constexpr int WALK_THREADS = TILE;                          // one per ray row
constexpr int WALK_WARPS = WALK_THREADS / 32;
constexpr int PLAN_THREADS = 1024;
constexpr int PLAN_ITEMS = 8;                               // pairs per thread

// How a block of the walk splits a tile's 128 rays and a sub-block's 128
// triangles with R rays per thread: the warps form RAY_GROUPS groups of
// 32 * R rays and TRI_GROUPS groups of TRIS triangles.
template <int R>
struct WalkShape {
  static constexpr int RAY_GROUPS = TILE / (32 * R);
  static constexpr int TRI_GROUPS = WALK_WARPS / RAY_GROUPS;
  static constexpr int TRIS = BLOCK / TRI_GROUPS;
  static_assert(RAY_GROUPS >= 1 && WALK_WARPS % RAY_GROUPS == 0,
                "rays per thread must be 1, 2 or 4");
};

typedef unsigned long long walk_key;

// csum[p]: live sub-blocks of pairs 0..p (a pair at or beyond n_real
// counts 0); unit_pair[u]: the pair holding live sub-block u * unit.
// One block scans the list in chunks of PLAN_THREADS * PLAN_ITEMS pairs,
// read and written coalesced through shared memory.
static __global__ void __launch_bounds__(PLAN_THREADS)
sb_intersect_plan_kernel(const int* __restrict__ pair_mask,
                         const int* __restrict__ n_real, int n_pairs,
                         int unit, int* __restrict__ csum,
                         int* __restrict__ unit_pair) {
  typedef cub::BlockScan<int, PLAN_THREADS> Scan;
  constexpr int CHUNK = PLAN_THREADS * PLAN_ITEMS;
  __shared__ typename Scan::TempStorage scratch;
  __shared__ int s_cnt[CHUNK];
  const int tid = threadIdx.x;
  const int nr = max(0, min(*n_real, n_pairs));
  int carry = 0;                                // live sub-blocks so far
  for (int base = 0; base < n_pairs; base += CHUNK) {
#pragma unroll
    for (int i = 0; i < PLAN_ITEMS; ++i) {
      const int p = base + i * PLAN_THREADS + tid;
      s_cnt[i * PLAN_THREADS + tid] = p < nr ? __popc(pair_mask[p] & 0xff) : 0;
    }
    __syncthreads();
    int cnt[PLAN_ITEMS], local = 0;
#pragma unroll
    for (int i = 0; i < PLAN_ITEMS; ++i) {
      cnt[i] = s_cnt[tid * PLAN_ITEMS + i];
      local += cnt[i];
    }
    int run, chunk_total;
    Scan(scratch).ExclusiveSum(local, run, chunk_total);
    run += carry;
#pragma unroll
    for (int i = 0; i < PLAN_ITEMS; ++i) {
      const int first = run;
      run += cnt[i];
      s_cnt[tid * PLAN_ITEMS + i] = run;
      for (int u = (first + unit - 1) / unit; u * unit < run; ++u)
        unit_pair[u] = base + tid * PLAN_ITEMS + i;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PLAN_ITEMS; ++i) {
      const int p = base + i * PLAN_THREADS + tid;
      if (p < n_pairs) csum[p] = s_cnt[i * PLAN_THREADS + tid];
    }
    carry += chunk_total;
    __syncthreads();                            // s_cnt and scratch reused
  }
}

// keys[row] = (bits of the prior t or t_cap, 0); keys[n_rows] = 0 (the
// walk's unit counter)
static __global__ void sb_intersect_keys_init_kernel(const float* __restrict__ rays,
                                           const float* __restrict__ prior_t,
                                           walk_key* __restrict__ keys,
                                           int n_rows) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row == 0) keys[n_rows] = 0;
  if (row >= n_rows) return;
  const float t = prior_t != nullptr
                      ? prior_t[row]
                      : rays[static_cast<size_t>(row) * RAY_COLS + RC_TCAP];
  keys[row] = t > 0.0f ? static_cast<walk_key>(__float_as_uint(t)) << 32 : 0ull;
}

static __global__ void sb_intersect_keys_decode_kernel(
    const walk_key* __restrict__ keys, const float* __restrict__ rays,
    const float* __restrict__ prior_t, const int* __restrict__ prior_slot,
    const int* __restrict__ tile_start, const int* __restrict__ pair_sb,
    float* __restrict__ out_t, int* __restrict__ out_slot, int n_rows) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const walk_key key = keys[row];
  const unsigned low = static_cast<unsigned>(key);
  if (low == 0) {                               // the prior stands
    out_t[row] = prior_t != nullptr
                     ? prior_t[row]
                     : rays[static_cast<size_t>(row) * RAY_COLS + RC_TCAP];
    out_slot[row] = prior_slot != nullptr ? prior_slot[row] : -1;
    return;
  }
  const unsigned idx = low - 1;
  out_t[row] = __uint_as_float(static_cast<unsigned>(key >> 32));
  const int p = tile_start[row / TILE] + static_cast<int>(idx >> 10);
  out_slot[row] = pair_sb[p] * SB_LANES + static_cast<int>(idx & 1023);
}

// The block's folded (t, index) of one tile's rays into their keys: the
// chains meet as keys in registers, the triangle groups in shared memory,
// then one atomicMin per ray.
template <int R, int C>
__device__ __forceinline__ void flush(walk_key* __restrict__ keys,
                                      walk_key (*s_red)[TILE], int tile,
                                      int ray0, int tgroup, int tid,
                                      const float (&best_t)[C][R],
                                      const unsigned (&best_i)[C][R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    walk_key v = ~0ull;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const walk_key w =
          best_i[c][r] != 0
              ? (static_cast<walk_key>(__float_as_uint(best_t[c][r])) << 32) |
                    best_i[c][r]
              : ~0ull;
      v = w < v ? w : v;
    }
    s_red[tgroup][ray0 + r * 32] = v;
  }
  __syncthreads();
  walk_key v = s_red[0][tid];
#pragma unroll
  for (int g = 1; g < WalkShape<R>::TRI_GROUPS; ++g) {
    const walk_key w = s_red[g][tid];
    v = w < v ? w : v;
  }
  if (v != ~0ull) atomicMin(keys + static_cast<size_t>(tile) * TILE + tid, v);
  __syncthreads();
}

// The thread's triangles j0 .. j0 + TRIS - 1 of a stage's first N staged
// sub-blocks against its rays: chain c tests sub-block c (index base[c] +
// triangle) and folds into its own (t, index) per ray with a strict <.
template <class Form, int N, int C>
__device__ __forceinline__ void test_stage(
    const float4 (*tri)[BLOCK][Form::W / 4], int j0,
    const typename Form::Ray (&ray)[Form::R], float (&best_t)[C][Form::R],
    unsigned (&best_i)[C][Form::R], const unsigned (&base)[C]) {
  constexpr int W4 = Form::W / 4;
  constexpr int R = Form::R;
#pragma unroll 2
  for (int jj = 0; jj < WalkShape<R>::TRIS; ++jj) {
    float4 op[N][W4];
#pragma unroll
    for (int c = 0; c < N; ++c)
#pragma unroll
      for (int w = 0; w < W4; ++w) op[c][w] = tri[c][j0 + jj][w];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const float tt = Form::test(op[c], ray[r]);
        if (tt < best_t[c][r]) {
          best_t[c][r] = tt;
          best_i[c][r] = base[c] + j0 + jj;
        }
      }
  }
}

template <class Form>
__global__ void __launch_bounds__(WALK_THREADS)
sb_intersect_walk_kernel(const int* __restrict__ tile_start,
                         const int* __restrict__ pair_tile,
                         const int* __restrict__ pair_sb,
                         const int* __restrict__ pair_mask,
                         const int* __restrict__ csum,
                         const int* __restrict__ unit_pair, int n_pairs,
                         int unit, const float* __restrict__ rays,
                         const float* __restrict__ planes,
                         walk_key* __restrict__ keys, int n_rows) {
  constexpr int W4 = Form::W / 4;
  constexpr int R = Form::R;
  constexpr int C = Form::CHAINS;
  static_assert(C == 1 || C == 2, "one or two chains per stage");
  typedef WalkShape<R> Shape;
  __shared__ __align__(16) float4 s_tri[2][C][BLOCK][W4];
  __shared__ walk_key s_red[Shape::TRI_GROUPS][TILE];
  __shared__ int s_unit;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ray0 = (warp % Shape::RAY_GROUPS) * 32 * R + lane;
  const int tgroup = warp / Shape::RAY_GROUPS;
  const int j0 = tgroup * Shape::TRIS;
  const int total = csum[n_pairs - 1];
  const int n_units = (total + unit - 1) / unit;
  unsigned* counter = reinterpret_cast<unsigned*>(keys + n_rows);

  for (;;) {
    if (tid == 0) s_unit = static_cast<int>(atomicAdd(counter, 1u));
    __syncthreads();
    const int u = s_unit;
    __syncthreads();                            // every thread has read it
    if (u >= n_units) break;
    const int s0 = u * unit;
    const int n = min(unit, total - s0);
    // the unit's first live sub-block: skip the pair's earlier set bits
    int p = unit_pair[u];
    int m = pair_mask[p] & 0xff;
    for (int skip = s0 - (csum[p] - __popc(m)); skip > 0; --skip) m &= m - 1;

    int cur_tile = -1, run_start = 0;
    typename Form::Ray ray[R];
    float best_t[C][R];
    unsigned best_i[C][R];
    // (p, m's lowest bit) is the unit's live sub-block i
    for (int i = 0, s = 0; i < n; ++s) {
      const int pa = p, ka = __ffs(m) - 1;
      const int tile = pair_tile[pa];
      int pb = pa, kb = -1;                     // kb < 0: a lone stage
      if (C == 2 && i + 1 < n) {                // look at sub-block i + 1
        m &= m - 1;
        while (m == 0) m = pair_mask[++p] & 0xff;
        if (pair_tile[p] == tile) {
          pb = p;
          kb = __ffs(m) - 1;
        }
      }
      const bool two = kb >= 0;
      Form::stage(reinterpret_cast<float*>(s_tri[s & 1][0][tid]), planes,
                  pair_sb[pa], ka, tid);
      if (two)
        Form::stage(reinterpret_cast<float*>(s_tri[s & 1][C - 1][tid]),
                    planes, pair_sb[pb], kb, tid);
      __syncthreads();

      if (tile != cur_tile) {
        if (cur_tile >= 0)
          flush<R, C>(keys, s_red, cur_tile, ray0, tgroup, tid, best_t,
                      best_i);
        cur_tile = tile;
        run_start = tile_start[tile];
        const size_t row0 = static_cast<size_t>(tile) * TILE + ray0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ray[r].load(rays + (row0 + r * 32) * RAY_COLS);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            best_t[c][r] = __int_as_float(0x7f800000);
            best_i[c][r] = 0;
          }
        }
      }
      unsigned base[C];
      base[0] = static_cast<unsigned>((pa - run_start) * SB_LANES +
                                      ka * BLOCK + 1);
      if (C == 2)
        base[C - 1] = static_cast<unsigned>((pb - run_start) * SB_LANES +
                                            kb * BLOCK + 1);
      if (two)
        test_stage<Form, C, C>(s_tri[s & 1], j0, ray, best_t, best_i, base);
      else
        test_stage<Form, 1, C>(s_tri[s & 1], j0, ray, best_t, best_i, base);
      // past the stage: (p, m) already holds sub-block i + 1 after a lone
      // stage that looked ahead
      i += two ? 2 : 1;
      if (C == 1 || two) {
        m &= m - 1;
        if (i < n)
          while (m == 0) m = pair_mask[++p] & 0xff;
      }
    }
    flush<R, C>(keys, s_red, cur_tile, ray0, tgroup, tid, best_t, best_i);
  }
}

// One query on the walk: plan, key init, walk, decode (four launches on
// ``stream``, no host sync).  ``keys`` holds n_rows + 1 keys (the last is
// the unit counter), ``csum`` n_pairs ints and ``unit_pair``
// ceil(n_pairs * SB / unit) ints.  Returns cudaGetLastError().
template <class Form>
int walk_launch(const void* tile_start, const void* pair_tile,
                const void* pair_sb, const void* pair_mask,
                const void* n_real, const void* rays, const void* planes,
                const void* prior_t, const void* prior_slot, void* keys,
                void* csum, void* unit_pair, void* out_t, void* out_slot,
                int n_rows, int n_pairs, int unit, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  walk_key* k = static_cast<walk_key*>(keys);
  const int* ts = static_cast<const int*>(tile_start);
  const int* psb = static_cast<const int*>(pair_sb);
  const int* pm = static_cast<const int*>(pair_mask);
  const float* r = static_cast<const float*>(rays);
  const float* pt = static_cast<const float*>(prior_t);
  if (unit <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (n_pairs > 0)
    sb_intersect_plan_kernel<<<1, PLAN_THREADS, 0, st>>>(
        pm, static_cast<const int*>(n_real), n_pairs, unit,
        static_cast<int*>(csum), static_cast<int*>(unit_pair));
  const int row_blocks = (n_rows + 255) / 256;
  sb_intersect_keys_init_kernel<<<row_blocks, 256, 0, st>>>(r, pt, k, n_rows);
  if (n_pairs > 0) {
    static int resident = 0;                    // blocks the card holds at once
    if (resident == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sb_intersect_walk_kernel<Form>, WALK_THREADS, 0);
      resident = sms * max(per_sm, 1);
    }
    const int units_max = (n_pairs * SB + unit - 1) / unit;
    sb_intersect_walk_kernel<Form>
        <<<min(resident, units_max), WALK_THREADS, 0, st>>>(
            ts, static_cast<const int*>(pair_tile), psb, pm,
            static_cast<const int*>(csum),
            static_cast<const int*>(unit_pair), n_pairs, unit, r,
            static_cast<const float*>(planes), k, n_rows);
  }
  sb_intersect_keys_decode_kernel<<<row_blocks, 256, 0, st>>>(
      k, r, pt, static_cast<const int*>(prior_slot), ts, psb,
      static_cast<float*>(out_t), static_cast<int*>(out_slot), n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace prismarine
