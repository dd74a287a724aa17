// Closest-hit and any-hit queries over the LBVH's skip links: persistent
// warps, each lane walking one ray at a time with no stack, refilled from a
// global ray counter.
//
// The port's own kernel: the JAX package walks the BVH in XLA
// (prismarine_core_tpu/accel/traverse.py:_traverse2, a lax.while_loop that
// steps every ray together, masked), with no Pallas body.  Written as torch
// code that lockstep walk issues a gather and a host `any()` per tree step,
// and the hall needs hundreds of steps; on a GPU the native form is each
// lane walking its own ray.  The plain version is the lockstep walk in torch
// (ops/bvh_walk.py:bvh_walk_plain), and this kernel computes the same
// (t, slot) bit for bit: each ray visits the same nodes in the same order
// with the same running best, so it runs the same box tests and the same
// leaf tests, and every float operation below is the plain version's, in
// its order (the build keeps -fmad=false).  Only the order of work across
// rays and the memory layout differ from the plain version.
//
// Per ray: o, d, the guarded 1/d and the running best live in registers.
// From node 0 until node == N: the slab test of the node's box against the
// running best t (tn < best, tf >= max(tn, PZERO)); an intersected internal
// node descends to its left child, anything else follows its skip link.
// At an intersected leaf the K slots are tested in slot order
// (Moller-Trumbore, slots with orig < 0 skipped); as in the plain version's
// argmin, each slot offers min-candidate c = t if it hits below the best,
// else INF_DIST, and the first minimum replaces the best only if it is
// strictly below it.  An any-hit lane stops at its first accepted hit.  A
// lane whose cap is <= PZERO can take no hit (every hit has t > PZERO), so
// it ends before its first step with (t_cap, -1), the plain walk's result.
// (A cap above INF_DIST meets the plain version's one quirk, reproduced
// where a ray ends: see there.)
//
// What bounds it on the H100: a node step is 23 fp32 operations and 32
// bytes of node data, a leaf visit K tests of 46 operations and 48 bytes a
// slot; the whole tree (the hall's records: ~17 MB) stays in the 50 MB L2.
// So the walk is bound neither by DRAM nor by the fp32 rate but by the
// chain of dependent loads (the next node's address comes from this node's
// test), by the load instructions each step issues, and by divergence
// inside a warp (rays take different paths and run different lengths).
// The design:
//  - packed node records (ops/bvh_walk.py:pack_nodes): one 32-byte record
//    a node, float4(lo.xyz, link) and float4(hi.xyz, skip) with the links
//    as float bits, where link is the left child or, at a leaf, ~(its first
//    slot).  A step is two 16-byte loads from one 32-byte sector, where the
//    first form issued eight scalar loads from four arrays;
//  - packed slot records (pack_slots): float4(v0.xyz, orig), float4(v1.xyz,
//    0), float4(v2.xyz, 0), so a leaf's K slots are one run of 48 K bytes
//    and a slot is three 16-byte loads (e1 = v1 - v0, e2 = v2 - v0 stay
//    computed here, as the plain version computes them);
//  - the NaN-propagating min / max of the slab test (torch.minimum /
//    torch.maximum) as single min.NaN / max.NaN instructions;
//  - persistent warps (Aila and Laine's "while-while" walk): a fixed grid
//    of resident blocks; each warp takes rays from a global counter in
//    chunks of 32 (one atomicAdd a chunk, broadcast with __shfl_sync) and
//    hands them to its idle lanes, so a lane that finishes a ray starts
//    the next one at the next leaf round instead of idling until the
//    warp's longest ray ends; the warp runs box steps until every live
//    lane is parked at an intersected leaf or done, then runs the K-wide
//    leaf tests of the parked lanes together;
//  - dead lanes out at once: a ray whose cap is <= PZERO (a terminated
//    path's lane) is answered while the warp refills and never occupies a
//    lane.
// At the bench frame's bounce-1 closest query on an H100 (PERF.md section
// 6) the node records cut 8% of the first form's
// time, the slot records 1.5%, min.NaN 9% and the persistent warps 43%
// more; dead lanes out at once cut the shadow query by 41%.  Node records
// in the tree's preorder (a left child right after its parent) bought
// nothing, nor did fewer registers for more resident warps (spills).
// Near-first child order, a wider tree and FMA contraction would change tie
// slots or ulps, and are not used.
#include "common.cuh"

namespace prismarine {
namespace {

constexpr int WALK_THREADS = 128;
constexpr int WALK_CHUNK = 32;        // rays a warp takes from the counter
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float IV_EPS = 1e-12f;

// torch.minimum / torch.maximum: NaN propagates (fminf / fmaxf drop it)
__device__ __forceinline__ float tmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float tmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 1 / d with |d| < 1e-12 replaced by +-1e-12 (sign kept; +0 counts as +)
__device__ __forceinline__ float guarded_inv(float x) {
  return 1.0f / (fabsf(x) < IV_EPS ? (x < 0.0f ? -IV_EPS : IV_EPS) : x);
}

// ops/intersect.py:moller_trumbore for one (ray, triangle) of a packed slot
// record (a = v0 + orig, b = v1, c = v2): t where it hits, INF_DIST
// elsewhere
__device__ __forceinline__ float mt_t(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float4 a, const float4 b, const float4 c) {
  const float e1x = b.x - a.x, e1y = b.y - a.y, e1z = b.z - a.z;
  const float e2x = c.x - a.x, e2y = c.y - a.y, e2z = c.z - a.z;
  const float px = dy * e2z - dz * e2y;             // p = d x e2
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv = 1.0f / (fabsf(det) < DET_EPS ? DET_EPS : det);
  const float sx = ox - a.x, sy = oy - a.y, sz = oz - a.z;
  const float u = (sx * px + sy * py + sz * pz) * inv;
  const float qx = sy * e1z - sz * e1y;             // q = s x e1
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  const bool ok = fabsf(det) >= DET_EPS && u >= 0.0f && v >= 0.0f &&
                  u + v <= 1.0f && t > PZERO;
  return ok ? t : INF_DIST;
}

// One lane's ray and its walk state.
struct Lane {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz;
  float best;
  int best_slot;
  int node;       // next node to test; n_nodes: done
  int ray;        // the ray's index; -1: the lane holds none
};

}  // namespace

template <bool ANY_HIT>
__global__ void __launch_bounds__(WALK_THREADS) bvh_walk_kernel(
    const float4* __restrict__ nodes, const float4* __restrict__ slots,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_cap, float* __restrict__ out_t,
    int* __restrict__ out_slot, int* __restrict__ next_ray, int n_rays,
    int n_nodes, int leaf_size) {
  const unsigned lane_id = threadIdx.x & 31u;
  const unsigned below = (1u << lane_id) - 1u;
  Lane L;
  L.ray = -1;
  L.node = n_nodes;
  L.ox = L.oy = L.oz = L.dx = L.dy = L.dz = L.ivx = L.ivy = L.ivz = 0.0f;
  L.best = 0.0f;
  L.best_slot = -1;
  int pool = 0, pool_end = 0;      // the warp's rays not yet handed out
  bool drained = false;            // the counter has no rays left
  for (;;) {
    // refill: every idle lane takes the next ray of the warp's chunk (a
    // new chunk from the counter when it runs out); a dead ray is answered
    // here and its lane takes another
    for (;;) {
      const unsigned idle = __ballot_sync(FULL_MASK, L.ray < 0);
      if (idle == 0u) break;
      if (pool == pool_end) {
        if (drained) break;
        int base = 0;
        if (lane_id == 0) base = atomicAdd(next_ray, WALK_CHUNK);
        base = __shfl_sync(FULL_MASK, base, 0);
        if (base >= n_rays) {
          drained = true;
          break;
        }
        pool = base;
        pool_end = min(base + WALK_CHUNK, n_rays);
      }
      const int rank = __popc(idle & below);
      if (L.ray < 0 && rank < pool_end - pool) {
        const int i = pool + rank;
        const float cap = t_cap[i];
        if (cap <= PZERO) {            // no hit lies below the cap
          out_t[i] = cap;
          out_slot[i] = -1;
        } else {
          L.ray = i;
          L.ox = o[3 * i];
          L.oy = o[3 * i + 1];
          L.oz = o[3 * i + 2];
          L.dx = d[3 * i];
          L.dy = d[3 * i + 1];
          L.dz = d[3 * i + 2];
          L.ivx = guarded_inv(L.dx);
          L.ivy = guarded_inv(L.dy);
          L.ivz = guarded_inv(L.dz);
          L.best = cap;
          L.best_slot = -1;
          L.node = 0;
        }
      }
      pool = min(pool + __popc(idle), pool_end);
    }
    if (__ballot_sync(FULL_MASK, L.ray >= 0) == 0u) return;

    // box steps until this lane is parked at an intersected leaf or done
    int leaf_slot = -1;
    while (L.node < n_nodes) {
      const float4 a = __ldg(nodes + 2 * L.node);
      const float4 b = __ldg(nodes + 2 * L.node + 1);
      const float t0x = (a.x - L.ox) * L.ivx, t1x = (b.x - L.ox) * L.ivx;
      const float t0y = (a.y - L.oy) * L.ivy, t1y = (b.y - L.oy) * L.ivy;
      const float t0z = (a.z - L.oz) * L.ivz, t1z = (b.z - L.oz) * L.ivz;
      const float tn = tmax(tmax(tmin(t0x, t1x), tmin(t0y, t1y)),
                            tmin(t0z, t1z));
      const float tf = tmin(tmin(tmax(t0x, t1x), tmax(t0y, t1y)),
                            tmax(t0z, t1z));
      const bool box_hit = (tf >= tmax(tn, PZERO)) && (tn < L.best);
      const int link = __float_as_int(a.w);
      L.node = box_hit && link >= 0 ? link : __float_as_int(b.w);
      if (box_hit && link < 0) {       // parked; node already escapes
        leaf_slot = ~link;
        break;
      }
    }

    // the parked lanes' K-wide leaf tests
    if (leaf_slot >= 0) {
      const float4* s = slots + 3 * leaf_slot;
      float cmin = INF_DIST;
      int cj = -1;
#pragma unroll 4
      for (int k = 0; k < leaf_size; ++k) {
        const float4 va = __ldg(s + 3 * k);
        const float4 vb = __ldg(s + 3 * k + 1);
        const float4 vc = __ldg(s + 3 * k + 2);
        float c = INF_DIST;    // a miss, a padded slot, or no better hit
        if (__float_as_int(va.w) >= 0) {
          const float t = mt_t(L.ox, L.oy, L.oz, L.dx, L.dy, L.dz, va, vb,
                               vc);
          if (t < L.best) c = t;
        }
        if (cj < 0 || c < cmin) {               // argmin: first minimum
          cmin = c;
          cj = k;
        }
      }
      if (cmin < L.best) {
        L.best = cmin;
        L.best_slot = leaf_slot + cj;
      }
      if (ANY_HIT && L.best_slot >= 0) L.node = n_nodes;
    }

    // finish: write the done lanes' results and free them
    if (L.ray >= 0 && L.node >= n_nodes) {
      // The lockstep walk runs its first leaf test on every lane, parked
      // at a leaf or not; a lane with no leaf there is offered only
      // INF_DIST candidates and takes the first (slot 0) whenever its cap
      // exceeds INF_DIST.  After any leaf test best <= INF_DIST, so a cap
      // still above it here means the lane reached no leaf: the same
      // result.
      if (INF_DIST < L.best) {
        L.best = INF_DIST;
        L.best_slot = 0;
      }
      out_t[L.ray] = L.best;
      out_slot[L.ray] = L.best_slot;
      L.ray = -1;
    }
  }
}

}  // namespace prismarine

extern "C" int bvh_walk_launch(
    const void* nodes, const void* slots, const void* o, const void* d,
    const void* t_cap, void* out_t, void* out_slot, void* next_ray,
    int n_rays, int n_nodes, int leaf_size, int any_hit, void* stream) {
  using namespace prismarine;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the grid: as many blocks as the card holds resident at once (queried
  // once a form), and no more than the rays can fill
  static int per_sm[2] = {0, 0};
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per_sm[any_hit ? 1 : 0] == 0) {
    if (any_hit) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[1], bvh_walk_kernel<true>, WALK_THREADS, 0);
    } else {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[0], bvh_walk_kernel<false>, WALK_THREADS, 0);
    }
  }
  const int needed = (n_rays + WALK_THREADS - 1) / WALK_THREADS;
  const dim3 grid(max(1, min(per_sm[any_hit ? 1 : 0] * sms, needed)));
#define PRISMARINE_WALK_ARGS                                              \
  static_cast<const float4*>(nodes), static_cast<const float4*>(slots),   \
      static_cast<const float*>(o), static_cast<const float*>(d),         \
      static_cast<const float*>(t_cap), static_cast<float*>(out_t),       \
      static_cast<int*>(out_slot), static_cast<int*>(next_ray), n_rays,   \
      n_nodes, leaf_size
  if (any_hit) {
    bvh_walk_kernel<true><<<grid, WALK_THREADS, 0, st>>>(PRISMARINE_WALK_ARGS);
  } else {
    bvh_walk_kernel<false><<<grid, WALK_THREADS, 0, st>>>(PRISMARINE_WALK_ARGS);
  }
#undef PRISMARINE_WALK_ARGS
  return static_cast<int>(cudaGetLastError());
}
