// Closest-hit and any-hit queries over the LBVH's skip links: one thread per
// ray, walking the tree with no stack.
//
// The port's own kernel: the JAX package walks the BVH in XLA
// (prismarine_core_tpu/accel/traverse.py:_traverse2, a lax.while_loop that
// steps every ray together, masked), with no Pallas body.  Written as torch
// code that lockstep walk issues a gather and a host `any()` per tree step,
// and the hall needs hundreds of steps; on a GPU the native form is each
// thread walking its own ray.  The plain version is the lockstep walk in
// torch (ops/bvh_walk.py:bvh_walk_plain), and this kernel computes the same
// (t, slot) bit for bit: both visit the same nodes in the same order with
// the same running best, and every float operation below is the plain
// version's, in its order (the build keeps -fmad=false).
//
// Per ray: o, d, the guarded 1/d and t_cap live in registers.  From node 0
// until node == N: the slab test of lo[node], hi[node] against the running
// best t (tn < best, tf >= max(tn, PZERO)); an intersected internal node
// descends to left[node], anything else follows skip[node].  At an
// intersected leaf the K slots are tested in slot order (Moller-Trumbore,
// slots with orig < 0 skipped); as in the plain version's argmin, each slot
// offers min-candidate c = t if it hits below the best, else INF_DIST, and
// the first minimum replaces the best only if it is strictly below it.  An
// any-hit lane stops at its first accepted hit.  (A cap above INF_DIST
// meets the plain version's one quirk, reproduced at the end: see there.)
//
// What bounds it on the H100: a node step is 23 fp32 operations and 32
// bytes of node data, a leaf visit K tests of 46 operations and 40 bytes a
// slot; the whole tree (the hall's: ~11 MB) stays in the 50 MB L2.  So the
// walk is bound neither by DRAM nor by the fp32 rate but by the chain of
// dependent loads (the next node's address comes from this node's test) and
// by divergence inside a warp (rays take different paths and run different
// lengths).  This first design does nothing about either: no treelets, no
// shared-memory stack, no ray reordering inside the kernel (the caller's
// coherence sort, cfg.sort_rays, is the one lever).
#include "common.cuh"

namespace prismarine {
namespace {

constexpr int WALK_THREADS = 128;
constexpr float IV_EPS = 1e-12f;

// torch.minimum / torch.maximum: NaN propagates (fminf / fmaxf drop it)
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// 1 / d with |d| < 1e-12 replaced by +-1e-12 (sign kept; +0 counts as +)
__device__ __forceinline__ float guarded_inv(float x) {
  return 1.0f / (fabsf(x) < IV_EPS ? (x < 0.0f ? -IV_EPS : IV_EPS) : x);
}

// ops/intersect.py:moller_trumbore for one (ray, triangle): t where it hits,
// INF_DIST elsewhere
__device__ __forceinline__ float mt_t(
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float* __restrict__ v0, const float* __restrict__ v1,
    const float* __restrict__ v2) {
  const float v0x = __ldg(v0), v0y = __ldg(v0 + 1), v0z = __ldg(v0 + 2);
  const float e1x = __ldg(v1) - v0x, e1y = __ldg(v1 + 1) - v0y,
              e1z = __ldg(v1 + 2) - v0z;
  const float e2x = __ldg(v2) - v0x, e2y = __ldg(v2 + 1) - v0y,
              e2z = __ldg(v2 + 2) - v0z;
  const float px = dy * e2z - dz * e2y;             // p = d x e2
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv = 1.0f / (fabsf(det) < DET_EPS ? DET_EPS : det);
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
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

}  // namespace

template <bool ANY_HIT>
__global__ void __launch_bounds__(WALK_THREADS) bvh_walk_kernel(
    const float* __restrict__ lo, const float* __restrict__ hi,
    const int* __restrict__ left, const int* __restrict__ skip,
    const float* __restrict__ tv0, const float* __restrict__ tv1,
    const float* __restrict__ tv2, const int* __restrict__ orig,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_cap, float* __restrict__ out_t,
    int* __restrict__ out_slot, int n_rays, int n_nodes, int leaf_size) {
  const int i = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ivx = guarded_inv(dx), ivy = guarded_inv(dy),
              ivz = guarded_inv(dz);
  const int first_leaf = (n_nodes + 1) / 2 - 1;
  float best = t_cap[i];
  int best_slot = -1;
  int node = 0;
  while (node < n_nodes) {
    const float* l = lo + 3 * node;
    const float* h = hi + 3 * node;
    const float t0x = (__ldg(l) - ox) * ivx, t1x = (__ldg(h) - ox) * ivx;
    const float t0y = (__ldg(l + 1) - oy) * ivy,
                t1y = (__ldg(h + 1) - oy) * ivy;
    const float t0z = (__ldg(l + 2) - oz) * ivz,
                t1z = (__ldg(h + 2) - oz) * ivz;
    const float tn = tmax(tmax(tmin(t0x, t1x), tmin(t0y, t1y)),
                          tmin(t0z, t1z));
    const float tf = tmin(tmin(tmax(t0x, t1x), tmax(t0y, t1y)),
                          tmax(t0z, t1z));
    const bool box_hit = (tf >= tmax(tn, PZERO)) && (tn < best);
    if (box_hit && node >= first_leaf) {
      const int base = (node - first_leaf) * leaf_size;
      float cmin = INF_DIST;
      int cj = -1;
      for (int k = 0; k < leaf_size; ++k) {
        const int s = base + k;
        float c = INF_DIST;     // a miss, a padded slot, or no better hit
        if (__ldg(orig + s) >= 0) {
          const float t = mt_t(ox, oy, oz, dx, dy, dz, tv0 + 3 * s,
                               tv1 + 3 * s, tv2 + 3 * s);
          if (t < best) c = t;
        }
        if (cj < 0 || c < cmin) {               // argmin: first minimum
          cmin = c;
          cj = k;
        }
      }
      if (cmin < best) {
        best = cmin;
        best_slot = base + cj;
      }
      if (ANY_HIT && best_slot >= 0) break;
      node = __ldg(skip + node);
    } else {
      node = box_hit ? __ldg(left + node) : __ldg(skip + node);
    }
  }
  // The lockstep walk runs its first leaf test on every lane, parked at a
  // leaf or not; a lane with no leaf there is offered only INF_DIST
  // candidates and takes the first (slot 0) whenever its cap exceeds
  // INF_DIST.  After any leaf test best <= INF_DIST, so a cap still above
  // it here means the lane reached no leaf: the same result.
  if (INF_DIST < best) {
    best = INF_DIST;
    best_slot = 0;
  }
  out_t[i] = best;
  out_slot[i] = best_slot;
}

}  // namespace prismarine

extern "C" int bvh_walk_launch(
    const void* lo, const void* hi, const void* left, const void* skip,
    const void* tv0, const void* tv1, const void* tv2, const void* orig,
    const void* o, const void* d, const void* t_cap, void* out_t,
    void* out_slot, int n_rays, int n_nodes, int leaf_size, int any_hit,
    void* stream) {
  using namespace prismarine;
  const dim3 grid((n_rays + WALK_THREADS - 1) / WALK_THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRISMARINE_WALK_ARGS                                              \
  static_cast<const float*>(lo), static_cast<const float*>(hi),           \
      static_cast<const int*>(left), static_cast<const int*>(skip),       \
      static_cast<const float*>(tv0), static_cast<const float*>(tv1),     \
      static_cast<const float*>(tv2), static_cast<const int*>(orig),      \
      static_cast<const float*>(o), static_cast<const float*>(d),         \
      static_cast<const float*>(t_cap), static_cast<float*>(out_t),       \
      static_cast<int*>(out_slot), n_rays, n_nodes, leaf_size
  if (any_hit) {
    bvh_walk_kernel<true><<<grid, WALK_THREADS, 0, st>>>(PRISMARINE_WALK_ARGS);
  } else {
    bvh_walk_kernel<false><<<grid, WALK_THREADS, 0, st>>>(PRISMARINE_WALK_ARGS);
  }
#undef PRISMARINE_WALK_ARGS
  return static_cast<int>(cudaGetLastError());
}
