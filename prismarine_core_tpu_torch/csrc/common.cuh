// Shared constants of the packet-query kernels.  They mirror the JAX
// package's layouts (prismarine_core_tpu/ops/pallas_intersect.py):
//   rays   f32[(nt+1)*TILE, RAY_COLS], columns [ox oy oz dx dy dz t_cap one ivx ivy ivz
//          cx cy cz .] (one and c = (o - center) x d feed only the "mxu" form)
//   planes f32[nsb+1, PLANE_ROWS, SB*BLOCK], rows [v0xyz e1xyz e2xyz valid 0...],
//          sub-block k on lanes [k*BLOCK, (k+1)*BLOCK); superblock nsb is all zero
#pragma once

#include <cuda_runtime.h>

namespace prismarine {

constexpr int TILE = 128;        // rays per tile
constexpr int BLOCK = 128;       // triangle slots per sub-block
constexpr int SB = 8;            // sub-blocks per superblock
constexpr int SB_LANES = SB * BLOCK;
constexpr int RAY_COLS = 16;
constexpr int PLANE_ROWS = 16;
constexpr int BOX_ROWS = 8;      // lo_xyz hi_xyz pad pad

constexpr int RC_OX = 0, RC_OY = 1, RC_OZ = 2;
constexpr int RC_DX = 3, RC_DY = 4, RC_DZ = 5;
constexpr int RC_TCAP = 6;
constexpr int RC_ONE = 7;
constexpr int RC_IVX = 8, RC_IVY = 9, RC_IVZ = 10;
constexpr int RC_CX = 11, RC_CY = 12, RC_CZ = 13;

constexpr int TC_V0X = 0, TC_V0Y = 1, TC_V0Z = 2;
constexpr int TC_E1X = 3, TC_E1Y = 4, TC_E1Z = 5;
constexpr int TC_E2X = 6, TC_E2Y = 7, TC_E2Z = 8;
constexpr int TC_VALID = 9;
constexpr int TC_USED = 10;      // plane rows the kernel reads

constexpr float INF_DIST = 10000.0f;
constexpr float PZERO = 0.0005f;
constexpr float DET_EPS = 1e-10f;

// Entry distance of one ray against one AABB under the packet query's
// predicate: max(tn, 0) when tf >= max(tn, 0), tn <= t_cap and t_cap > 0,
// else INF_DIST.  Same operation order as the plain version (ops/cull.py).
__device__ __forceinline__ float slab_entry(
    float ox, float oy, float oz, float ivx, float ivy, float ivz, float tc,
    float lox, float loy, float loz, float hix, float hiy, float hiz) {
  const float t0x = (lox - ox) * ivx;
  const float t1x = (hix - ox) * ivx;
  const float t0y = (loy - oy) * ivy;
  const float t1y = (hiy - oy) * ivy;
  const float t0z = (loz - oz) * ivz;
  const float t1z = (hiz - oz) * ivz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  const float tn0 = fmaxf(tn, 0.0f);
  const bool hit = (tf >= tn0) && (tn <= tc) && (tc > 0.0f);
  return hit ? tn0 : INF_DIST;
}

}  // namespace prismarine
