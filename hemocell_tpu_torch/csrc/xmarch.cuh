// The pieces of the x-marching D3Q19 kernels, shared by K10 (one step,
// stream_collide_2d.cu) and K8/K9 (k fused steps, stream_collide_kx.cu):
// cp.async staging, and the ring of collided planes with its store and its
// pull.
//
// A block owns a (y, z) tile and marches along x.  The nodes of a padded
// (y, z) plane of width W (z fastest) are collided one a thread by
// d3q19::collide_node, and the post-collision populations go into the ring
// (ring_store).  A node of plane p is then streamed by PULLING population q
// from its neighbour at -c_q (ring_pull): c_x = +1 from plane p - 1, 0 from
// plane p and -1 from plane p + 1.  Both kernels collide with the same
// function on the same operands and only move the results, so each equals
// K1, which pushes, bit for bit.
//
// The ring keeps each population of a collided plane only as long as the
// pull needs it: plane p is pulled with the populations of c_x = +1 from
// plane p - 1, of c_x = 0 from plane p and of c_x = -1 from plane p + 1,
// while the next plane, p + 2, is collided into the ring after the pull.
// So the c_x = -1 populations (5) of the plane just collided take one slot,
// the c_x = 0 ones (9) two (planes p, p + 1) and the c_x = +1 ones (5)
// three (p - 1, p, p + 1): 38 population planes where three whole planes
// take 57.  Plane indices p passed here must be >= 1 (the pull reads p - 1).

#pragma once

#include <stdint.h>

#include "d3q19_collide.cuh"

namespace xmarch {

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kRingPlanes = 5 + 2 * 9 + 3 * 5;

// q's index among the populations of its c_x, beside D3Q19_TABLES
#define XMARCH_SUB const int kSub[19] = {0, 0, 0, 1, 2, 3, 4, 1, 1, 2, 2, 3, 3, 4, 4, 5, 6, 7, 8};

// the ring's population plane of population q (c_x = cx, index sub among
// those of its c_x) of plane p
__device__ __forceinline__ int ring_plane(int cx, int sub, int p) {
  return cx < 0 ? sub : (cx == 0 ? 5 + (p & 1) * 9 + sub : 23 + (p % 3) * 5 + sub);
}

// the post-collision populations res of node n of plane p into the ring of
// P nodes a population plane
__device__ __forceinline__ void ring_store(float* ring, int P, int p, int n,
                                           const float (&res)[19]) {
  D3Q19_TABLES
  XMARCH_SUB
#pragma unroll
  for (int q = 0; q < 19; ++q) ring[ring_plane(kCX[q], kSub[q], p) * P + n] = res[q];
}

// the populations that stream into node m of plane p (row width W): h_q is
// population q of the node at m - (c_y W + c_z) of plane p - c_x
__device__ __forceinline__ void ring_pull(const float* ring, int P, int W, int p, int m,
                                          float (&h)[19]) {
  D3Q19_TABLES
  XMARCH_SUB
#pragma unroll
  for (int q = 0; q < 19; ++q)
    h[q] = ring[ring_plane(kCX[q], kSub[q], p - kCX[q]) * P + m - (kCY[q] * W + kCZ[q])];
}

}  // namespace xmarch
