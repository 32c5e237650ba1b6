// Shared device helpers of the IBM kernels (spread.cu, interp.cu,
// wall_hit.cu, the binning): periodic wrap of unwrapped vertex positions and
// the corners of the trilinear stencil of hemocell_tpu_torch/ibm/coupling.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The most cell types one launch of K4 takes (its per-type table is a
// kernel parameter; ibm/kernels.py's MAX_TYPES).
#define HC_MAX_TYPES 8

namespace hc {

// Positive floating modulo: the lattice coordinate of an unwrapped position
// (positions are stored unwrapped; only lattice accesses wrap).
__device__ __forceinline__ float wrap_pos(float p, int L) {
  float r = fmodf(p, (float)L);
  if (r < 0.f) r += (float)L;
  return r;
}

__device__ __forceinline__ int wrap_idx(int i, int L) {
  i %= L;
  return i < 0 ? i + L : i;
}

// wrap_pos without its division where p already lies in [0, L) (fmodf
// returns such a p exactly): the same value, fewer instructions.
__device__ __forceinline__ float wrap_pos_fast(float p, int L) {
  return p >= 0.f && p < (float)L ? p : wrap_pos(p, L);
}

// wrap_idx for i in [0, 2L): the same value without the remainder.
__device__ __forceinline__ int wrap_once(int i, int L) { return i >= L ? i - L : i; }

// The lattice cell containing an unwrapped position (x, y, z): its corners'
// wrapped indices and trilinear weights along each axis.  Corner k is
// (ix[k >> 2 & 1], iy[k >> 1 & 1], iz[k & 1]), the reference package's
// order, with weight (wx * wy) * wz.  wrap_pos lies in [0, L], so the base
// floor(.) in [0, L] and wrap_once is wrap_idx there.
struct Corners {
  int ix[2], iy[2], iz[2];
  float wx[2], wy[2], wz[2];
};

__device__ __forceinline__ void corners(float x, float y, float z, int X, int Y, int Z,
                                        Corners& c) {
  const float px = wrap_pos_fast(x, X), py = wrap_pos_fast(y, Y), pz = wrap_pos_fast(z, Z);
  const float bx = floorf(px), by = floorf(py), bz = floorf(pz);
  const float fx = px - bx, fy = py - by, fz = pz - bz;
  c.ix[0] = wrap_once((int)bx, X);
  c.iy[0] = wrap_once((int)by, Y);
  c.iz[0] = wrap_once((int)bz, Z);
  c.ix[1] = wrap_once(c.ix[0] + 1, X);
  c.iy[1] = wrap_once(c.iy[0] + 1, Y);
  c.iz[1] = wrap_once(c.iz[0] + 1, Z);
  c.wx[0] = 1.0f - fx;
  c.wx[1] = fx;
  c.wy[0] = 1.0f - fy;
  c.wy[1] = fy;
  c.wz[0] = 1.0f - fz;
  c.wz[1] = fz;
}

}  // namespace hc
