// Shared device helpers of the IBM kernels (spread.cu, interp.cu,
// wall_hit.cu): periodic wrap of unwrapped vertex positions and the
// boundary-aware trilinear stencil of hemocell_tpu_torch/ibm/coupling.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

struct Stencil {
  long long node[8];  // flat (x*Y + y)*Z + z indices of the 2^3 cell corners
  float w[8];         // renormalised, fluid-masked, activity-scaled weights
};

// The 8 trilinear weights of the cell containing p, zeroed on non-fluid
// nodes, divided by max(total fluid weight, 1e-30) and multiplied by the
// activity mask -- coupling.stencil(pos, flags, weight_mask=act).  Corner k
// is offset (k>>2 & 1, k>>1 & 1, k & 1), the reference package's order.
__device__ __forceinline__ void trilinear_stencil(
    const float* __restrict__ p3, const uint8_t* __restrict__ flags,
    int X, int Y, int Z, float act, Stencil& s) {
  const float px = wrap_pos(p3[0], X), py = wrap_pos(p3[1], Y), pz = wrap_pos(p3[2], Z);
  const float bx = floorf(px), by = floorf(py), bz = floorf(pz);
  const float fx = px - bx, fy = py - by, fz = pz - bz;
  const int ix[2] = {wrap_idx((int)bx, X), wrap_idx((int)bx + 1, X)};
  const int iy[2] = {wrap_idx((int)by, Y), wrap_idx((int)by + 1, Y)};
  const int iz[2] = {wrap_idx((int)bz, Z), wrap_idx((int)bz + 1, Z)};
  const float wx[2] = {1.0f - fx, fx};
  const float wy[2] = {1.0f - fy, fy};
  const float wz[2] = {1.0f - fz, fz};
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = (k >> 2) & 1, b = (k >> 1) & 1, c = k & 1;
    const long long node = ((long long)ix[a] * Y + iy[b]) * Z + iz[c];
    float w = wx[a] * wy[b] * wz[c];
    if (flags[node] != 0) w = 0.f;
    s.node[k] = node;
    s.w[k] = w;
    total += w;
  }
  const float denom = fmaxf(total, 1e-30f);
#pragma unroll
  for (int k = 0; k < 8; ++k) s.w[k] = (s.w[k] / denom) * act;
}

}  // namespace hc
