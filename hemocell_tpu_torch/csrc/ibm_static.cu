// K11 and K12: binned (static-capacity) periodic trilinear spread and
// interpolation.
//
// Replaces: hemocell_tpu/ibm/pallas_ibm.py::pallas_spread_static
//   (_spread_static_kernel) and ::pallas_interp_static
//   (_interp_static_kernel).  Compute spread_static_plain and
//   interp_static_plain of hemocell_tpu_torch/ibm/static.py, the plain
//   versions: pure periodic trilinear weights (no wall mask, no
//   renormalisation, no cap) of the vertices that lie within the capacity C
//   of their x-slab.
//
// Input layout (built in PyTorch by ibm/static.build_bins): the wrapped
//   positions sorted by slab, stably, and starts[X+1]; slab g holds the
//   sorted rows starts[g] .. starts[g+1]-1, and the first C of them are its
//   slots.  A vertex past its slab's capacity has no slot: K11 drops it and
//   K12 writes it a zero row (the TPU kernel's un-bin reads another
//   vertex's row for it; the port defines it as zero).
//
// Bound on the H100: bytes.  K11 reads 24 B per kept vertex (position and
//   force, in slab order) and writes the [3, X, Y, Z] field; each vertex
//   makes 24 f32 atomicAdds into L2.  K12 reads 12 B (position) and 4 B
//   (its original index) per vertex and NCH x 4 B of each node it touches,
//   and writes NCH x 4 B per vertex.
//
// Design: one thread per slot (g, c), X * C threads.  A slot past its
//   slab's count returns at once.  The x planes are the slab g and
//   (g + 1) mod X (the periodic wrap of the last slab), y and z wrap by
//   index, as the reference's one-hot rows do.  K11 atomically adds the 8 x
//   3 deposits into a zeroed field, so the last bits of the field vary from
//   run to run.  K12 gathers 8 corners x NCH channels and writes the row of
//   the vertex's original index (through `order`): no atomics, so it is
//   deterministic; the last slot of an overfull slab writes the zero rows
//   of that slab's dropped vertices.
//
// Later work (the K2 redesign shares it): with the vertices binned by
//   slab, one CTA per slab (or (x, y) tile) can accumulate its two planes
//   in shared memory and write them once, with no global atomics, and K12
//   can stage its two planes of u in shared memory instead of gathering
//   through L2.

#include "ibm_stencil.cuh"

namespace {

struct Corners {
  long long node[8];
  float w[8];
};

// The 8 periodic trilinear corners of the sorted row `r` of slab `g`.
__device__ __forceinline__ void static_corners(const float* __restrict__ p3, int g, int X,
                                               int Y, int Z, Corners& s) {
  const float px = p3[0], py = p3[1], pz = p3[2];
  const float by = floorf(py), bz = floorf(pz);
  const float fx = px - floorf(px), fy = py - by, fz = pz - bz;
  const int ix[2] = {g, g + 1 == X ? 0 : g + 1};
  const int iy[2] = {hc::wrap_idx((int)by, Y), hc::wrap_idx((int)by + 1, Y)};
  const int iz[2] = {hc::wrap_idx((int)bz, Z), hc::wrap_idx((int)bz + 1, Z)};
  const float wx[2] = {1.0f - fx, fx};
  const float wy[2] = {1.0f - fy, fy};
  const float wz[2] = {1.0f - fz, fz};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = (k >> 2) & 1, b = (k >> 1) & 1, c = k & 1;
    s.node[k] = ((long long)ix[a] * Y + iy[b]) * Z + iz[c];
    s.w[k] = wx[a] * wy[b] * wz[c];
  }
}

__global__ void spread_static_kernel(const float* __restrict__ pos_s,
                                     const float* __restrict__ force_s,
                                     const int* __restrict__ starts, int C,
                                     float* __restrict__ out, int X, int Y, int Z) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)X * C) return;
  const int g = (int)(t / C), c = (int)(t % C);
  const int r = starts[g] + c;
  if (r >= starts[g + 1]) return;  // an empty slot
  Corners s;
  static_corners(pos_s + 3 * (long long)r, g, X, Y, Z, s);
  const float fx = force_s[3 * (long long)r], fy = force_s[3 * (long long)r + 1],
              fz = force_s[3 * (long long)r + 2];
  const long long N = (long long)X * Y * Z;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = s.w[k];
    if (w == 0.f) continue;
    atomicAdd(out + s.node[k], w * fx);
    atomicAdd(out + N + s.node[k], w * fy);
    atomicAdd(out + 2 * N + s.node[k], w * fz);
  }
}

__global__ void interp_static_kernel(const float* __restrict__ u,
                                     const float* __restrict__ pos_s,
                                     const int* __restrict__ order,
                                     const int* __restrict__ starts, int C, int NCH,
                                     float* __restrict__ out, int X, int Y, int Z) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)X * C) return;
  const int g = (int)(t / C), c = (int)(t % C);
  const int r = starts[g] + c, end = starts[g + 1];
  if (c == C - 1) {
    // the vertices past this slab's capacity interpolate to 0
    for (int d = starts[g] + C; d < end; ++d)
      for (int ch = 0; ch < NCH; ++ch) out[(long long)order[d] * NCH + ch] = 0.f;
  }
  if (r >= end) return;  // an empty slot
  Corners s;
  static_corners(pos_s + 3 * (long long)r, g, X, Y, Z, s);
  const long long N = (long long)X * Y * Z;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = s.w[k];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      if (ch < NCH) acc[ch] += w * u[ch * N + s.node[k]];
  }
  const long long row = (long long)order[r] * NCH;
  for (int ch = 0; ch < NCH; ++ch) out[row + ch] = acc[ch];
}

int blocks_for(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

}  // namespace

// pos_s / force_s [P, 3] f32 in slab order, starts [X + 1] int32; out a
// zeroed [3, X, Y, Z] f32.
extern "C" int hc_spread_static(const void* pos_s, const void* force_s, const void* starts,
                                int C, void* out, int X, int Y, int Z, void* stream) {
  const long long slots = (long long)X * C;
  if (slots > 0) {
    const int threads = 256;
    spread_static_kernel<<<blocks_for(slots, threads), threads, 0, (cudaStream_t)stream>>>(
        (const float*)pos_s, (const float*)force_s, (const int*)starts, C, (float*)out, X, Y,
        Z);
  }
  return (int)cudaGetLastError();
}

// u [NCH, X, Y, Z] f32 (1 <= NCH <= 4); pos_s [P, 3] f32 in slab order; order
// [P] int32 (sorted row -> vertex); starts [X + 1] int32; out [P, NCH] f32.
extern "C" int hc_interp_static(const void* u, const void* pos_s, const void* order,
                                const void* starts, int C, int NCH, void* out, int X, int Y,
                                int Z, void* stream) {
  const long long slots = (long long)X * C;
  if (slots > 0) {
    const int threads = 256;
    interp_static_kernel<<<blocks_for(slots, threads), threads, 0, (cudaStream_t)stream>>>(
        (const float*)u, (const float*)pos_s, (const int*)order, (const int*)starts, C, NCH,
        (float*)out, X, Y, Z);
  }
  return (int)cudaGetLastError();
}
