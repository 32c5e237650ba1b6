// K11 and K12: binned (static-capacity) periodic trilinear spread and
// interpolation.
//
// Replaces: hemocell_tpu/ibm/pallas_ibm.py::pallas_spread_static
//   (_spread_static_kernel) and ::pallas_interp_static
//   (_interp_static_kernel).  Compute spread_static_plain and
//   interp_static_plain of hemocell_tpu_torch/ibm/static.py, the plain
//   versions: pure periodic trilinear weights (no wall mask, no
//   renormalisation, no cap) of the vertices that lie within the capacity C
//   of their x-slab, the first C of the slab in vertex order.
//
// Bound on the H100: bytes.  K11 reads 24 B per vertex (position and
//   force) and writes the [3, X, Y, Z] field once.  K12 reads 12 B
//   (position) and 4 B (its original index) per vertex and NCH x 4 B of each
//   node it touches, and writes NCH x 4 B per vertex.
//
// K11's design: K2's deterministic binned spread (binned.cuh) with the slab
//   bins in front.  One entry makes every launch: the slab bins rank each
//   vertex in its slab in vertex order, so rank < C is the kept mask, and
//   write the records (activity 1 if kept, else 0; the force as it is);
//   then the tile count and placement of the kept vertices and the tile
//   gather of csrc/spread.cu with pure weights, which sums in fixed point
//   and writes each node of the field once.  No float atomics, no zeroing
//   pass, no empty slots: the field repeats bit for bit.  The overflow is
//   the sum over slabs of the count past C.
//
// K12's layout (the slab bins of csrc/bin_vertices.cu, hc_bin_slabs): the
//   wrapped positions sorted by slab, stably, order[P] and starts[X+1];
//   slab g holds the sorted rows starts[g] .. starts[g+1]-1, and the first
//   C of them are its slots.  A vertex past its slab's capacity has no
//   slot: K12 writes it a zero row (the TPU kernel's un-bin reads another
//   vertex's row for it; the port defines it as zero).  One thread per slot
//   (g, c), X * C threads; a slot past its slab's count returns at once.
//   The x planes are the slab g and (g + 1) mod X, y and z wrap by index, as
//   the reference's one-hot rows do.  K12 gathers 8 corners x NCH channels
//   and writes the row of the vertex's original index (through `order`):
//   deterministic; the last slot of an overfull slab writes the zero rows
//   of that slab's dropped vertices.

#include "binned.cuh"

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

// pos / force [P, 3] f32 (positions unwrapped); out [3, X, Y, Z] f32 (every
// node written); overflow int64; scratch hc_static_scratch_ints(P, X, Y, Z)
// int32 words, zero before the first call (and left so by every call);
// rec [2 * P] float4.
extern "C" long long hc_static_scratch_ints(int P, int X, int Y, int Z) {
  return hc::slab_bins_ints(P, X) + hc::tile_bins_ints(P, X, Y, Z);
}

extern "C" int hc_spread_static(const void* pos, const void* force, int C, void* out,
                                void* overflow, void* scratch, void* rec, int P, int X, int Y,
                                int Z, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const hc::SlabBins sb = hc::slab_bins_carve((int*)scratch, P, X);
  const hc::TileBins tb =
      hc::tile_bins_carve((int*)scratch + hc::slab_bins_ints(P, X), P, X, Y, Z);
  int err = hc::slab_bins((const float*)pos, (const float*)force, P, X, Y, Z, C, sb,
                          (long long*)overflow, nullptr, nullptr, (float4*)rec, s);
  if (!err) err = hc::tile_bins_count_records((const float4*)rec, P, X, Y, Z, tb, s);
  if (!err) err = hc::tile_bins_place(tb, (const float4*)rec, P, X, Y, Z, s);
  if (!err) err = hc::tile_gather((const float4*)rec, tb, (float*)out, X, Y, Z, s);
  return err;
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
