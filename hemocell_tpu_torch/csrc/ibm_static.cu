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
//   (position) per vertex and NCH x 4 B of each node it touches, and writes
//   NCH x 4 B per vertex.
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
// K12's design: a thread a vertex, in vertex order, with no sort.  Three
//   launches: the slab counts of csrc/bin_vertices.cu (each tile's count of
//   each slab's vertices before it, and the overflow), then one gather.  A
//   block of the gather takes a tile of SLAB_TILE vertices, a warp a round
//   of 32, a thread a vertex.  The thread loads its position, wraps it and
//   takes its slab (the values hc::slab_of and the plain version give),
//   then issues the load of its tile's offset in that slab and the loads
//   of its 8 corners x NCH channels with 32-bit node indices (the x planes
//   are the slab g and (g + 1) mod X, y and z wrap by index, as the
//   reference's one-hot rows do), and ranks while they are in flight: the
//   warp's peers of a slab (__match_any_sync) put their number into the
//   round's row of shared memory, and a vertex's rank in its slab is the
//   tile's offset, plus its slab's counts in the tile's earlier rounds,
//   plus its lower peers (__popc), as the stable sort of the reference's
//   build_bins orders them.  rank < C keeps it.  Then it sums corner by
//   corner and writes its own row: the rows are contiguous in the vertex
//   index, and a dropped vertex's row is 0 (the TPU kernel's un-bin reads
//   another vertex's row for it; the port defines it as zero).  No sorted
//   copy of the positions, no order, no scattered rows; the rows repeat bit
//   for bit and equal those of the sorted layout this design replaced.
//   Its time follows the corner loads, a warp instruction touching up to
//   32 lines, as K3's does (PERF.md); loading a row's two z corners as one
//   aligned float4 was faster at pipeflow30's shapes and slower at the
//   suspension's, and was dropped.

#include "binned.cuh"

namespace {

struct Corners {
  int node[8];
  float w[8];
};

// The 8 periodic trilinear corners of the wrapped position (px, py, pz) in
// [0, X] x [0, Y] x [0, Z], in slab g.
__device__ __forceinline__ void static_corners(float px, float py, float pz, int g, int X,
                                               int Y, int Z, Corners& s) {
  const float by = floorf(py), bz = floorf(pz);
  const float fx = px - floorf(px), fy = py - by, fz = pz - bz;
  const int ix[2] = {g, g + 1 == X ? 0 : g + 1};
  const int iy[2] = {hc::wrap_once((int)by, Y), hc::wrap_once((int)by + 1, Y)};
  const int iz[2] = {hc::wrap_once((int)bz, Z), hc::wrap_once((int)bz + 1, Z)};
  const float wx[2] = {1.0f - fx, fx};
  const float wy[2] = {1.0f - fy, fy};
  const float wz[2] = {1.0f - fz, fz};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = (k >> 2) & 1, b = (k >> 1) & 1, c = k & 1;
    s.node[k] = (ix[a] * Y + iy[b]) * Z + iz[c];
    s.w[k] = wx[a] * wy[b] * wz[c];
  }
}

// One block a tile of SLAB_TILE vertices, a warp a round of 32, a thread a
// vertex.  `tilehist` [X, nt]: the count of slab g's vertices in the tiles
// before tile t (the slab counts' scan).
__global__ void __launch_bounds__(hc::SLAB_TILE)
    interp_static_kernel(const float* __restrict__ u, const float* __restrict__ pos,
                         const int* __restrict__ tilehist, int P, int nt, int C, int NCH,
                         float* __restrict__ out, int X, int Y, int Z) {
  extern __shared__ int before[];  // [SLAB_ROUNDS - 1, X]: each round's count a slab
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int t = blockIdx.x;
  const long long p = (long long)t * hc::SLAB_TILE + threadIdx.x;
  const bool valid = p < P;
  for (int i = threadIdx.x; i < (hc::SLAB_ROUNDS - 1) * X; i += blockDim.x) before[i] = 0;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    px = hc::wrap_pos_fast(__ldg(pos + 3 * p), X);
    py = hc::wrap_pos_fast(__ldg(pos + 3 * p + 1), Y);
    pz = hc::wrap_pos_fast(__ldg(pos + 3 * p + 2), Z);
  }
  const int g = valid ? hc::wrap_once((int)floorf(px), X) : -1;
  // the tile's offset in the slab and the corners' values, all in flight
  // while the block ranks
  const int first = valid ? __ldg(tilehist + (long long)g * nt + t) : 0;
  Corners s;
  static_corners(px, py, pz, valid ? g : 0, X, Y, Z, s);
  const long long N = (long long)X * Y * Z;
  float v[8][4];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) v[k][ch] = ch < NCH ? __ldg(u + ch * N + s.node[k]) : 0.f;
  // the rank in the slab: the rounds before this one, then the lower peers
  const unsigned peers = __match_any_sync(hc::FULL, g);
  __syncthreads();
  if (valid && r < hc::SLAB_ROUNDS - 1 && lane == __ffs(peers) - 1)
    before[r * X + g] = __popc(peers);
  __syncthreads();
  int rank = first + __popc(peers & ((1u << lane) - 1u));
  for (int q = 0; q < r; ++q) rank += valid ? before[q * X + g] : 0;
  if (!valid) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float wk = s.w[k];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) acc[ch] += wk * v[k][ch];
  }
  const bool kept = rank < C;
  float* row = out + p * NCH;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch)
    if (ch < NCH) row[ch] = kept ? acc[ch] : 0.f;
}

int blocks_for(long long n, int per) { return (int)((n + per - 1) / per); }

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
  const hc::Tiles t = hc::gather_tiles(X, Y, Z);
  const hc::TileBins tb =
      hc::tile_bins_carve((int*)scratch + hc::slab_bins_ints(P, X), P, X, Y, Z);
  int err = hc::slab_bins((const float*)pos, (const float*)force, P, X, Y, Z, C, sb,
                          (long long*)overflow, (float4*)rec, s);
  if (!err) err = hc::tile_bins_count_records((const float4*)rec, P, X, Y, Z, t, tb, s);
  if (!err) err = hc::tile_bins_place(tb, P, t, s);
  if (!err) err = hc::tile_gather((const float4*)rec, tb, (float*)out, X, Y, Z, t, {}, s);
  return err;
}

// u [NCH, X, Y, Z] f32 (1 <= NCH <= 4); pos [P, 3] f32 (unwrapped); out
// [P, NCH] f32 (every row written); overflow int64; scratch
// hc_slab_bins_ints(P, X) int32 words, zero before the first call (and left
// so by every call).  X * Y * Z < 2^31.
extern "C" int hc_interp_static(const void* u, const void* pos, int C, int NCH, void* out,
                                void* overflow, void* scratch, int P, int X, int Y, int Z,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const hc::SlabBins sb = hc::slab_bins_carve((int*)scratch, P, X);
  int err = hc::slab_counts((const float*)pos, P, X, C, sb, (long long*)overflow, s);
  const int nt = blocks_for(P, hc::SLAB_TILE);
  const int smem = (hc::SLAB_ROUNDS - 1) * X * (int)sizeof(int);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(interp_static_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  if (!err && nt > 0)
    interp_static_kernel<<<nt, hc::SLAB_TILE, smem, s>>>(
        (const float*)u, (const float*)pos, sb.tilehist, P, nt, C, NCH, (float*)out, X, Y, Z);
  return err ? err : (int)cudaGetLastError();
}
