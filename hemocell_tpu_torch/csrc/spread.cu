// K2: boundary-aware trilinear spread of capped vertex forces, as a
// deterministic binned spread.
//
// Replaces: the spread half of hemocell_tpu/ibm/pallas_ibm.py
//   ::pallas_spread_shadow (_spread_renorm_hit_kernel, _spread_renorm_kernel)
//   and ::pallas_spread (_spread_renorm_kernel, _spread_kernel).  Computes
//   coupling.spread(cap_force(F) + F_extra,
//                   *coupling.stencil(wrap(pos), flags, act))
//   of hemocell_tpu_torch/ibm/coupling.py, the plain version.  F_extra is
//   the optional uncapped repulsion force, added after the cap; a uniform
//   body force may be added to the field.
//
// Bound on the H100: bytes.  The function reads 28 B per vertex (position,
//   force, activity; 40 B with the uncapped extra force) plus the flags of
//   the touched nodes and writes the [3, X, Y, Z] field once.  In practice
//   the tile gather waits on each block's chain of loads (the tile's
//   starts, its list, its records: 60% of its time at 256^3 with no
//   deposit summed), then on its eight lanes a listed vertex, and on its
//   heaviest tiles.
//
// Design (binned.cuh): three launches a call, none sweeping the tiles a
//   block.  The counting kernel (csrc/bin_vertices.cu) gives each vertex a
//   32-byte record: its wrapped position, its weight scale act / max(total
//   fluid weight, 1e-30), its force capped at f_limit plus the extra force,
//   and the fluid mask of its 8 nodes; it enters each live vertex in every
//   near-cubic tile of the field its stencil reaches, taking its place in
//   each list with integer atomics (a block's or a warp's entries of a tile
//   with one global atomic), and its last block scans the counts once into
//   the lists' starts and sets the fixed-point scale.  The placement writes
//   each live vertex into its tiles' lists at those places.  Then one block
//   per tile stages its listed records in shared memory, rounds each
//   deposit on one of its fluid nodes to a 64-bit fixed-point integer, sums
//   them there with integer atomics and writes each node once, plus the
//   uniform body force where one is given (the single-device step's, which
//   saves a pass of 402 MB over the field at 256^3); a non-fluid
//   node gets no deposit and stores 0 (plus the body force), which is the
//   destination masking of the reference (a vertex whose 8 nodes are all
//   solid deposits nothing).  Integer sums are the same in any order: the
//   field repeats bit for bit, with no float atomics and no zeroing pass,
//   and equals that of any other tiling.  Each deposit rounds to the fixed
//   point within 2^-31 of the largest one, below f32's rounding.  The TPU's
//   one-hot MXU contractions, slab windows and overflow counter have no
//   analog.

#include "binned.cuh"

namespace hc {
namespace {

constexpr int TILE_THREADS = 512;
constexpr int STAGE = TILE_THREADS;  // listed records a block stages at a time, one a thread

// One block per tile: the fixed-point sums of the deposits on the tile's
// nodes in shared memory, then each node written once (plus the body
// force).  Eight lanes take a listed vertex, one corner each; the node loop
// runs a thread a node, z fastest.
__global__ void __launch_bounds__(TILE_THREADS, 2)
    tile_gather_kernel(const float4* __restrict__ rec, TileBins tb, float* __restrict__ out,
                       int X, int Y, int Z, Tiles t, BodyForce bf) {
  extern __shared__ int smem[];
  const int W = t.words;
  int* lo = smem;          // [3][W] signed low words of the sums
  int* hi = smem + 3 * W;  // [3][W] their wraps
  const int tile = blockIdx.x;
  const int tz_ = tile % t.nz, ty_ = (tile / t.nz) % t.ny, tx_ = tile / (t.nz * t.ny);
  const int x0 = tx_ * t.tx, y0 = ty_ * t.ty, z0 = tz_ * t.tz;
  const int ex = min(t.tx, X - x0), ey = min(t.ty, Y - y0), ez = min(t.tz, Z - z0);
  // [2 * STAGE] records, 16-byte aligned after the sums
  float4* stage = reinterpret_cast<float4*>(smem + ((6 * W + 3) & ~3));
  const int first = tb.starts[tile], end = tb.starts[tile + 1];
  const double scale = *tb.scale;
  // the first chunk's list entries in flight while the sums are zeroed
  long long p = first + (int)threadIdx.x < end ? tb.list[first + threadIdx.x] : 0;
  for (int i = threadIdx.x; i < 6 * W; i += blockDim.x) smem[i] = 0;
  // the float path gives the same integers where the scale is a float
  const float fscale = (float)scale;
  const bool in_float = scale >= 1.17549435e-38 && scale <= 3.40282347e38;
  const int c = threadIdx.x & 7, a = (c >> 2) & 1, b = (c >> 1) & 1, cc = c & 1;
  for (int c0 = first; c0 < end; c0 += STAGE) {
    // the chunk's records into shared memory (a thread a record), then the
    // next chunk's list entries in flight while this one is summed
    const int n = min(STAGE, end - c0);
    __syncthreads();
    if ((int)threadIdx.x < n) {
      stage[2 * threadIdx.x] = __ldg(rec + 2 * p);
      stage[2 * threadIdx.x + 1] = __ldg(rec + 2 * p + 1);
    }
    const int k1 = c0 + STAGE + threadIdx.x;
    p = k1 < end ? tb.list[k1] : 0;
    __syncthreads();

    for (int k = threadIdx.x >> 3; k < n; k += blockDim.x >> 3) {
      const float4 A = stage[2 * k], B = stage[2 * k + 1];
      if (!((__float_as_int(B.w) >> c) & 1)) continue;  // a solid corner
      int bx, by, bz;
      base_of(A.x, A.y, A.z, X, Y, Z, bx, by, bz);
      const int ox = (a ? (bx + 1 == X ? 0 : bx + 1) : bx) - x0;
      const int oy = (b ? (by + 1 == Y ? 0 : by + 1) : by) - y0;
      const int oz = (cc ? (bz + 1 == Z ? 0 : bz + 1) : bz) - z0;
      if (ox < 0 || ox >= ex || oy < 0 || oy >= ey || oz < 0 || oz >= ez) continue;
      const float fx = A.x - floorf(A.x), fy = A.y - floorf(A.y), fz = A.z - floorf(A.z);
      const float ws =
          ((a ? fx : 1.0f - fx) * (b ? fy : 1.0f - fy)) * (cc ? fz : 1.0f - fz) * A.w;
      const int local = ox * t.sx + oy * t.sy + oz;
      const float F[3] = {B.x, B.y, B.z};
      // |q| < 2^30: the three atomics in flight together, then the thread
      // whose addition wrapped a low word carries the wrap into its high word
      int q[3], old[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        q[d] = in_float ? __float2int_rn(ws * F[d] * fscale)
                        : (int)__double2ll_rn((double)(ws * F[d]) * scale);
        old[d] = atomicAdd(lo + d * W + local, q[d]);
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const long long sum = (long long)old[d] + q[d];
        if (sum > 2147483647LL) atomicAdd(hi + d * W + local, 1);
        else if (sum < -2147483648LL) atomicAdd(hi + d * W + local, -1);
      }
    }
  }
  float add[3] = {0.f, 0.f, 0.f};
  if (bf.mode == 1) {
    add[0] = bf.v[0]; add[1] = bf.v[1]; add[2] = bf.v[2];
  } else if (bf.mode == 2) {
    add[0] = __ldg(bf.dev); add[1] = __ldg(bf.dev + 1); add[2] = __ldg(bf.dev + 2);
  }
  __syncthreads();
  const double inv = 1.0 / scale;  // a power of two: exact
  const long long N = (long long)X * Y * Z;
  const int ncol = ex * ey;
  for (int i = threadIdx.x; i < ncol * ez; i += blockDim.x) {
    const int col = i / ez, oz = i - col * ez;
    const int ox = col / ey, oy = col - ox * ey;
    const long long node = ((long long)(x0 + ox) * Y + (y0 + oy)) * Z + z0 + oz;
    const int local = ox * t.sx + oy * t.sy + oz;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int j = d * W + local;
      const float v = (float)((double)((long long)hi[j] * 4294967296LL + lo[j]) * inv);
      out[d * N + node] = bf.mode ? __fadd_rn(v, add[d]) : v;
    }
  }
}

}  // namespace

int tile_gather(const float4* rec, const TileBins& tb, float* out, int X, int Y, int Z,
                const Tiles& t, const BodyForce& bf, cudaStream_t s) {
  const int smem = ((6 * t.words + 3) & ~3) * (int)sizeof(int) + STAGE * 2 * (int)sizeof(float4);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(tile_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const long long grid = (long long)t.nx * t.ny * t.nz;
  if (grid > 0)
    tile_gather_kernel<<<(int)grid, TILE_THREADS, smem, s>>>(rec, tb, out, X, Y, Z, t, bf);
  return (int)cudaGetLastError();
}

}  // namespace hc

// out [3, X, Y, Z] f32 (every node written); pos/force [P, 3] f32, active
// [P] f32; force_extra [P, 3] f32 or null; scratch hc_tile_bins_ints(P, X,
// Y, Z) int32 words, zero before the first call (and left so by every
// call); rec [2 * P] float4.  bf_mode 0: no body force; 1: (bx, by, bz)
// added to every node; 2: the float [3] at bf_dev (device memory) added.
extern "C" int hc_spread(const void* pos, const void* force, const void* force_extra,
                         const void* active, const void* flags, float f_limit, void* out,
                         void* scratch, void* rec, int bf_mode, float bx, float by, float bz,
                         const void* bf_dev, int P, int X, int Y, int Z, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const hc::Tiles t = hc::gather_tiles(X, Y, Z);
  const hc::TileBins tb = hc::tile_bins_carve((int*)scratch, P, X, Y, Z);
  const hc::BodyForce bf{bf_mode, {bx, by, bz}, (const float*)bf_dev};
  int err = hc::tile_bins_count_k2((const float*)pos, (const float*)force,
                                   (const float*)force_extra, (const float*)active,
                                   (const uint8_t*)flags, f_limit, P, X, Y, Z, t, tb,
                                   (float4*)rec, s);
  if (!err) err = hc::tile_bins_place(tb, P, t, s);
  if (!err) err = hc::tile_gather((const float4*)rec, tb, (float*)out, X, Y, Z, t, bf, s);
  return err;
}
