// K2: boundary-aware trilinear spread of capped vertex forces, as a
// deterministic binned spread.
//
// Replaces: the spread half of hemocell_tpu/ibm/pallas_ibm.py
//   ::pallas_spread_shadow (_spread_renorm_hit_kernel, _spread_renorm_kernel)
//   and ::pallas_spread (_spread_renorm_kernel, _spread_kernel).  Computes
//   coupling.spread(cap_force(F) + F_extra,
//                   *coupling.stencil(wrap(pos), flags, act))
//   of hemocell_tpu_torch/ibm/coupling.py, the plain version.  F_extra is
//   the optional uncapped repulsion force, added after the cap.
//
// Bound on the H100: bytes.  The function reads 28 B per vertex (position,
//   force, activity; 40 B with the uncapped extra force) plus the flags of
//   the touched nodes and writes the [3, X, Y, Z] field once.  In practice
//   the tile gather is bound by shared-memory atomics (about one lane a
//   clock on an SM) and by its heaviest tiles.
//
// Design (binned.cuh): the counting kernel (csrc/bin_vertices.cu) gives
//   each vertex a 32-byte record: its wrapped position, its weight scale
//   act / max(total fluid weight, 1e-30), its force capped at f_limit plus
//   the extra force, and the fluid mask of its 8 nodes; each live vertex is
//   entered in the list of every tile of the field its stencil reaches.
//   Then one block per tile stages its listed records in shared memory,
//   rounds each deposit on one of its fluid nodes to a 64-bit fixed-point
//   integer, sums them there with integer atomics and writes each node
//   once; a non-fluid node gets no deposit and stores 0, which is the
//   destination masking of the reference (a vertex whose 8 nodes are all
//   solid deposits nothing).  Integer sums are the same in any order: the
//   field repeats bit for bit, with no float atomics and no zeroing pass.
//   Each deposit rounds to the fixed point within 2^-31 of the largest one,
//   below f32's rounding.  The TPU's one-hot MXU contractions, slab
//   windows and overflow counter have no analog.  One entry makes all
//   three launches: count, placement, tile gather.

#include "binned.cuh"

namespace hc {
namespace {

constexpr int TILE_THREADS = 512;
constexpr int STAGE = 512;  // listed records a block stages in shared memory at a time

// One block per tile: the fixed-point sums of the deposits on the tile's
// nodes in shared memory, then each node written once.  Eight lanes take a
// listed vertex, one corner each; the node loops run a warp per (x, y)
// column and a lane per z.
__global__ void __launch_bounds__(TILE_THREADS, 2)
    tile_gather_kernel(const float4* __restrict__ rec, TileBins tb, float* __restrict__ out,
                       int X, int Y, int Z, Tiles t) {
  extern __shared__ int smem[];
  const int TN = t.tx * t.ty * t.tz;
  int* lo = smem;           // [3][TN] signed low words of the sums
  int* hi = smem + 3 * TN;  // [3][TN] their wraps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int tile = blockIdx.x;
  const int tz_ = tile % t.nz, ty_ = (tile / t.nz) % t.ny, tx_ = tile / (t.nz * t.ny);
  const int x0 = tx_ * t.tx, y0 = ty_ * t.ty, z0 = tz_ * t.tz;
  const int ex = min(t.tx, X - x0), ey = min(t.ty, Y - y0), ez = min(t.tz, Z - z0);
  // [2 * STAGE] records, 16-byte aligned after the sums
  float4* stage = reinterpret_cast<float4*>(smem + ((6 * TN + 3) & ~3));
  for (int i = threadIdx.x; i < 6 * TN; i += blockDim.x) smem[i] = 0;
  const double scale = *tb.scale;
  // the float path gives the same integers where the scale is a float
  const float fscale = (float)scale;
  const bool in_float = scale >= 1.17549435e-38 && scale <= 3.40282347e38;
  const int c = threadIdx.x & 7, a = (c >> 2) & 1, b = (c >> 1) & 1, cc = c & 1;
  const int first = tb.starts[tile], end = tb.starts[tile + 1];
  for (int c0 = first; c0 < end; c0 += STAGE) {
    // the chunk's records into shared memory, all loads in flight together
    const int n = min(STAGE, end - c0);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const long long p = tb.list[c0 + k];
      stage[2 * k] = __ldg(rec + 2 * p);
      stage[2 * k + 1] = __ldg(rec + 2 * p + 1);
    }
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
      const int local = (ox * t.ty + oy) * t.tz + oz;
      const float F[3] = {B.x, B.y, B.z};
      // |q| < 2^30: the three atomics in flight together, then the thread
      // whose addition wrapped a low word carries the wrap into its high word
      int q[3], old[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        q[d] = in_float ? __float2int_rn(ws * F[d] * fscale)
                        : (int)__double2ll_rn((double)(ws * F[d]) * scale);
        old[d] = atomicAdd(lo + d * TN + local, q[d]);
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const long long sum = (long long)old[d] + q[d];
        if (sum > 2147483647LL) atomicAdd(hi + d * TN + local, 1);
        else if (sum < -2147483648LL) atomicAdd(hi + d * TN + local, -1);
      }
    }
  }
  __syncthreads();
  const double inv = 1.0 / scale;  // a power of two: exact
  const long long N = (long long)X * Y * Z;
  for (int col = warp; col < ex * ey; col += nwarps) {
    const int ox = col / ey, oy = col - ox * ey;
    const long long node0 = ((long long)(x0 + ox) * Y + (y0 + oy)) * Z + z0;
    const int local0 = (ox * t.ty + oy) * t.tz;
    for (int oz = lane; oz < ez; oz += 32) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int i = d * TN + local0 + oz;
        out[d * N + node0 + oz] =
            (float)((double)((long long)hi[i] * 4294967296LL + lo[i]) * inv);
      }
    }
  }
}

}  // namespace

int tile_gather(const float4* rec, const TileBins& tb, float* out, int X, int Y, int Z,
                cudaStream_t s) {
  const Tiles t = gather_tiles(X, Y, Z);
  const int smem = ((t.smem / 4 + 3) & ~3) * 4 + STAGE * 2 * (int)sizeof(float4);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(tile_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const long long grid = (long long)t.nx * t.ny * t.nz;
  if (grid > 0)
    tile_gather_kernel<<<(int)grid, TILE_THREADS, smem, s>>>(rec, tb, out, X, Y, Z, t);
  return (int)cudaGetLastError();
}

}  // namespace hc

// out [3, X, Y, Z] f32 (every node written); pos/force [P, 3] f32, active
// [P] f32; force_extra [P, 3] f32 or null; scratch hc_tile_bins_ints(P, X,
// Y, Z) int32 words, zero before the first call (and left so by every
// call); rec [2 * P] float4.
extern "C" int hc_spread(const void* pos, const void* force, const void* force_extra,
                         const void* active, const void* flags, float f_limit, void* out,
                         void* scratch, void* rec, int P, int X, int Y, int Z, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const hc::TileBins tb = hc::tile_bins_carve((int*)scratch, P, X, Y, Z);
  int err = hc::tile_bins_count_k2((const float*)pos, (const float*)force,
                                   (const float*)force_extra, (const float*)active,
                                   (const uint8_t*)flags, f_limit, P, X, Y, Z, tb,
                                   (float4*)rec, s);
  if (!err) err = hc::tile_bins_place(tb, (const float4*)rec, P, X, Y, Z, s);
  if (!err) err = hc::tile_gather((const float4*)rec, tb, (float*)out, X, Y, Z, s);
  return err;
}
