// The deterministic binned spread shared by K2 (csrc/spread.cu) and K11
// (csrc/ibm_static.cu), and the x-slab counts of K11 and K12.
//
// The field is cut into tiles of TX x TY x TZ nodes (gather_tiles).
//
// Tile bins (csrc/bin_vertices.cu): each live vertex is entered in the
//   list of every tile that one of the 8 nodes of its stencil lies in (1 to
//   8 tiles, most often 1).  The counting kernel writes each vertex's
//   32-byte record in vertex order (wrapped position, weight scale, force,
//   fluid mask of its 8 corners: K2 reads the flags here, once) and
//   counts it into its tiles: integer atomics in shared memory give its
//   slot within the block, then one global atomic per tile and block gives
//   the block's base (tile counters are few and hot: one atomic per vertex
//   would queue at them).  It also takes the largest |deposit| a vertex can
//   make (a block max, then one integer atomicMax of the float's bits).
//   The placement kernel's blocks each scan the tile counts (they are few)
//   and write their vertices into their tiles' lists; its first block sets
//   the fixed-point scale 2^(30 - e), with 2^e above that bound: a deposit
//   rounds to an integer below 2^30 in magnitude, its rounding error is at
//   most 2^-31 of the bound.
//
// Tile gather (csrc/spread.cu): one block per tile, holding the tile's
//   [3, TX*TY*TZ] sums in shared memory as 64-bit integers (a signed low
//   32-bit word and a high word that takes the low word's rare wraps: the
//   thread whose atomic wrapped the low word adds +-1 to the high one).  It
//   stages its listed records in shared memory and walks them, eight lanes
//   per vertex, one per corner: the corner's weight times the record's
//   scale, on a fluid corner in the tile, times the force rounds to an
//   integer at the fixed-point scale and is added there.  Then it writes
//   every node of the tile once with plain stores.  Integer sums do not
//   depend on the order of the additions, so the lists' order (that of the
//   atomics) does not matter: the field is the same bit for bit on every
//   launch.  No float atomics, no zeroing pass over the field.
//
// Slab bins (csrc/bin_vertices.cu): the stable rank of each vertex in its
//   x-slab floor(x) mod X, in vertex order, for the capacity of K11 and
//   K12.  Each block counts a tile of SLAB_TILE vertices into shared memory
//   (a thread a vertex; the peers of a slab in a warp add their number with
//   one atomic); one block per slab scans that slab's tile counts (each
//   tile's count of the slab's vertices before it); the last block to
//   finish scans the slab totals into starts[X + 1] and sums the overflow
//   past the capacity.  Then a vertex's rank is its tile's count before it,
//   plus its slab's vertices in the earlier rounds of 32 of its tile, plus
//   its lower peers in its own round (__match_any_sync, __popc(peers &
//   lanemask_lt)): K11's rank kernel walks its tile's rounds in a warp with
//   running slab offsets, K12's gather takes a block a tile and the
//   rounds' counts from shared memory.  The ranks equal those of
//   torch.sort(key, stable=True) and searchsorted's starts bit for bit; no
//   sorted copy is written.
//
// Node bins (csrc/bin_nodes.cu), K5's neighbour search: a stable counting
//   sort of the vertices by their nearest node (X*Y*Z bins, the dead in
//   the virtual bin X*Y*Z).  The count kernel writes each vertex's record
//   (wrapped position, cell id) and takes a slot in its node with an
//   integer atomic; two scan kernels turn the node counts into the starts
//   of the runs (a sum per tile of nodes, then each tile adds the sums
//   before it) and zero the counts again; the placement writes each live
//   vertex at its slot, in the order of the atomics, and the dead in
//   vertex order (a block scan over the block offsets the count kernel
//   left); the rank kernel gives each live vertex its stable place, the
//   number of vertices of its run with a smaller index (runs are a few
//   vertices long), and writes the order; a gather writes the records in
//   it.  The result equals torch.sort(bin, stable=True) and searchsorted's
//   starts bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ibm_stencil.cuh"

namespace hc {

constexpr int SLAB_WARPS = 8;   // warps (tiles) per block
constexpr int SLAB_ROUNDS = 4;  // rounds of 32 vertices per tile
constexpr int SLAB_TILE = 32 * SLAB_ROUNDS;
constexpr int PLACE_THREADS = 256;
constexpr int TILE_BYTES = 80 * 1024;   // the sums of a tile: two blocks an SM
constexpr int COUNT_THREADS = 256;      // vertices a counting block takes
constexpr int COUNT_SMEM_TILES = 8192;  // tiles a block counts in shared memory

// The tiles of the field: TX x TY x TZ nodes a block.
struct Tiles {
  int tx, ty, tz;
  int nx, ny, nz;
  int smem;  // bytes of shared memory the sums of a tile take
};

// Scratch of the tile bins, carved from one int32 buffer that is zero
// before the first call; `bound` and `counts` are zero again after every
// call.
struct TileBins {
  double* scale;     // [1] the fixed-point scale of the deposits
  int* bound;        // [1] bits of the largest |deposit| bound (a float >= 0)
  unsigned* ticket;  // [1] the placement's blocks done
  int* counts;       // [T]
  int* starts;       // [T + 1]
  int* slot;         // [P, 8] the vertex's place in the list of the tile of
                     // each corner, -1 where an earlier corner has that tile
  int* list;         // [8 P] the vertices of each tile
};

// Scratch of the slab bins, carved from one int32 buffer whose ticket
// starts zero (and is zero again after every call).
struct SlabBins {
  int* tilehist;     // [X, ceil(P / SLAB_TILE)] counts, then offsets
  int* totals;       // [X]
  unsigned* ticket;  // [1]
  int* starts;       // [X + 1]
};

// Scratch of the node bins, carved from one int32 buffer that is zero
// before the first call; `counts` is zero again after every call.
struct NodeBins {
  float4* rec;    // [P] wrapped position and cell id (bits), vertex order
  float4* rec_s;  // [P] the records in bin order
  int* counts;    // [N] live vertices per node (N = X*Y*Z)
  int* starts;    // [N + 1] the start of each node's run; starts[N] that of
                  // the dead, the virtual bin N
  int* bin;       // [P] the node of each vertex, N for the dead
  int* slot;      // [P] its place in its run in the order of the atomics
  int* tmp;       // [P] the live vertices placed at their slots
  int* order;     // [P] bin order -> vertex (stable)
  int* tile_sum;  // [ceil(N / SCAN_TILE)]
  int* dead;      // [ceil(P / NODE_THREADS)] dead vertices per block, then
                  // the dead of the blocks before
};

constexpr int NODE_THREADS = 256;   // vertices a counting or placing block takes
constexpr int SCAN_THREADS = 1024;  // threads of a scan block, 4 nodes each
constexpr int SCAN_TILE = 4 * SCAN_THREADS;

Tiles gather_tiles(int X, int Y, int Z);
long long tile_bins_ints(int P, int X, int Y, int Z);
TileBins tile_bins_carve(int* scratch, int P, int X, int Y, int Z);
long long slab_bins_ints(int P, int X);
SlabBins slab_bins_carve(int* scratch, int P, int X);

// K2's counting: the records of all vertices (wrapped position; weight
// scale active / max(total fluid weight, 1e-30); force capped at f_limit
// plus the extra force; the fluid mask of the 8 corners), those with
// active != 0 counted into their tiles, with the bound |active| * max |F|.
int tile_bins_count_k2(const float* pos, const float* force, const float* force_extra,
                       const float* active, const uint8_t* flags, float f_limit, int P, int X,
                       int Y, int Z, const TileBins& tb, float4* rec, cudaStream_t s);
// After counting: starts (the counts and the bound zeroed again), the
// scale, and the lists.
int tile_bins_place(const TileBins& tb, const float4* rec, int P, int X, int Y, int Z,
                    cudaStream_t s);

// The slab counts of the wrapped x (two launches): sb.tilehist holds each
// tile's count of each slab's vertices before it, sb.starts the slabs'
// starts; `overflow` receives the vertices past capacity.
int slab_counts(const float* pos, int P, int X, int capacity, const SlabBins& sb,
                long long* overflow, cudaStream_t s);
// The slab counts, then the records of all vertices (activity 1 within
// `capacity` of the slab, else 0, the force as it is: K11).
int slab_bins(const float* pos, const float* force, int P, int X, int Y, int Z, int capacity,
              const SlabBins& sb, long long* overflow, float4* rec, cudaStream_t s);
// K11's counting: the vertices whose record has activity 1 into their
// tiles, with the bound max |force|.
int tile_bins_count_records(const float4* rec, int P, int X, int Y, int Z, const TileBins& tb,
                            cudaStream_t s);

long long node_bins_ints(int P, int X, int Y, int Z);
NodeBins node_bins_carve(int* scratch, int P, int X, int Y, int Z);
// The node bins of the unwrapped positions: records, starts [N + 1], the
// stable order and the records in it.  Six launches.
int node_bins(const float* pos, const int* gid, const float* active, int P, int X, int Y, int Z,
              const NodeBins& nb, cudaStream_t s);

// The tile gather (csrc/spread.cu) of the records' deposits.
int tile_gather(const float4* rec, const TileBins& tb, float* out, int X, int Y, int Z,
                cudaStream_t s);

// ---- device helpers ------------------------------------------------------

constexpr unsigned FULL = 0xffffffffu;

// Exclusive scan of one int per thread over the block; *total gets the
// block's sum.  `sh` holds one int per warp.  Every thread of the block
// calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) sh[lane] = w;
  }
  __syncthreads();
  const int res = (warp ? sh[warp - 1] : 0) + x - v;
  *total = sh[nwarps - 1];
  __syncthreads();
  return res;
}

// The tiles the stencil with base node (bx, by, bz) reaches, in corner order
// (corner c = (c>>2 & 1, c>>1 & 1, c & 1)), -1 where an earlier corner has
// the same tile.
__device__ __forceinline__ void stencil_tiles(int bx, int by, int bz, int X, int Y, int Z,
                                              const Tiles& t, int ids[8]) {
  const int x0 = bx / t.tx, x1 = (bx + 1 == X ? 0 : bx + 1) / t.tx;
  const int y0 = by / t.ty, y1 = (by + 1 == Y ? 0 : by + 1) / t.ty;
  const int z0 = bz / t.tz, z1 = (bz + 1 == Z ? 0 : bz + 1) / t.tz;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int a = (c >> 2) & 1, b = (c >> 1) & 1, cc = c & 1;
    const bool fresh = (!a || x1 != x0) && (!b || y1 != y0) && (!cc || z1 != z0);
    ids[c] = fresh ? ((a ? x1 : x0) * t.ny + (b ? y1 : y0)) * t.nz + (cc ? z1 : z0) : -1;
  }
}

// The x-slab of an unwrapped x: floor of its wrap, wrapped (the wrap lies
// in [0, L]: it may round to L).
__device__ __forceinline__ int slab_of(float x, int X) {
  return wrap_once((int)floorf(wrap_pos_fast(x, X)), X);
}

// The nearest node along one axis of a wrapped coordinate in [0, L]:
// remainder(floor(p + 0.5), L), as cells/repulsion.py computes it.
__device__ __forceinline__ int nearest_node(float p, int L) {
  return wrap_idx((int)floorf(p + 0.5f), L);
}

// The base node of the stencil at a wrapped position (in [0, n]: n is 0).
__device__ __forceinline__ void base_of(float px, float py, float pz, int X, int Y, int Z,
                                        int& bx, int& by, int& bz) {
  bx = (int)floorf(px);
  by = (int)floorf(py);
  bz = (int)floorf(pz);
  if (bx >= X) bx -= X;
  if (by >= Y) by -= Y;
  if (bz >= Z) bz -= Z;
}

// The largest of the block's values (>= 0, as float bits) into *bound:
// a warp max, the warps' maxima in shared memory, one atomic per block.
__device__ __forceinline__ void block_bound(int bits, int* bound) {
  __shared__ int warp_max[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bits = __reduce_max_sync(0xffffffffu, bits);
  if (lane == 0) warp_max[warp] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int w = 0; w < (int)((blockDim.x + 31) >> 5); ++w) m = max(m, warp_max[w]);
    if (m > 0) atomicMax(bound, m);
  }
}

// Count the vertex of this thread (live or not; every thread of the block
// calls it, one vertex each) into the tiles of its stencil and keep its
// slots.  `p` < 0 for a thread past the last vertex.  With T <=
// COUNT_SMEM_TILES tiles the block counts in shared memory and makes one
// global atomic per tile it touches; beyond, one global atomic per thread
// and tile.
__device__ __forceinline__ void count_tiles(int p, bool live, float px, float py, float pz,
                                            int X, int Y, int Z, const Tiles& t, int T,
                                            const TileBins& tb) {
  __shared__ int local[COUNT_SMEM_TILES];
  const bool in_smem = T <= COUNT_SMEM_TILES;
  int ids[8];
  if (live) {
    int bx, by, bz;
    base_of(px, py, pz, X, Y, Z, bx, by, bz);
    stencil_tiles(bx, by, bz, X, Y, Z, t, ids);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) ids[c] = -1;
  }
  int slots[8];
  if (in_smem) {
    for (int i = threadIdx.x; i < T; i += blockDim.x) local[i] = 0;
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 8; ++c) slots[c] = ids[c] >= 0 ? atomicAdd(local + ids[c], 1) : -1;
    __syncthreads();
    for (int i = threadIdx.x; i < T; i += blockDim.x) {
      const int n = local[i];
      if (n > 0) local[i] = atomicAdd(tb.counts + i, n);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (ids[c] >= 0) slots[c] += local[ids[c]];
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) slots[c] = ids[c] >= 0 ? atomicAdd(tb.counts + ids[c], 1) : -1;
  }
  if (p >= 0) {
    int4* s4 = reinterpret_cast<int4*>(tb.slot + 8 * (long long)p);
    s4[0] = make_int4(slots[0], slots[1], slots[2], slots[3]);
    s4[1] = make_int4(slots[4], slots[5], slots[6], slots[7]);
  }
}

}  // namespace hc
