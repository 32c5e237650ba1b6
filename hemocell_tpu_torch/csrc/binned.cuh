// The deterministic binned spread shared by K2 (csrc/spread.cu) and K11
// (csrc/ibm_static.cu), and the x-slab counts of K11 and K12.
//
// The field is cut into near-cubic tiles of TX x TY x TZ nodes
// (gather_tiles), shaped from the lattice so that a stencil spans as few
// tiles as it can: of the extents that are powers of two or an axis's
// length, those of at most TILE_NODES nodes (whose 64-bit sums fit a
// block's shared memory) in which a vertex makes the fewest list entries,
// (1 + 1/TX)(1 + 1/TY)(1 + 1/TZ) on average (8 x 16 x 16 at 256^3: 1.27;
// z columns of 4 x 2 x 256 would make 1.875).  TZ is at
// least 8 where Z allows, so the gather's stores run 32 bytes or more along
// z.  A lattice with fewer than MIN_TILES such tiles takes smaller ones, down
// to MIN_TILE_NODES nodes (248x56x56: 8 x 8 x 8, 1519 tiles): with a tile
// per block, the densest tiles of a small lattice would hold its last
// blocks.
//
// Tile bins (csrc/bin_vertices.cu), two launches that sweep no tile a
//   block: each live vertex is entered in the list of every tile that one
//   of the 8 nodes of its stencil lies in (1 to 8 tiles, most often 1).
//   * The counting kernel writes each vertex's 32-byte record in vertex
//     order (wrapped position, weight scale, force, fluid mask of its 8
//     corners: K2 reads the flags here, once) and its stencil's key (the
//     tile of its base node and the axes its +1 nodes cross into the next
//     tile), and gives each of its entries its place in its tile's list
//     (count_tiles): with T <= SMEM_TILES tiles a block counts in shared
//     memory and takes one global atomic a touched tile; beyond, the lanes
//     of a warp that share a tile take their places with one global atomic
//     (a cell's vertices are consecutive, so a warp's 32 touch few tiles).
//     The places, in the order of the atomics, go to a corner-major [8, P]
//     array.  It takes the largest |deposit| a vertex can make (a block
//     max, then one integer atomicMax of the float's bits).  Its blocks loop
//     over the vertices, so that few blocks end; the last block to finish
//     (a ticket) scans the T counts into the starts of the lists, zeroes
//     them for the next call, and sets the fixed-point scale 2^(30 - e),
//     with 2^e above that bound: a deposit rounds to an integer below 2^30
//     in magnitude, its rounding error is at most 2^-31 of the bound.
//   * The placement kernel reads each vertex's key and places and writes
//     its index into its tiles' lists: no scan and no atomic.
//
// Tile gather (csrc/spread.cu): one block per tile, holding the tile's
//   [3, TX*TY*TZ] sums in shared memory as 64-bit integers (a signed low
//   32-bit word and a high word that takes the low word's rare wraps: the
//   thread whose atomic wrapped the low word adds +-1 to the high one); the
//   x and y strides are padded so that a stencil's 8 nodes lie in 8 banks.
//   It stages its listed records in shared memory and walks them, eight
//   lanes per vertex, one per corner: the corner's weight times the
//   record's scale, on a fluid corner in the tile, times the force rounds
//   to an integer at the fixed-point scale and is added there.  Then it
//   writes every node of the tile once with plain stores, a thread a node
//   along z, adding a uniform body force where the caller gives one (one
//   float32 addition of the node's value, as PyTorch's add would make it
//   after the spread).  Integer sums do not depend on the order of the
//   additions, so the lists' order (that of the atomics) and the tiling do
//   not matter: the field is the same bit for bit on every launch.  No
//   float atomics, no zeroing pass over the field.
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
constexpr int PLACE_THREADS = 256;   // vertices a placing block takes
constexpr int TILE_NODES = 2048;     // nodes of a tile: 48 KB of sums
constexpr int MIN_TILES = 1024;      // fewer tiles than this: smaller ones,
constexpr int MIN_TILE_NODES = 512;  // down to this many nodes
constexpr int COUNT_THREADS = 256;   // vertices a counting block takes a round
constexpr int SCAN_PER_THREAD = 16;  // tile counts a thread of the last block scans a round
constexpr int SMEM_TILES = 2048;     // the most tiles a counting block counts in shared memory

// The tiles of the field: TX x TY x TZ nodes a block; the sums of a node
// (ox, oy, oz) of the tile lie at (ox * sx + oy * sy + oz) in shared memory.
struct Tiles {
  int tx, ty, tz;
  int nx, ny, nz;
  int sx, sy;  // the padded strides of the sums
  int words;   // ints of one of the six arrays of sums: tx * sx
};

// Scratch of the tile bins, carved from one int32 buffer that is zero
// before the first call; `bound`, `ticket` and `counts` are zero again
// after every call.
struct TileBins {
  double* scale;     // [1] the fixed-point scale of the deposits
  int* bound;        // [1] bits of the largest |deposit| bound (a float >= 0)
  unsigned* ticket;  // [1] the counting blocks done
  int* counts;       // [T]
  int* starts;       // [T + 1]
  int* key;          // [P] each vertex's stencil_key
  int* slot;         // [8, P] a vertex's place in the list of the tile of
                     // each corner (corner-major; where the corner has one)
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
// plus the extra force; the fluid mask of the 8 corners), the keys, those
// with active != 0 counted into their tiles and given their places, with
// the bound |active| * max |F|; then the starts and the scale (the counts,
// the bound and the ticket zeroed again).  One launch, of at least one
// block.
int tile_bins_count_k2(const float* pos, const float* force, const float* force_extra,
                       const float* active, const uint8_t* flags, float f_limit, int P, int X,
                       int Y, int Z, const Tiles& t, const TileBins& tb, float4* rec,
                       cudaStream_t s);
// After counting: the lists.  One launch, of at least one block.
int tile_bins_place(const TileBins& tb, int P, const Tiles& t, cudaStream_t s);

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
// tiles, with the bound max |force|; then the starts and the scale.
int tile_bins_count_records(const float4* rec, int P, int X, int Y, int Z, const Tiles& t,
                            const TileBins& tb, cudaStream_t s);

long long node_bins_ints(int P, int X, int Y, int Z);
NodeBins node_bins_carve(int* scratch, int P, int X, int Y, int Z);
// The node bins of the unwrapped positions: records, starts [N + 1], the
// stable order and the records in it.  Six launches.
int node_bins(const float* pos, const int* gid, const float* active, int P, int X, int Y, int Z,
              const NodeBins& nb, cudaStream_t s);

// A uniform body force that the tile gather adds to every node it writes:
// none, three floats by value, or a float [3] in device memory.
struct BodyForce {
  int mode;  // 0 none, 1 by value (v), 2 from device memory (dev)
  float v[3];
  const float* dev;
};

// The tile gather (csrc/spread.cu) of the records' deposits, plus the body
// force.
int tile_gather(const float4* rec, const TileBins& tb, float* out, int X, int Y, int Z,
                const Tiles& t, const BodyForce& bf, cudaStream_t s);

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

// The key of the stencil at a wrapped position: the tile of its base node
// times 8 plus the axes along which its +1 nodes lie in the next tile (bit
// 2 x, 1 y, 0 z; a tile that spans its axis holds both); -1 where the
// vertex is not live.  The +1 node's tile is the next one, wrapped.
__device__ __forceinline__ int stencil_key(bool live, float px, float py, float pz, int X,
                                           int Y, int Z, const Tiles& t) {
  if (!live) return -1;
  int bx, by, bz;
  base_of(px, py, pz, X, Y, Z, bx, by, bz);
  const int x0 = bx / t.tx, y0 = by / t.ty, z0 = bz / t.tz;
  const bool cx = (bx + 1 == X ? 0 : bx + 1) / t.tx != x0;
  const bool cy = (by + 1 == Y ? 0 : by + 1) / t.ty != y0;
  const bool cz = (bz + 1 == Z ? 0 : bz + 1) / t.tz != z0;
  return ((x0 * t.ny + y0) * t.nz + z0) * 8 + (cx << 2 | cy << 1 | cz);
}

// The tiles a stencil's key reaches, in corner order (corner c = (c>>2 & 1,
// c>>1 & 1, c & 1)), -1 where an earlier corner has the same tile.
__device__ __forceinline__ void key_tiles(int key, const Tiles& t, int ids[8]) {
  if (key < 0) {
#pragma unroll
    for (int c = 0; c < 8; ++c) ids[c] = -1;
    return;
  }
  const int tile = key >> 3;
  const int z0 = tile % t.nz, y0 = tile / t.nz % t.ny, x0 = tile / t.nz / t.ny;
  const int x1 = x0 + 1 == t.nx ? 0 : x0 + 1, y1 = y0 + 1 == t.ny ? 0 : y0 + 1,
            z1 = z0 + 1 == t.nz ? 0 : z0 + 1;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int a = (c >> 2) & 1, b = (c >> 1) & 1, cc = c & 1;
    const bool fresh = (!a || (key & 4)) && (!b || (key & 2)) && (!cc || (key & 1));
    ids[c] = fresh ? ((a ? x1 : x0) * t.ny + (b ? y1 : y0)) * t.nz + (cc ? z1 : z0) : -1;
  }
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

// Count the vertex of this thread into the tiles of its stencil and give
// it its place in each tile's list, in the order of the atomics (every
// thread of the block calls it; `live` false for a dead vertex or a thread
// past the last one).  slot [8, P] (corner-major) gets the places of the
// corners that have a tile.
//
// With T <= SMEM_TILES tiles (`local` holds T ints) the block counts in
// shared memory, each entry's rank within the block from an atomic there,
// then one global atomic a touched tile gives the block's base in it: no
// hot counter sees more than one atomic a block, however the vertices are
// ordered.  Beyond, a sweep of T counters a block would cost more than
// the vertices: each warp groups its lanes by tile (a cell's vertices are
// consecutive, so a warp's 32 touch few tiles) and a group takes its places
// with one global atomic, all of the warp's atomics in flight together.
__device__ __forceinline__ void count_tiles(long long p, long long P, bool live, float px,
                                            float py, float pz, int X, int Y, int Z,
                                            const Tiles& t, int T, int* local,
                                            const TileBins& tb) {
  int ids[8], place[8];
  const int key = stencil_key(live, px, py, pz, X, Y, Z, t);
  if (p < P) tb.key[p] = key;
  key_tiles(key, t, ids);
  if (T <= SMEM_TILES) {
    for (int i = threadIdx.x; i < T; i += blockDim.x) local[i] = 0;
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 8; ++c) place[c] = ids[c] >= 0 ? atomicAdd(local + ids[c], 1) : 0;
    __syncthreads();
    for (int i = threadIdx.x; i < T; i += blockDim.x) {
      const int n = local[i];
      if (n > 0) local[i] = atomicAdd(tb.counts + i, n);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (ids[c] >= 0) tb.slot[c * P + p] = local[ids[c]] + place[c];
    __syncthreads();  // before the next round zeroes the counts
    return;
  }
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int lead[8];      // the lane that leads the vertex's group, and its rank in it
  unsigned any = 0u;  // the corners with a tile in some lane of the warp
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    place[c] = 0;
    lead[c] = 0;
    unsigned pending = __ballot_sync(FULL, ids[c] >= 0);
    any |= (pending != 0u) << c;
    while (pending) {  // the same in every lane
      const int leader = __ffs(pending) - 1;
      const int id = __shfl_sync(FULL, ids[c], leader);
      const unsigned group = __ballot_sync(FULL, ids[c] == id);
      if (lane == leader) place[c] = atomicAdd(tb.counts + id, __popc(group));
      if ((group >> lane) & 1) lead[c] = leader | __popc(group & lower) << 5;
      pending &= ~group;
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (!((any >> c) & 1)) continue;  // the same in every lane
    const int base = __shfl_sync(FULL, place[c], lead[c] & 31);
    if (ids[c] >= 0) tb.slot[c * P + p] = base + (lead[c] >> 5);
  }
}

// The end of a counting block (every thread calls it, `bits` its vertex's
// bound): the block's bound, then its ticket.  The last block to finish
// scans the T tile counts into starts [T + 1], zeroes the counts, the bound
// and the ticket, and sets the fixed-point scale.
__device__ __forceinline__ void finish_counts(int bits, const TileBins& tb, int T) {
  __shared__ int sh[32];
  __shared__ bool last;
  block_bound(bits, tb.bound);
  __threadfence();  // this block's atomics before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tb.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (int c0 = 0; c0 < T; c0 += SCAN_PER_THREAD * blockDim.x) {
    const int i0 = c0 + threadIdx.x * SCAN_PER_THREAD;
    int v[SCAN_PER_THREAD], sum = 0;
#pragma unroll
    for (int k = 0; k < SCAN_PER_THREAD; ++k) {
      v[k] = i0 + k < T ? __ldcg(tb.counts + i0 + k) : 0;
      sum += v[k];
    }
    int total;
    int run = carry + block_exclusive_scan(sum, sh, &total);
#pragma unroll
    for (int k = 0; k < SCAN_PER_THREAD; ++k) {
      if (i0 + k < T) {
        tb.starts[i0 + k] = run;
        tb.counts[i0 + k] = 0;
      }
      run += v[k];
    }
    carry += total;
  }
  if (threadIdx.x == 0) {
    tb.starts[T] = carry;
    const float m = __int_as_float(__ldcg(tb.bound));
    double scale = 1.0;
    if (!(m <= 3.402823466e38f)) {
      scale = __longlong_as_double(0x7ff8000000000000LL);  // a force is not finite
    } else if (m > 0.f) {
      int e;
      frexpf(m, &e);  // m < 2^e
      scale = ldexp(1.0, 30 - e);
    }
    *tb.scale = scale;
    *tb.bound = 0;
    *tb.ticket = 0u;
  }
}

}  // namespace hc
