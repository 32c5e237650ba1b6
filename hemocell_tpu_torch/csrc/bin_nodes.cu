// Binning on the card for K5 (csrc/repulsion.cu): a counting sort of the
// vertices by their nearest node, with integer atomics and no sort library,
// whose every pass runs over the vertices and none over the X*Y*Z nodes.
// The design is described in binned.cuh ("Node bins").
//
// Replaces: the wrapper-side binning K5 had (torch.remainder, floor, a
//   stable torch.sort of int64 bin ids and a searchsorted of all X*Y*Z + 1
//   node ids); in the reference the argsort and searchsorted around
//   hemocell_tpu/cells/pallas_repulsion.py::pallas_repulsion.
//
// Bound on the H100: bytes and the latency of scattered words.  A call
//   moves about 100 B a vertex in vertex order and touches the node table
//   at the occupied nodes alone, one 4-byte word each: the count's
//   exchange, the rank's read and the starts' write (the pairs read the
//   words around each vertex), and at the nodes the last call occupied and
//   this one does not, which the rank clears (a vertex whose node changed
//   checks its old one: few a call, as cells move a fraction of a node an
//   iteration).  Nothing depends on X*Y*Z: one vertex set takes the same
//   time in a 128^3 and in a 256^3 box.  The node words are many and cold
//   (a node holds a few vertices), so the exchanges do not queue.  The
//   placement writes only the order and a coalesced gather moves the
//   16-byte records.

#include "binned.cuh"

namespace hc {
namespace {

int blocks(long long n, int per) { return (int)((n + per - 1) / per); }

constexpr int SUM_BLOCKS = 264;  // the tile sums' blocks at most: two an SM

// The sum of one int per thread over the block, in thread 0 (and every
// thread's return).  `sh` holds one int per warp.
__device__ __forceinline__ int block_sum(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(FULL, v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)((blockDim.x + 31) >> 5) ? sh[lane] : 0;
    w = __reduce_add_sync(FULL, w);
    if (lane == 0) sh[0] = w;
  }
  __syncthreads();
  const int total = sh[0];
  __syncthreads();
  return total;
}

// The exclusive scan of a[0, n) in place by one block (every thread calls
// it; `sh` holds one int per warp); returns the total.  Each warp takes
// chunks of 32 * SCAN_PER_THREAD consecutive values, loaded and stored
// coalesced (a thread's own run of values would stride the warp's loads).
__device__ int block_scan_in_place(int* a, int n, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunk = 32 * SCAN_PER_THREAD, round = chunk * (int)(blockDim.x >> 5);
  int carry = 0;
  for (int c0 = 0; c0 < n; c0 += round) {
    const int base = c0 + warp * chunk + lane;
    int v[SCAN_PER_THREAD], run = 0;
#pragma unroll
    for (int k = 0; k < SCAN_PER_THREAD; ++k) {
      const int i = base + 32 * k;
      const int x = i < n ? __ldcg(a + i) : 0;
      int incl = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      v[k] = run + incl - x;
      run += __shfl_sync(FULL, incl, 31);
    }
    int total;
    const int off = __shfl_sync(FULL, block_exclusive_scan(lane == 0 ? run : 0, sh, &total), 0);
#pragma unroll
    for (int k = 0; k < SCAN_PER_THREAD; ++k) {
      const int i = base + 32 * k;
      if (i < n) a[i] = carry + off + v[k];
    }
    carry += total;
  }
  return carry;
}

// Each vertex: its record and its node's slot (dead: -1), and in rnk the
// slot it held in the last call where that differs (else -1); if live,
// pushed onto its node's list (an exchange of HEAD_BIT | p + 1: the old
// word is its link if it is a head, else the list was empty).  Each block:
// the number of its dead.
__global__ void __launch_bounds__(NODE_THREADS)
    node_count_kernel(const float* __restrict__ pos, const int* __restrict__ gid,
                      const float* __restrict__ active, int P, int X, int Y, int Z,
                      NodeBins nb) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int dead = 0;
  if (p < P) {
    // the slots of the last call (none before the first: the scratch is
    // zero, and a call with no live vertex leaves only -1)
    const int before = *nb.n_live > 0 ? nb.bin[p] : -1;
    const float* p3 = pos + 3 * (long long)p;
    const float px = wrap_pos(p3[0], X), py = wrap_pos(p3[1], Y), pz = wrap_pos(p3[2], Z);
    int b = -1;
    if (active[p] > 0.f) {
      b = node_slot(nearest_node(px, X), nearest_node(py, Y), nearest_node(pz, Z), Y, Z);
      const unsigned old = atomicExch(nb.words + b, HEAD_BIT | (unsigned)(p + 1));
      nb.link[p] = old & HEAD_BIT ? (int)(old & ~HEAD_BIT) : 0;
    } else {
      dead = 1;
    }
    nb.rec[p] = make_float4(px, py, pz, __int_as_float(gid[p]));
    nb.bin[p] = b;
    nb.rnk[p] = before != b ? before : -1;
  }
  dead = __syncthreads_count(dead);
  if (threadIdx.x == 0) nb.dead[blockIdx.x] = dead;
}

// Each vertex that left a node: the node's word cleared if no vertex is
// there in this call (its word is no head; a vertex that is there would
// have pushed one).  Each live vertex walks its node's list: the node's
// length, its lowest vertex (the leader) and the vertex's stable rank (the
// members with a smaller index).  A leader keeps its run's length (tmp; 0
// elsewhere).
__global__ void __launch_bounds__(NODE_THREADS)
    node_rank_kernel(NodeBins nb, int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int left = nb.rnk[p];
  if (left >= 0 && !(nb.words[left] & HEAD_BIT)) nb.words[left] = 0u;
  const int b = nb.bin[p];
  int len = 0;
  if (b >= 0) {
    int lead = p, r = 0;
    for (int v = (int)(nb.words[b] & ~HEAD_BIT) - 1; v >= 0; v = nb.link[v] - 1) {
      ++len;
      r += v < p;
      lead = min(lead, v);
    }
    nb.rnk[p] = r;
    nb.lead[p] = lead;
    if (lead != p) len = 0;
  }
  nb.tmp[p] = len;
}

// Each warp takes tiles of NODE_THREADS vertices (the count's blocks) in
// turn: the lengths of the runs the tile's vertices lead and the number of
// those runs.  The last block to finish (a ticket; few blocks, so that the
// ticket's atomics do not queue) scans the tiles' lengths into the first
// rank of each tile's runs and the dead per tile into the dead before it,
// writes the call's live vertices and occupied nodes, and zeroes the
// ticket.
__global__ void __launch_bounds__(NODE_THREADS)
    node_tile_sums_kernel(NodeBins nb, int P, int n_tiles) {
  __shared__ int sh[32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, per_block = NODE_THREADS / 32;
  for (int k = blockIdx.x * per_block + (threadIdx.x >> 5); k < n_tiles;
       k += gridDim.x * per_block) {
    int live = 0, led = 0;
#pragma unroll
    for (int i = 0; i < NODE_THREADS / 32; ++i) {
      const int p = k * NODE_THREADS + i * 32 + lane;
      const int len = p < P ? nb.tmp[p] : 0;
      live += len;
      led += len > 0;
    }
    live = __reduce_add_sync(FULL, live);
    led = __reduce_add_sync(FULL, led);
    if (lane == 0) {
      nb.tile_sum[k] = live;
      nb.tile_bins[k] = led;
    }
  }
  __threadfence();  // this block's sums before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(nb.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int live = block_scan_in_place(nb.tile_sum, n_tiles, sh);
  block_scan_in_place(nb.dead, n_tiles, sh);
  int bins = 0;
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) bins += __ldcg(nb.tile_bins + i);
  bins = block_sum(bins, sh);
  if (threadIdx.x == 0) {
    *nb.n_live = live;
    *nb.n_bins = bins;
    *nb.ticket = 0u;
  }
}

// Each leader: its run's first rank (the block's, plus the lengths of the
// runs led by the block's lower vertices) kept (tmp) and written, with the
// run's length, over its node's list head: the word the pairs read.  The
// runs lie in the order of their leaders.
__global__ void __launch_bounds__(NODE_THREADS)
    node_starts_kernel(NodeBins nb, int P) {
  __shared__ int sh[32];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int len = p < P ? nb.tmp[p] : 0;
  int total;
  const int start = nb.tile_sum[blockIdx.x] + block_exclusive_scan(len, sh, &total);
  if (len > 0) {
    nb.tmp[p] = start;
    nb.words[nb.bin[p]] = run_word(start, len);
  }
}

// Each live vertex at its leader's first rank plus its own rank; each dead
// one at its place among the dead, in vertex order.  The same blocks as
// the count.
__global__ void __launch_bounds__(NODE_THREADS)
    node_place_kernel(NodeBins nb, int P) {
  __shared__ int sh[32];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int dead = p < P && nb.bin[p] < 0;
  int total;
  const int r = block_exclusive_scan(dead, sh, &total);
  if (p >= P) return;
  nb.order[dead ? *nb.n_live + nb.dead[blockIdx.x] + r : nb.tmp[nb.lead[p]] + nb.rnk[p]] = p;
}

// The records in bin order.
__global__ void __launch_bounds__(NODE_THREADS)
    node_gather_kernel(NodeBins nb, int P) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < P) nb.rec_s[t] = nb.rec[nb.order[t]];
}

// The run words decoded in x, y, z order (hc_bin_nodes alone).
__global__ void node_runs_kernel(NodeBins nb, int2* out, int X, int Y, int Z) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= (long long)X * Y * Z) return;
  const int z = (int)(n % Z), y = (int)(n / Z % Y), x = (int)(n / Z / Y);
  const unsigned w = nb.words[node_slot(x, y, z, Y, Z)];
  out[n] = make_int2((int)(w >> RUN_LEN_BITS), (int)(w & ((1u << RUN_LEN_BITS) - 1)));
}

}  // namespace

long long node_bins_ints(int P, int X, int Y, int Z) {
  return 4 + 8LL * P + node_slots(X, Y, Z) + 6LL * P + 3LL * blocks(P, NODE_THREADS);
}

NodeBins node_bins_carve(int* s, int P, int X, int Y, int Z) {
  NodeBins nb;
  nb.n_live = s;
  nb.n_bins = s + 1;
  nb.ticket = reinterpret_cast<unsigned*>(s + 2);
  nb.rec = reinterpret_cast<float4*>(s + 4);  // 16-byte aligned, as are rec_s
  nb.rec_s = nb.rec + P;
  nb.words = reinterpret_cast<unsigned*>(nb.rec_s + P);
  nb.bin = reinterpret_cast<int*>(nb.words + node_slots(X, Y, Z));
  nb.link = nb.bin + P;
  nb.rnk = nb.link + P;
  nb.lead = nb.rnk + P;
  nb.tmp = nb.lead + P;
  nb.order = nb.tmp + P;
  nb.tile_sum = nb.order + P;
  nb.tile_bins = nb.tile_sum + blocks(P, NODE_THREADS);
  nb.dead = nb.tile_bins + blocks(P, NODE_THREADS);
  return nb;
}

int node_bins(const float* pos, const int* gid, const float* active, int P, int X, int Y, int Z,
              const NodeBins& nb, cudaStream_t s) {
  if (P == 0) return (int)cudaGetLastError();
  const int vb = blocks(P, NODE_THREADS);
  node_count_kernel<<<vb, NODE_THREADS, 0, s>>>(pos, gid, active, P, X, Y, Z, nb);
  node_rank_kernel<<<vb, NODE_THREADS, 0, s>>>(nb, P);
  const int sb = blocks(vb, NODE_THREADS / 32);
  node_tile_sums_kernel<<<sb < SUM_BLOCKS ? sb : SUM_BLOCKS, NODE_THREADS, 0, s>>>(nb, P, vb);
  node_starts_kernel<<<vb, NODE_THREADS, 0, s>>>(nb, P);
  node_place_kernel<<<vb, NODE_THREADS, 0, s>>>(nb, P);
  node_gather_kernel<<<vb, NODE_THREADS, 0, s>>>(nb, P);
  return (int)cudaGetLastError();
}

}  // namespace hc

extern "C" long long hc_node_bins_ints(int P, int X, int Y, int Z) {
  return hc::node_bins_ints(P, X, Y, Z);
}

// K5's node bins alone, for the checks and the timing of chip_smoke.py:
// order [P] and each node's run [X*Y*Z, 2] (int32 in x, y, z order: first
// rank and length, the length capped at 31 as the table holds it, (0, 0)
// where the node holds no live vertex) written where the pointers are not
// null; the layout stays in the scratch for hc_repulsion_pairs.
extern "C" int hc_bin_nodes(const void* pos, const void* gid, const void* active, void* order,
                            void* runs, void* scratch, int P, int X, int Y, int Z,
                            void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const hc::NodeBins nb = hc::node_bins_carve((int*)scratch, P, X, Y, Z);
  int err = hc::node_bins((const float*)pos, (const int*)gid, (const float*)active, P, X, Y, Z,
                          nb, s);
  const long long N = (long long)X * Y * Z;
  if (!err && order != nullptr && P > 0)
    err = (int)cudaMemcpyAsync(order, nb.order, (long long)P * sizeof(int),
                               cudaMemcpyDeviceToDevice, s);
  if (!err && runs != nullptr) {
    hc::node_runs_kernel<<<(int)((N + 255) / 256), 256, 0, s>>>(nb, (int2*)runs, X, Y, Z);
    err = (int)cudaGetLastError();
  }
  return err;
}

// The nodes that the last call on `scratch` (hc_bin_nodes or hc_repulsion
// at these P and shape) occupied, or -1 on a CUDA error.  Waits for the
// stream: the step never calls it.
extern "C" long long hc_node_bins_occupied(const void* scratch, int P, int X, int Y, int Z,
                                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const hc::NodeBins nb = hc::node_bins_carve((int*)scratch, P, X, Y, Z);
  int bins = 0;
  if (cudaMemcpyAsync(&bins, nb.n_bins, sizeof(int), cudaMemcpyDeviceToHost, s) ||
      cudaStreamSynchronize(s))
    return -1;
  return bins;
}
