// Binning on the card for K5 (csrc/repulsion.cu): a stable counting sort of
// the vertices by their nearest node, with integer atomics and no sort
// library.  The design is described in binned.cuh ("Node bins").
//
// Replaces: the wrapper-side binning K5 had (torch.remainder, floor, a
//   stable torch.sort of int64 bin ids and a searchsorted of all X*Y*Z + 1
//   node ids); in the reference the argsort and searchsorted around
//   hemocell_tpu/cells/pallas_repulsion.py::pallas_repulsion.
//
// Bound on the H100: bytes and launch latency.  The count reads each
//   vertex (20 B) and writes its record, node and slot (24 B); the two scan
//   passes read the [X*Y*Z] counts twice and write the starts and the
//   zeroed counts (16 B a node); the placement and the rank write an index
//   per vertex at its place, the gather the records in bin order.  The
//   node counters are many and cold (a node holds a few vertices), so one
//   global atomic per vertex does not queue.  The rank writes only the
//   order and a coalesced gather moves the 16-byte records: scattered
//   16-byte stores from the rank took longer than the two together.

#include "binned.cuh"

namespace hc {
namespace {

int blocks(long long n, int per) { return (int)((n + per - 1) / per); }

__host__ __device__ long long pad4(long long n) { return (n + 3) / 4 * 4; }

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

// Each vertex: its record, its node (dead: N) and, if live, a slot in its
// node from an integer atomic; each block: the number of its dead.
__global__ void __launch_bounds__(NODE_THREADS)
    node_count_kernel(const float* __restrict__ pos, const int* __restrict__ gid,
                      const float* __restrict__ active, int P, int X, int Y, int Z,
                      NodeBins nb) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int dead = 0;
  if (p < P) {
    const float* p3 = pos + 3 * (long long)p;
    const float px = wrap_pos(p3[0], X), py = wrap_pos(p3[1], Y), pz = wrap_pos(p3[2], Z);
    int b = X * Y * Z, s = -1;
    if (active[p] > 0.f) {
      b = (nearest_node(px, X) * Y + nearest_node(py, Y)) * Z + nearest_node(pz, Z);
      s = atomicAdd(nb.counts + b, 1);
    } else {
      dead = 1;
    }
    nb.rec[p] = make_float4(px, py, pz, __int_as_float(gid[p]));
    nb.bin[p] = b;
    nb.slot[p] = s;
  }
  dead = __syncthreads_count(dead);
  if (threadIdx.x == 0) nb.dead[blockIdx.x] = dead;
}

// Block k: the sum of the counts of nodes [k SCAN_TILE, (k+1) SCAN_TILE).
// The counts are padded with zeros to a multiple of 4.
__global__ void __launch_bounds__(SCAN_THREADS)
    node_tile_sums_kernel(const int* __restrict__ counts, long long n_pad,
                          int* __restrict__ tile_sum) {
  __shared__ int sh[32];
  const long long i = (long long)blockIdx.x * SCAN_TILE + 4 * threadIdx.x;
  int v = 0;
  if (i < n_pad) {
    const int4 c = *reinterpret_cast<const int4*>(counts + i);
    v = c.x + c.y + c.z + c.w;
  }
  v = block_sum(v, sh);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = v;
}

// Block k: the starts of its tile's nodes (the tile sums before it plus a
// block scan), the counts zeroed for the next call; the last block writes
// starts[N] (the first dead), block 0 turns the dead per counting block
// into the dead of the blocks before.
__global__ void __launch_bounds__(SCAN_THREADS)
    node_starts_kernel(NodeBins nb, int N, int n_dead_blocks) {
  __shared__ int sh[32];
  const int k = blockIdx.x;
  int before = 0;
  for (int j = threadIdx.x; j < k; j += blockDim.x) before += nb.tile_sum[j];
  before = block_sum(before, sh);
  const long long i = (long long)k * SCAN_TILE + 4 * threadIdx.x;
  int4 c = make_int4(0, 0, 0, 0);
  if (i < pad4(N)) {
    int4* c4 = reinterpret_cast<int4*>(nb.counts + i);
    c = *c4;
    *c4 = make_int4(0, 0, 0, 0);
  }
  int total;
  const int ex = before + block_exclusive_scan(c.x + c.y + c.z + c.w, sh, &total);
  const int s[4] = {ex, ex + c.x, ex + c.x + c.y, ex + c.x + c.y + c.z};
  if (i + 3 < N) {
    *reinterpret_cast<int4*>(nb.starts + i) = make_int4(s[0], s[1], s[2], s[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (i + q < N) nb.starts[i + q] = s[q];
  }
  if (k == (int)gridDim.x - 1 && threadIdx.x == 0) nb.starts[N] = before + total;
  if (k == 0) {
    int run = 0;
    for (int c0 = 0; c0 < n_dead_blocks; c0 += blockDim.x) {
      const int j = c0 + threadIdx.x;
      int chunk;
      const int e = block_exclusive_scan(j < n_dead_blocks ? nb.dead[j] : 0, sh, &chunk);
      if (j < n_dead_blocks) nb.dead[j] = run + e;
      run += chunk;
    }
  }
}

// Each live vertex at its slot in its node's run (the order of the
// atomics); each dead one at its place among the dead, in vertex order,
// with its record.  The same blocks as the count.
__global__ void __launch_bounds__(NODE_THREADS)
    node_place_kernel(NodeBins nb, int P, int N) {
  __shared__ int sh[32];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = p < P ? nb.bin[p] : 0;
  const int dead = p < P && b == N;
  int total;
  const int r = block_exclusive_scan(dead, sh, &total);
  if (p >= P) return;
  if (dead) {
    const int d = nb.starts[N] + nb.dead[blockIdx.x] + r;
    nb.order[d] = p;
    nb.rec_s[d] = nb.rec[p];
  } else {
    nb.tmp[nb.starts[b] + nb.slot[p]] = p;
  }
}

// Each live vertex's stable place: the vertices of its run with a smaller
// index come before it.
__global__ void __launch_bounds__(NODE_THREADS)
    node_rank_kernel(NodeBins nb, int P, int N) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int b = nb.bin[p];
  if (b == N) return;
  const int s = nb.starts[b], e = nb.starts[b + 1];
  int r = 0;
  for (int k = s; k < e; ++k) r += nb.tmp[k] < p;
  nb.order[s + r] = p;
}

// The records of the live vertices in bin order (the dead ones were
// written by the placement).
__global__ void __launch_bounds__(NODE_THREADS)
    node_gather_kernel(NodeBins nb, int N) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < nb.starts[N]) nb.rec_s[t] = nb.rec[nb.order[t]];
}

}  // namespace

long long node_bins_ints(int P, int X, int Y, int Z) {
  const long long N = (long long)X * Y * Z;
  return 8LL * P + pad4(N) + (N + 1) + 4LL * P + blocks(N, SCAN_TILE) +
         blocks(P, NODE_THREADS);
}

NodeBins node_bins_carve(int* s, int P, int X, int Y, int Z) {
  const long long N = (long long)X * Y * Z;
  NodeBins nb;
  nb.rec = reinterpret_cast<float4*>(s);  // 16-byte aligned, as are rec_s
  nb.rec_s = nb.rec + P;                  // and counts
  nb.counts = s + 8LL * P;
  nb.starts = nb.counts + pad4(N);
  nb.bin = nb.starts + N + 1;
  nb.slot = nb.bin + P;
  nb.tmp = nb.slot + P;
  nb.order = nb.tmp + P;
  nb.tile_sum = nb.order + P;
  nb.dead = nb.tile_sum + blocks(N, SCAN_TILE);
  return nb;
}

int node_bins(const float* pos, const int* gid, const float* active, int P, int X, int Y, int Z,
              const NodeBins& nb, cudaStream_t s) {
  if (P == 0) return (int)cudaGetLastError();
  const long long N = (long long)X * Y * Z;
  const int vb = blocks(P, NODE_THREADS), tb = blocks(N, SCAN_TILE);
  node_count_kernel<<<vb, NODE_THREADS, 0, s>>>(pos, gid, active, P, X, Y, Z, nb);
  node_tile_sums_kernel<<<tb, SCAN_THREADS, 0, s>>>(nb.counts, pad4(N), nb.tile_sum);
  node_starts_kernel<<<tb, SCAN_THREADS, 0, s>>>(nb, (int)N, vb);
  node_place_kernel<<<vb, NODE_THREADS, 0, s>>>(nb, P, (int)N);
  node_rank_kernel<<<vb, NODE_THREADS, 0, s>>>(nb, P, (int)N);
  node_gather_kernel<<<vb, NODE_THREADS, 0, s>>>(nb, (int)N);
  return (int)cudaGetLastError();
}

}  // namespace hc

extern "C" long long hc_node_bins_ints(int P, int X, int Y, int Z) {
  return hc::node_bins_ints(P, X, Y, Z);
}

// K5's node bins alone, for the checks and the timing of chip_smoke.py:
// order [P] and starts [X*Y*Z + 1] (int32) copied out where the pointers
// are not null; the layout stays in the scratch for hc_repulsion_pairs.
extern "C" int hc_bin_nodes(const void* pos, const void* gid, const void* active, void* order,
                            void* starts, void* scratch, int P, int X, int Y, int Z,
                            void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const hc::NodeBins nb = hc::node_bins_carve((int*)scratch, P, X, Y, Z);
  int err = hc::node_bins((const float*)pos, (const int*)gid, (const float*)active, P, X, Y, Z,
                          nb, s);
  const long long N = (long long)X * Y * Z;
  if (!err && order != nullptr && P > 0)
    err = (int)cudaMemcpyAsync(order, nb.order, (long long)P * sizeof(int),
                               cudaMemcpyDeviceToDevice, s);
  if (!err && starts != nullptr)
    err = (int)cudaMemcpyAsync(starts, nb.starts, (N + 1) * sizeof(int),
                               cudaMemcpyDeviceToDevice, s);
  return err;
}
