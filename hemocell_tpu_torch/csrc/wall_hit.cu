// K4: per-cell count of vertices whose nearest lattice node is not fluid.
//
// Replaces: hemocell_tpu/ibm/pallas_ibm.py::pallas_wall_hit_cells
//   (_hit_kernel) and the hit half of ::pallas_spread_shadow
//   (_spread_renorm_hit_kernel).  Computes coupling.on_boundary(wrap(pos),
//   flags) summed per cell, the plain version in
//   hemocell_tpu_torch/ibm/coupling.py::wall_hit_cells.
//
// Bound on the H100: bytes.  12 B per vertex (its position) plus one flag
//   byte per distinct nearest node; the counts are a few KB.  At the
//   main path's sizes the launch itself is the floor.
//
// Design: run on the post-advance positions, so a cell that touches a wall
//   is deleted in the same step, as on the reference package's CPU path
//   (the TPU's fused count lags one step).  One launch covers up to
//   HC_MAX_TYPES cell types (the wrapper launches once a group of them,
//   each group's counts and owned mask at its offset in the flat order).
//   The positions stay in their per-type [NC, NV, 3] tensors, which
//   the kernel takes as a by-value table (a pointer and NV each); a
//   vertex's cell follows from its index, so no cell-id operand and no
//   concatenation exist.  One block per cell:
//   each thread holds UNROLL of the cell's vertices in flight (the block
//   reads the cell's contiguous NV x 3 floats coalesced), tests each one's
//   nearest node as hc::wrap_pos/wrap_idx do, and the block sums by warp
//   reductions and one pass over the warps' sums; thread 0 stores the
//   cell's count, dead cells included.  Every count is written, so the
//   output needs no memset, and no atomics are used: the counts are exact
//   integers and repeat bit for bit.  An optional owned mask (one byte per
//   vertex of the flat order, the sharded caller's) drops the vertices of
//   other ranks.  (A warp per cell runs only 2 warps an SM at pipeflow30's
//   259 cells: it lost to the one-thread-per-vertex kernel it replaces.)

#include "ibm_stencil.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // vertices a thread holds in flight

struct Types {
  const float* pos[HC_MAX_TYPES];      // [NC_k, NV_k, 3] of type k
  int cell_start[HC_MAX_TYPES];        // global index of type k's first cell
  long long vert_start[HC_MAX_TYPES];  // flat index of its first vertex
  int nv[HC_MAX_TYPES];
};

__global__ void __launch_bounds__(THREADS)
    wall_hit_kernel(const Types t, int n_types, const uint8_t* __restrict__ owned,
                    const uint8_t* __restrict__ flags, int* __restrict__ hits, int X, int Y,
                    int Z) {
  __shared__ int warp_sum[WARPS];
  const int c = blockIdx.x;
  // the cell's type: the last one starting at or before c (the table is
  // indexed with constants only, so it stays in the parameter space)
  const float* pos = t.pos[0];
  int first = t.cell_start[0], nv = t.nv[0];
  long long vstart = t.vert_start[0];
#pragma unroll
  for (int k = 1; k < HC_MAX_TYPES; ++k) {
    if (k < n_types && c >= t.cell_start[k]) {
      pos = t.pos[k];
      first = t.cell_start[k];
      nv = t.nv[k];
      vstart = t.vert_start[k];
    }
  }
  const long long cell = c - first;
  const float* p = pos + cell * nv * 3;
  const uint8_t* own = owned == nullptr ? nullptr : owned + vstart + cell * nv;
  int count = 0;
  for (int v0 = 0; v0 < nv; v0 += THREADS * UNROLL) {
    float x[UNROLL], y[UNROLL], z[UNROLL];
    bool on[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS + threadIdx.x;
      on[u] = v < nv && (own == nullptr || own[v] != 0);
      x[u] = on[u] ? p[3 * v] : 0.f;
      y[u] = on[u] ? p[3 * v + 1] : 0.f;
      z[u] = on[u] ? p[3 * v + 2] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!on[u]) continue;
      // wrap_pos lies in [0, L], so floor(. + 0.5) in [0, L]: wrap_once is
      // wrap_idx there
      const int nx = hc::wrap_once((int)floorf(hc::wrap_pos_fast(x[u], X) + 0.5f), X);
      const int ny = hc::wrap_once((int)floorf(hc::wrap_pos_fast(y[u], Y) + 0.5f), Y);
      const int nz = hc::wrap_once((int)floorf(hc::wrap_pos_fast(z[u], Z) + 0.5f), Z);
      count += flags[(nx * Y + ny) * Z + nz] != 0;
    }
  }
  count = __reduce_add_sync(0xffffffffu, count);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += warp_sum[w];
    hits[c] = total;
  }
}

}  // namespace

// pos: n_types device pointers to [nc[k], nv[k], 3] f32 (host array);
// nc, nv: host int arrays; owned: null or [sum nc*nv] bytes (flat order);
// hits: [sum nc] int32, every entry written.  At most HC_MAX_TYPES types;
// X*Y*Z < 2^31.
extern "C" int hc_wall_hit_cells(const void* const* pos, const int* nc, const int* nv,
                                 int n_types, const void* owned, const void* flags, void* hits,
                                 int X, int Y, int Z, void* stream) {
  if (n_types < 1 || n_types > HC_MAX_TYPES) return (int)cudaErrorInvalidValue;
  Types t = {};
  int n_cells = 0;
  long long n_vert = 0;
  for (int k = 0; k < n_types; ++k) {
    t.pos[k] = (const float*)pos[k];
    t.cell_start[k] = n_cells;
    t.vert_start[k] = n_vert;
    t.nv[k] = nv[k];
    n_cells += nc[k];
    n_vert += (long long)nc[k] * nv[k];
  }
  if (n_cells > 0) {
    wall_hit_kernel<<<n_cells, THREADS, 0, (cudaStream_t)stream>>>(
        t, n_types, (const uint8_t*)owned, (const uint8_t*)flags, (int*)hits, X, Y, Z);
  }
  return (int)cudaGetLastError();
}
