// K4: per-cell count of vertices whose nearest lattice node is not fluid.
//
// Replaces: hemocell_tpu/ibm/pallas_ibm.py::pallas_wall_hit_cells
//   (_hit_kernel) and the hit half of ::pallas_spread_shadow
//   (_spread_renorm_hit_kernel).  Computes coupling.on_boundary(wrap(pos),
//   flags) summed per cell, the plain version in
//   hemocell_tpu_torch/ibm/coupling.py::wall_hit_cells.
//
// Bound on the H100: bytes.  16 B per vertex (position, cell id) plus one
//   flag byte per distinct nearest node; the counts are a few KB.
//
// Design: one thread per vertex, run on the post-advance positions so a
//   cell that touches a wall is deleted in the same step, as on the
//   reference package's CPU path (the TPU's fused count lags one step).
//   The rare hits go through an int32 atomicAdd into counts[cell_id]: no
//   [P] scatter and no per-cell one-hot reduction.  Counts are exact
//   integers, so the result is deterministic.

#include "ibm_stencil.cuh"

namespace {

__global__ void wall_hit_kernel(const float* __restrict__ pos, const int* __restrict__ cell_id,
                                const uint8_t* __restrict__ flags, int* __restrict__ hits,
                                int P, int X, int Y, int Z) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int nx = hc::wrap_idx((int)floorf(hc::wrap_pos(pos[3 * p], X) + 0.5f), X);
  const int ny = hc::wrap_idx((int)floorf(hc::wrap_pos(pos[3 * p + 1], Y) + 0.5f), Y);
  const int nz = hc::wrap_idx((int)floorf(hc::wrap_pos(pos[3 * p + 2], Z) + 0.5f), Z);
  if (flags[((long long)nx * Y + ny) * Z + nz] != 0) atomicAdd(hits + cell_id[p], 1);
}

}  // namespace

// pos [P, 3] f32; cell_id [P] int32; hits zeroed [n_cells] int32.
extern "C" int hc_wall_hit_cells(const void* pos, const void* cell_id, const void* flags,
                                 void* hits, int P, int X, int Y, int Z, void* stream) {
  if (P > 0) {
    const int threads = 256;
    wall_hit_kernel<<<(P + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const float*)pos, (const int*)cell_id, (const uint8_t*)flags, (int*)hits, P, X, Y,
        Z);
  }
  return (int)cudaGetLastError();
}
