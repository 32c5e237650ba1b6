// K5: inter-cell repulsion, F_i = k * sum_j (cutoff / d^2) (p_i - p_j) over
// vertices j of other cells within `cutoff` of vertex i.
//
// Replaces: hemocell_tpu/cells/pallas_repulsion.py::pallas_repulsion
//   (kernel body _repulsion_kernel).  Computes exactly
//   repulsion.repulsion_forces(pos, cell_gid, active, shape, k, cutoff) of
//   hemocell_tpu_torch/cells/repulsion.py, the plain version: minimum image
//   in all three axes, the first `cap` vertices (in stable sorted order) of
//   each of the 27 bins around the vertex's nearest node, dead vertices in
//   no pair.  The TPU kernel's dropped y/z face-wrap pairs are not
//   reproduced.
//
// Bound on the H100: bytes.  The function reads 20 B per vertex (wrapped
//   position, cell id, activity) plus the bin table (4 B per node) and the
//   sorted order, and writes 12 B per vertex; per candidate pair it does
//   ~20 flops, a few tens of pairs per vertex in a dense suspension, far
//   below the card's f32 balance point.  In practice the 27 bin-table
//   lookups and the candidate gathers (L2 hits) set the time.
//
// Design: one thread per vertex, threads in sorted-bin order so that a warp
//   scans the same or neighbouring bins.  Each thread walks its 27 bins
//   through `bin_start`, gathers the candidates through `order`, and writes
//   its own sum: no atomics, so the result is deterministic.  The binning
//   and the sort are PyTorch calls in the wrapper (the TPU wrapper sorts
//   outside its kernel too).  The TPU kernel's slab windows, capacities,
//   128-alignment, parking slab and MXU distance algebra have no analog.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void repulsion_kernel(
    const float* __restrict__ pos_w,    // [P, 3] wrapped positions
    const int* __restrict__ gid,        // [P] global cell id
    const float* __restrict__ active,   // [P] 0/1
    const int* __restrict__ bin_id,     // [P] nearest-node bin; X*Y*Z = dead
    const int* __restrict__ order,      // [P] sorted rank -> vertex
    const int* __restrict__ bin_start,  // [X*Y*Z + 1] first rank of each bin
    float* __restrict__ out,            // [P, 3]
    float k_rep, float cutoff, int cap, int P, int X, int Y, int Z) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P) return;
  const int i = order[t];
  const int b = bin_id[i];
  const float act = active[i];
  if (b >= X * Y * Z || act == 0.f) {  // dead vertex: no force
    out[3 * i] = 0.f; out[3 * i + 1] = 0.f; out[3 * i + 2] = 0.f;
    return;
  }
  const int nz = b % Z;
  const int ny = (b / Z) % Y;
  const int nx = b / (Z * Y);
  const float px = pos_w[3 * i], py = pos_w[3 * i + 1], pz = pos_w[3 * i + 2];
  const int my_gid = gid[i];
  const float LX = (float)X, LY = (float)Y, LZ = (float)Z;

  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int ox = -1; ox <= 1; ++ox) {
    int bx = nx + ox; bx = bx < 0 ? bx + X : (bx >= X ? bx - X : bx);
    for (int oy = -1; oy <= 1; ++oy) {
      int by = ny + oy; by = by < 0 ? by + Y : (by >= Y ? by - Y : by);
      for (int oz = -1; oz <= 1; ++oz) {
        int bz = nz + oz; bz = bz < 0 ? bz + Z : (bz >= Z ? bz - Z : bz);
        const int nb = (bx * Y + by) * Z + bz;
        const int s = bin_start[nb];
        const int e = min(bin_start[nb + 1], s + cap);
        for (int r = s; r < e; ++r) {
          const int j = order[r];
          if (gid[j] == my_gid) continue;
          float dx = px - pos_w[3 * j];
          float dy = py - pos_w[3 * j + 1];
          float dz = pz - pos_w[3 * j + 2];
          dx -= rintf(dx / LX) * LX;  // minimum image (round half to even)
          dy -= rintf(dy / LY) * LY;
          dz -= rintf(dz / LZ) * LZ;
          const float d = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-30f));
          if (d < cutoff) {
            const float mag = k_rep * (cutoff / d) / d;
            fx += mag * dx; fy += mag * dy; fz += mag * dz;
          }
        }
      }
    }
  }
  out[3 * i] = fx * act;
  out[3 * i + 1] = fy * act;
  out[3 * i + 2] = fz * act;
}

}  // namespace

extern "C" int hc_repulsion(const void* pos_w, const void* gid, const void* active,
                            const void* bin_id, const void* order, const void* bin_start,
                            void* out, float k_rep, float cutoff, int cap,
                            int P, int X, int Y, int Z, void* stream) {
  if (P > 0) {
    const int threads = 128;
    repulsion_kernel<<<(P + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const float*)pos_w, (const int*)gid, (const float*)active, (const int*)bin_id,
        (const int*)order, (const int*)bin_start, (float*)out, k_rep, cutoff, cap,
        P, X, Y, Z);
  }
  return (int)cudaGetLastError();
}
