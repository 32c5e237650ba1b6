// K3: boundary-aware trilinear interpolation of the fluid velocity to the
// vertices.
//
// Replaces: hemocell_tpu/ibm/pallas_ibm.py::pallas_interp_shadow and
//   ::pallas_interp (_interp_kernel) with the [u*mask, mask] channels and
//   the division by the mask channel that dynamics.py applies after them.
//   Computes coupling.interpolate(u, *coupling.stencil(wrap(pos), flags,
//   act)) of hemocell_tpu_torch/ibm/coupling.py, the plain version.
//
// Bound on the H100: bytes.  Per vertex 16 B in (position, activity) and
//   12 B out, plus 13 B (3 velocity channels and a flag) of each lattice
//   node the vertices touch; a few dozen flops per vertex.
//
// Design: one thread per vertex.  It finds its cell's 8 corners with
//   32-bit indices (hc::corners: the wrap without its division for a
//   coordinate already in the box, the corner index without a remainder)
//   and issues the corners' 8 flag and 24 velocity loads together, so a
//   vertex waits on memory once after its position; then the weights of
//   coupling.stencil (zeroed on non-fluid corners, divided by max(total,
//   1e-30), times act) and the sum corner by corner over the non-zero
//   weights, under -fmad=false: the result equals the one of the kernel
//   before it (flags first, then the velocities of the fluid corners) bit
//   for bit.  A vertex with act == 0 writes zeros.  No sort, window or
//   un-sort pass: the TPU kernel's x-slab windows and multi-payload un-sort
//   exist only because TPU gathers are slow.
//
//   Tried and dropped (PERF.md): one block per cell staging the box of
//   nodes its active vertices touch in shared memory (cp.async), then
//   interpolating from it, with the per-vertex gather as its branch for
//   cells whose box did not fit.  The boxes of pipeflow30's cells hold about the lattice's volume, several
//   times the nodes the gather touches: the stage won where the velocity
//   sat in L2 and lost in the coupled step, where the fluid kernel and the
//   velocity's own product run just before K3.

#include "ibm_stencil.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    interp_kernel(const float* __restrict__ u, const float* __restrict__ pos,
                  const float* __restrict__ active, const uint8_t* __restrict__ flags,
                  float* __restrict__ out, int P, int X, int Y, int Z) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const float act = active[p];
  float vx = 0.f, vy = 0.f, vz = 0.f;
  if (act != 0.f) {
    hc::Corners c;
    hc::corners(pos[3 * p], pos[3 * p + 1], pos[3 * p + 2], X, Y, Z, c);
    const size_t N = (size_t)X * Y * Z;
    uint8_t fl[8];
    float ux[8], uy[8], uz[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int g = (c.ix[(k >> 2) & 1] * Y + c.iy[(k >> 1) & 1]) * Z + c.iz[k & 1];
      fl[k] = flags[g];
      ux[k] = u[g];
      uy[k] = u[N + g];
      uz[k] = u[2 * N + g];
    }
    float w[8];
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float wk = c.wx[(k >> 2) & 1] * c.wy[(k >> 1) & 1] * c.wz[k & 1];
      if (fl[k] != 0) wk = 0.f;
      w[k] = wk;
      total += wk;
    }
    const float denom = fmaxf(total, 1e-30f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float wk = (w[k] / denom) * act;
      if (wk == 0.f) continue;
      vx += wk * ux[k];
      vy += wk * uy[k];
      vz += wk * uz[k];
    }
  }
  out[3 * p] = vx;
  out[3 * p + 1] = vy;
  out[3 * p + 2] = vz;
}

}  // namespace

// u [3, X, Y, Z] f32; pos [P, 3] f32; active [P] f32; out [P, 3] f32.
// X*Y*Z < 2^31.
extern "C" int hc_interp(const void* u, const void* pos, const void* active,
                         const void* flags, void* out, int P, int X, int Y, int Z,
                         void* stream) {
  if (P > 0) {
    interp_kernel<<<(P + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)u, (const float*)pos, (const float*)active, (const uint8_t*)flags,
        (float*)out, P, X, Y, Z);
  }
  return (int)cudaGetLastError();
}
