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
// Design: one thread per vertex; it builds the same renormalised,
//   fluid-masked stencil as the spread and gathers the 8 corners of the 3
//   velocity channels.  The gathers are scattered but a cell's vertices are
//   neighbours in memory and in space, so most corners hit L2.  No sort,
//   window or un-sort pass: the TPU kernel's x-slab windows and
//   multi-payload un-sort exist only because TPU gathers are slow.

#include "ibm_stencil.cuh"

namespace {

__global__ void interp_kernel(const float* __restrict__ u, const float* __restrict__ pos,
                              const float* __restrict__ active,
                              const uint8_t* __restrict__ flags, float* __restrict__ out,
                              int P, int X, int Y, int Z) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float act = active[p];
  float vx = 0.f, vy = 0.f, vz = 0.f;
  if (act != 0.f) {
    hc::Stencil s;
    hc::trilinear_stencil(pos + 3 * p, flags, X, Y, Z, act, s);
    const long long N = (long long)X * Y * Z;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float w = s.w[k];
      if (w == 0.f) continue;
      vx += w * u[s.node[k]];
      vy += w * u[N + s.node[k]];
      vz += w * u[2 * N + s.node[k]];
    }
  }
  out[3 * p] = vx;
  out[3 * p + 1] = vy;
  out[3 * p + 2] = vz;
}

}  // namespace

// u [3, X, Y, Z] f32; pos [P, 3] f32; active [P] f32; out [P, 3] f32.
extern "C" int hc_interp(const void* u, const void* pos, const void* active,
                         const void* flags, void* out, int P, int X, int Y, int Z,
                         void* stream) {
  if (P > 0) {
    const int threads = 256;
    interp_kernel<<<(P + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const float*)u, (const float*)pos, (const float*)active, (const uint8_t*)flags,
        (float*)out, P, X, Y, Z);
  }
  return (int)cudaGetLastError();
}
