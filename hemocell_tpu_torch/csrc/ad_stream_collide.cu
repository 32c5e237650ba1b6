// K6: CEPAC advection-diffusion lattice, D3Q19 BGK collide with the linear
// equilibrium g_eq_i = w_i C (1 + 3 c_i.u), optional Dirichlet nodes, and a
// periodic push stream.
//
// Replaces: hemocell_tpu/fluid/advection_diffusion.py
//   ::ad_stream_collide_pallas (kernel body _ad_kernel).  Computes exactly
//   advection_diffusion.ad_stream_collide(g, u, tau, mask, value) of
//   hemocell_tpu_torch/fluid/advection_diffusion.py, the plain version.
//
// Bound on the H100: bytes.  Per node the step reads 19 f32 populations and
//   3 f32 velocity components (and, with Dirichlet nodes, 1 mask byte and
//   1 f32 value) and writes 19 populations: 164-169 B/node against ~150
//   flops.
//
// Design: as K1 (stream_collide.cu).  One thread per node, z fastest; the
//   thread sums the concentration, collides in registers and pushes
//   population i to x + c_i (periodic) in a second buffer.  Reads and
//   writes are coalesced along z and every byte moves once.  The TPU
//   kernel's x-slab windows and halo rows have no analog.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int kCX[19] = {0, -1, 1, 0, 0, 0, 0, -1, 1, -1, 1, -1, 1, -1, 1, 0, 0, 0, 0};
__constant__ int kCY[19] = {0, 0, 0, -1, 1, 0, 0, -1, 1, 1, -1, 0, 0, 0, 0, -1, 1, -1, 1};
__constant__ int kCZ[19] = {0, 0, 0, 0, 0, -1, 1, 0, 0, 0, 0, -1, 1, 1, -1, -1, 1, 1, -1};
__constant__ float kW[19] = {
    1.0f / 3.0f,
    1.0f / 18.0f, 1.0f / 18.0f, 1.0f / 18.0f, 1.0f / 18.0f, 1.0f / 18.0f, 1.0f / 18.0f,
    1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f,
    1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f};

__global__ void ad_stream_collide_kernel(
    const float* __restrict__ g, const float* __restrict__ u, float inv_tau,
    const uint8_t* __restrict__ mask, const float* __restrict__ value,
    float* __restrict__ out, int X, int Y, int Z) {
  const long long N = (long long)X * Y * Z;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int z = (int)(n % Z);
  const long long t = n / Z;
  const int y = (int)(t % Y);
  const int x = (int)(t / Y);

  float h[19];
  float conc = 0.f;
#pragma unroll
  for (int i = 0; i < 19; ++i) {
    h[i] = g[i * N + n];
    conc += h[i];
  }
  const float ux = u[n], uy = u[N + n], uz = u[2 * N + n];
  const bool dirichlet = mask != nullptr && mask[n] > 0;
  const float cbc = dirichlet ? value[n] : 0.f;

#pragma unroll
  for (int i = 0; i < 19; ++i) {
    const float cu = kCX[i] * ux + kCY[i] * uy + kCZ[i] * uz;
    const float lin = 1.0f + 3.0f * cu;
    const float geq = kW[i] * conc * lin;
    float v = h[i] - inv_tau * (h[i] - geq);
    if (dirichlet) v = kW[i] * cbc * lin;
    int dx = x + kCX[i], dy = y + kCY[i], dz = z + kCZ[i];
    dx = dx < 0 ? dx + X : (dx >= X ? dx - X : dx);
    dy = dy < 0 ? dy + Y : (dy >= Y ? dy - Y : dy);
    dz = dz < 0 ? dz + Z : (dz >= Z ? dz - Z : dz);
    out[i * N + ((long long)dx * Y + dy) * Z + dz] = v;
  }
}

}  // namespace

// g, out [19, X, Y, Z] f32; u [3, X, Y, Z] f32; mask uint8 / value f32
// [X, Y, Z], both null when there are no Dirichlet nodes.
extern "C" int hc_ad_stream_collide(const void* g, const void* u, float inv_tau,
                                    const void* mask, const void* value, void* out,
                                    int X, int Y, int Z, void* stream) {
  const long long N = (long long)X * Y * Z;
  const int threads = 256;
  const unsigned blocks = (unsigned)((N + threads - 1) / threads);
  ad_stream_collide_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)u, inv_tau, (const uint8_t*)mask,
      (const float*)value, (float*)out, X, Y, Z);
  return (int)cudaGetLastError();
}
