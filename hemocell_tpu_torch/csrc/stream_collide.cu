// K1: fused D3Q19 BGK+Guo collide + push stream on deviation populations.
//
// Replaces: hemocell_tpu/fluid/pallas_lbm.py::stream_collide_pallas
//   (kernel body _kernel / _collide_local).  Computes exactly
//   lbm.stream(lbm.collide(f, force, omega, flags, bc_velocity, bc_density))
//   of hemocell_tpu_torch/fluid/lbm.py, the plain version.
//
// Bound on the H100: bytes.  Per node the step must read 19 f32
//   populations, 1 flag byte and (force as a field) 12 force bytes, and
//   write 19 f32 populations: ~165 B/node against a few hundred flops, far
//   below the card's ~20 flop/byte f32 balance point.
//
// Design: one thread per node, z fastest, so the 19 population reads of a
//   warp are 19 coalesced 128-byte rows.  The thread collides in registers
//   and pushes population i to x + c_i (periodic wrap) in a second buffer;
//   those writes are coalesced too, as the destination offset is the same
//   for the whole warp except where a row wraps.  No shared memory and no
//   halo: every byte is read and written exactly once.  The TPU kernel's
//   slab windows, lane folding and VMEM sizing have no analog here.
//   Faster variants (pull stream, shared-memory tiles, TMA) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int kCX[19] = {0, -1, 1, 0, 0, 0, 0, -1, 1, -1, 1, -1, 1, -1, 1, 0, 0, 0, 0};
__constant__ int kCY[19] = {0, 0, 0, -1, 1, 0, 0, -1, 1, 1, -1, 0, 0, 0, 0, -1, 1, -1, 1};
__constant__ int kCZ[19] = {0, 0, 0, 0, 0, -1, 1, 0, 0, 0, 0, -1, 1, 1, -1, -1, 1, 1, -1};
__constant__ int kOPP[19] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15, 18, 17};
__constant__ float kW[19] = {
    1.0f / 3.0f,
    1.0f / 18.0f, 1.0f / 18.0f, 1.0f / 18.0f, 1.0f / 18.0f, 1.0f / 18.0f, 1.0f / 18.0f,
    1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f,
    1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f, 1.0f / 36.0f};

constexpr uint8_t kWall = 1;
constexpr uint8_t kVelocity = 2;
constexpr uint8_t kPressure = 3;

// force_mode: 0 none, 1 uniform (fu), 2 field [3, X, Y, Z]
__global__ void stream_collide_kernel(
    const float* __restrict__ f, float* __restrict__ out,
    const float* __restrict__ force, int force_mode, float fux, float fuy, float fuz,
    const float* __restrict__ omega_field, float omega,
    const uint8_t* __restrict__ flags, const float* __restrict__ bc_vel,
    int has_rho0, float rho0, int X, int Y, int Z) {
  const long long N = (long long)X * Y * Z;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int z = (int)(n % Z);
  const long long t = n / Z;
  const int y = (int)(t % Y);
  const int x = (int)(t / Y);

  float h[19];
#pragma unroll
  for (int i = 0; i < 19; ++i) h[i] = f[i * N + n];
  const uint8_t flag = flags ? flags[n] : 0;

  float res[19];
  if (flag == kWall) {
#pragma unroll
    for (int i = 0; i < 19; ++i) res[i] = h[kOPP[i]];
  } else if (flag == kVelocity && bc_vel != nullptr) {
    const float ux = bc_vel[n], uy = bc_vel[N + n], uz = bc_vel[2 * N + n];
#pragma unroll
    for (int i = 0; i < 19; ++i) {
      const float cu = kCX[i] * ux + kCY[i] * uy + kCZ[i] * uz;
      res[i] = h[kOPP[i]] + 6.0f * kW[i] * cu;
    }
  } else {
    float Fx = 0.f, Fy = 0.f, Fz = 0.f;
    if (force_mode == 1) {
      Fx = fux; Fy = fuy; Fz = fuz;
    } else if (force_mode == 2) {
      Fx = force[n]; Fy = force[N + n]; Fz = force[2 * N + n];
    }
    float rho = 1.0f, mx = 0.f, my = 0.f, mz = 0.f;
#pragma unroll
    for (int i = 0; i < 19; ++i) {
      rho += h[i];
      mx += kCX[i] * h[i];
      my += kCY[i] * h[i];
      mz += kCZ[i] * h[i];
    }
    const float ux = (mx + 0.5f * Fx) / rho;
    const float uy = (my + 0.5f * Fy) / rho;
    const float uz = (mz + 0.5f * Fz) / rho;
    const float usq = ux * ux + uy * uy + uz * uz;
    const float uF = ux * Fx + uy * Fy + uz * Fz;
    const float om = omega_field ? omega_field[n] : omega;
    const float src = 1.0f - 0.5f * om;
    const bool pressure = (flag == kPressure) && has_rho0;
#pragma unroll
    for (int i = 0; i < 19; ++i) {
      const float cu = kCX[i] * ux + kCY[i] * uy + kCZ[i] * uz;
      const float cF = kCX[i] * Fx + kCY[i] * Fy + kCZ[i] * Fz;
      const float poly = 3.0f * cu + 4.5f * cu * cu - 1.5f * usq;
      const float feq = kW[i] * ((rho - 1.0f) + rho * poly);
      const float S = kW[i] * (3.0f * (cF - uF) + 9.0f * cu * cF);
      float v = h[i] - om * (h[i] - feq) + src * S;
      if (pressure) v += kW[i] * (rho0 - rho) * (1.0f + poly);
      res[i] = v;
    }
  }

#pragma unroll
  for (int i = 0; i < 19; ++i) {
    int dx = x + kCX[i], dy = y + kCY[i], dz = z + kCZ[i];
    dx = dx < 0 ? dx + X : (dx >= X ? dx - X : dx);
    dy = dy < 0 ? dy + Y : (dy >= Y ? dy - Y : dy);
    dz = dz < 0 ? dz + Z : (dz >= Z ? dz - Z : dz);
    out[i * N + ((long long)dx * Y + dy) * Z + dz] = res[i];
  }
}

}  // namespace

extern "C" int hc_stream_collide(
    const void* f, void* out, const void* force, int force_mode,
    float fux, float fuy, float fuz, const void* omega_field, float omega,
    const void* flags, const void* bc_vel, int has_rho0, float rho0,
    int X, int Y, int Z, void* stream) {
  const long long N = (long long)X * Y * Z;
  const int threads = 256;
  const unsigned blocks = (unsigned)((N + threads - 1) / threads);
  stream_collide_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)f, (float*)out, (const float*)force, force_mode, fux, fuy, fuz,
      (const float*)omega_field, omega, (const uint8_t*)flags, (const float*)bc_vel,
      has_rho0, rho0, X, Y, Z);
  return (int)cudaGetLastError();
}
