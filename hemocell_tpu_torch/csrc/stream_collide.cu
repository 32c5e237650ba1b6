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
//
// K7, the Lees-Edwards step, is this kernel with the `le_planes` operand.
//   Replaces: hemocell_tpu/fluid/lees_edwards.py::le_stream_collide_pallas
//   (through stream_collide_pallas(le_planes=), kernel body _kernel le_sub).
//   Computes lees_edwards.stream_with_planes(lbm.collide(f, ...), planes) of
//   hemocell_tpu_torch/fluid/lees_edwards.py, the plain version: a node on
//   the top plane z = Z-1 pushes planes[q] instead of its own post-collision
//   value for every q with c_z = +1, a node on the bottom plane z = 0 pushes
//   planes[19 + q] for c_z = -1 (the substitution is at the source plane,
//   before the stream).  The two corrected planes [38, X, Y] (displaced
//   x-sample and Galilean equilibrium shift) are computed outside, as the
//   TPU path computes them outside its kernel.  Same bound as K1 plus the
//   planes: 38 f32 per (x, y) column, 2/Z of the population traffic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d3q19_collide.cuh"

namespace {

// force_mode: 0 none, 1 uniform (fu), 2 field [3, X, Y, Z]
__global__ void stream_collide_kernel(
    const float* __restrict__ f, float* __restrict__ out,
    const float* __restrict__ force, int force_mode, float fux, float fuy, float fuz,
    const float* __restrict__ omega_field, float omega,
    const uint8_t* __restrict__ flags, const float* __restrict__ bc_vel,
    int has_rho0, float rho0, const float* __restrict__ le_planes,
    int X, int Y, int Z) {
  D3Q19_TABLES
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

  // the collision itself is d3q19::collide_node, shared with K8-K10
  const bool velocity_node = flag == d3q19::kVelocity && bc_vel != nullptr;
  float bux = 0.f, buy = 0.f, buz = 0.f;
  float Fx = 0.f, Fy = 0.f, Fz = 0.f;
  if (velocity_node) {
    bux = bc_vel[n]; buy = bc_vel[N + n]; buz = bc_vel[2 * N + n];
  } else if (flag != d3q19::kWall) {
    if (force_mode == 1) {
      Fx = fux; Fy = fuy; Fz = fuz;
    } else if (force_mode == 2) {
      Fx = force[n]; Fy = force[N + n]; Fz = force[2 * N + n];
    }
  }
  const float om = omega_field ? omega_field[n] : omega;
  float res[19];
  d3q19::collide_node(h, res, flag, Fx, Fy, Fz, om, velocity_node, bux, buy, buz,
                      has_rho0 != 0, rho0);

#pragma unroll
  for (int i = 0; i < 19; ++i) {
    int dx = x + kCX[i], dy = y + kCY[i], dz = z + kCZ[i];
    dx = dx < 0 ? dx + X : (dx >= X ? dx - X : dx);
    dy = dy < 0 ? dy + Y : (dy >= Y ? dy - Y : dy);
    dz = dz < 0 ? dz + Z : (dz >= Z ? dz - Z : dz);
    float v = res[i];
    if (le_planes != nullptr) {
      // Lees-Edwards: populations leaving through a z face come from the
      // pre-corrected planes [38, X, Y] (top 0:19, bottom 19:38)
      if (kCZ[i] == 1 && z == Z - 1) v = le_planes[((long long)i * X + x) * Y + y];
      if (kCZ[i] == -1 && z == 0) v = le_planes[((long long)(19 + i) * X + x) * Y + y];
    }
    out[i * N + ((long long)dx * Y + dy) * Z + dz] = v;
  }
}

}  // namespace

extern "C" int hc_stream_collide(
    const void* f, void* out, const void* force, int force_mode,
    float fux, float fuy, float fuz, const void* omega_field, float omega,
    const void* flags, const void* bc_vel, int has_rho0, float rho0,
    const void* le_planes, int X, int Y, int Z, void* stream) {
  const long long N = (long long)X * Y * Z;
  const int threads = 256;
  const unsigned blocks = (unsigned)((N + threads - 1) / threads);
  stream_collide_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)f, (float*)out, (const float*)force, force_mode, fux, fuy, fuz,
      (const float*)omega_field, omega, (const uint8_t*)flags, (const float*)bc_vel,
      has_rho0, rho0, (const float*)le_planes, X, Y, Z);
  return (int)cudaGetLastError();
}
