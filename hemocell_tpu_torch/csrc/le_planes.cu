// K7's corrected planes: the two Lees-Edwards wrap planes of one step,
// collided, displaced and shifted to the moving frame, for the launch of K1
// with its le_planes operand that follows (stream_collide.cu).
//
// Replaces: hemocell_tpu/fluid/lees_edwards.py::le_stream_collide_pallas,
//   the part computed outside its kernel in jnp (_corrected_planes,
//   lees_edwards.py:110-139, which XLA fuses under jit) and substituted
//   inside it (pallas_lbm.py, le_sub).  Computes exactly
//   lees_edwards._corrected_planes of hemocell_tpu_torch/fluid/
//   lees_edwards.py, the plain version, on the all-fluid box: packed
//   [38, X, Y], the top plane z = Z-1 in 0:19 and the bottom z = 0 in 19:38.
//
// For each column (x, y) of each plane one thread
//   * collides the two donor nodes with d3q19::collide_node (flag 0, the
//     donor's own force and omega: the scalar or the omega field's value):
//     top x + i0 and x + i0 + 1, bottom x - i0 and x - i0 - 1 (mod X), the
//     donors of the displaced image above and below;
//   * interpolates (1 - frac) a + frac b;
//   * adds feq(rho, u -/+ U) - feq(rho, u) with rho = 1 + sum h and
//     u = mom / rho of the sampled populations (-U on the top plane, +U on
//     the bottom; feq the full equilibrium of lbm.equilibrium).
//   The host passes i0 and frac, split from the displacement it carries as
//   a CPU scalar, so the step never waits for the card.
//
// Bound on the H100: bytes.  It must read 19 f32 and 3 force f32 (and the
//   omega value) of the 2 X Y donor columns and write 38 f32 per column:
//   at 128 x 128 about 5 MB, 0.0016 ms at 3.35 TB/s; the two collisions
//   per thread are some 1,400 flops, 0.0003 ms.  A column's populations
//   lie Z floats apart, so every read is a 32-byte sector of its own (8x
//   the bytes used, which the design cannot avoid: the planes are strided
//   in the layout); the second donor of a column is the first of the
//   neighbouring column's, so it mostly hits L2.  Threads run along y, so
//   the 38 writes of a warp are coalesced rows of the [38, X, Y] output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d3q19_collide.cuh"

namespace {

__global__ void le_planes_kernel(const float* __restrict__ f, const float* __restrict__ force,
                                 const float* __restrict__ omega_field, float omega, int i0,
                                 float frac, float shear_velocity, float* __restrict__ planes,
                                 int X, int Y, int Z) {
  D3Q19_TABLES
  const long long XY = (long long)X * Y;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * XY) return;
  const int side = t < XY ? 0 : 1;  // 0 the top plane z = Z-1, 1 the bottom z = 0
  const long long xy = t - side * XY;
  const int x = (int)(xy / Y);
  const int y = (int)(xy - (long long)x * Y);
  const int z = side == 0 ? Z - 1 : 0;
  const int sign = side == 0 ? 1 : -1;
  const long long N = XY * Z;

  // the donors x + sign i0 and x + sign (i0 + 1) of the displaced image,
  // all their operands loaded before either collides
  const long long ga = ((long long)d3q19::pmod(x + sign * i0, X) * Y + y) * Z + z;
  const long long gb = ((long long)d3q19::pmod(x + sign * (i0 + 1), X) * Y + y) * Z + z;
  float ha[19], hb[19], Fa[3], Fb[3];
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    ha[q] = f[q * N + ga];
    hb[q] = f[q * N + gb];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Fa[k] = force[k * N + ga];
    Fb[k] = force[k * N + gb];
  }
  const float oma = omega_field ? omega_field[ga] : omega;
  const float omb = omega_field ? omega_field[gb] : omega;
  float a[19], b[19];
  d3q19::collide_node(ha, a, 0, Fa[0], Fa[1], Fa[2], oma, false, 0.f, 0.f, 0.f, false, 0.f);
  d3q19::collide_node(hb, b, 0, Fb[0], Fb[1], Fb[2], omb, false, 0.f, 0.f, 0.f, false, 0.f);

  float s[19];
  const float keep = 1.0f - frac;
  float sum = 0.f, mx = 0.f, my = 0.f, mz = 0.f;
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    s[q] = keep * a[q] + frac * b[q];
    sum += s[q];
    mx += kCX[q] * s[q];
    my += kCY[q] * s[q];
    mz += kCZ[q] * s[q];
  }
  // the Galilean shift of the equilibrium part to the moving frame
  const float rho = 1.0f + sum;
  const float ux = mx / rho, uy = my / rho, uz = mz / rho;
  const float vx = ux + (side == 0 ? -shear_velocity : shear_velocity);
  const float usq = ux * ux + uy * uy + uz * uz;
  const float vsq = vx * vx + uy * uy + uz * uz;
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    const float cu = d3q19::dot_c(kCX[q], kCY[q], kCZ[q], ux, uy, uz);
    const float cv = d3q19::dot_c(kCX[q], kCY[q], kCZ[q], vx, uy, uz);
    const float wr = d3q19::weight(q) * rho;
    const float feq_v = wr * (1.0f + 3.0f * cv + 4.5f * cv * cv - 1.5f * vsq);
    const float feq_u = wr * (1.0f + 3.0f * cu + 4.5f * cu * cu - 1.5f * usq);
    planes[(side * 19 + q) * XY + xy] = s[q] + (feq_v - feq_u);
  }
}

}  // namespace

// f [19, X, Y, Z] and force [3, X, Y, Z] of the all-fluid box; omega_field
// [X, Y, Z] or null (then the scalar omega); i0 and frac the integer and
// fractional part of the displacement wrapped into [0, X); planes
// [38, X, Y] the output.
extern "C" int hc_le_planes(const void* f, const void* force, const void* omega_field,
                            float omega, int i0, float frac, float shear_velocity,
                            void* planes, int X, int Y, int Z, void* stream) {
  const long long columns = 2LL * X * Y;
  const int threads = 64;  // 512 blocks at 128 x 128: every SM holds some
  const unsigned blocks = (unsigned)((columns + threads - 1) / threads);
  le_planes_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)f, (const float*)force, (const float*)omega_field, omega, i0, frac,
      shear_velocity, (float*)planes, X, Y, Z);
  return (int)cudaGetLastError();
}
