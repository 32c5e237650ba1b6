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
// Two launches, on one device and on the x mesh alike
// (hemocell_tpu/parallel/sharded_step.py:524-575):
//   1. hc_le_pair_collide: a thread a column of the (slab's) two wrap
//      planes collides its node with d3q19::collide_node (flag 0, the
//      node's own force and omega: the scalar or the omega field's value)
//      into the pair [19, X, Y, 2] (side 0 the top z = Z-1, 1 the bottom).
//      On the x mesh the ranks gather their pairs along x, since the
//      displaced donors of a column lie anywhere along x.
//   2. hc_le_planes_from_pair: a thread a column of each corrected plane
//      reads its two donors from the pair, top x + i0 and x + i0 + 1,
//      bottom x - i0 and x - i0 - 1 (mod X), the donors of the displaced
//      image above and below; interpolates (1 - frac) a + frac b; and adds
//      feq(rho, u -/+ U) - feq(rho, u) with rho = 1 + sum h and u = mom /
//      rho of the sampled populations (-U on the top plane, +U on the
//      bottom; feq the full equilibrium of lbm.equilibrium).
//   The host passes i0 and frac, split from the displacement it carries as
//   a CPU scalar, so the step never waits for the card.  Each node is
//   collided once, not once for each of the two columns it is a donor of.
//
// Bound on the H100: bytes.  Launch 1 must read 19 f32 and 3 force f32 (and
// the omega value) of each of the 2 X Y wrap-plane nodes and write its 19
// f32 of the pair; launch 2 reads the pair once and writes 38 f32 a
// column: at 128 x 128 about 5.4 and 5.0 MB, 0.0016 and 0.0015 ms at
// 3.35 TB/s.
// A node's populations lie Z floats apart, so every read of launch 1 is a
// 32-byte sector of its own (8x the bytes used, which the design cannot
// avoid: the planes are strided in the layout).  Launch 2's two donors of
// a column are the neighbouring column's too, so they mostly hit L2;
// threads run along y, so the 38 writes of a warp are coalesced rows of
// the [38, X, Y] output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d3q19_collide.cuh"

namespace {

// The correction of one column of one plane from its two collided donors a
// and b: the interpolation at frac, then the Galilean shift of the
// equilibrium part (-U on the top plane, side 0; +U on the bottom, side 1),
// written to planes[side * 19 + q][xy].
__device__ __forceinline__ void correct_column(const float* a, const float* b, float frac,
                                               float shear_velocity, int side,
                                               float* __restrict__ planes, long long xy,
                                               long long XY) {
  D3Q19_TABLES
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

// The collision of the node g (flag 0, its own force and omega) into out.
__device__ __forceinline__ void collide_at(const float* __restrict__ f,
                                           const float* __restrict__ force,
                                           const float* __restrict__ omega_field, float omega,
                                           long long g, long long N, float (&out)[19]) {
  float h[19];
#pragma unroll
  for (int q = 0; q < 19; ++q) h[q] = f[q * N + g];
  const float om = omega_field ? omega_field[g] : omega;
  d3q19::collide_node(h, out, 0, force[g], force[N + g], force[2 * N + g], om, false, 0.f,
                      0.f, 0.f, false, 0.f);
}

// Launch 1: the (slab's) two wrap planes collided, [19, X, Y, 2] (side 0
// the top z = Z-1, side 1 the bottom z = 0), a thread a column.
__global__ void le_pair_collide_kernel(const float* __restrict__ f,
                                       const float* __restrict__ force,
                                       const float* __restrict__ omega_field, float omega,
                                       float* __restrict__ pair, int X, int Y, int Z) {
  const long long XY = (long long)X * Y;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * XY) return;
  const int side = (int)(t % 2);
  const long long xy = t / 2;
  const int z = side == 0 ? Z - 1 : 0;
  float post[19];
  collide_at(f, force, omega_field, omega, xy * Z + z, XY * Z, post);
#pragma unroll
  for (int q = 0; q < 19; ++q) pair[(q * XY + xy) * 2 + side] = post[q];
}

// Launch 2: the corrected planes [38, X, Y] of the whole width from the
// (gathered) post-collision pair [19, X, Y, 2].
__global__ void le_planes_from_pair_kernel(const float* __restrict__ pair, int i0, float frac,
                                           float shear_velocity, float* __restrict__ planes,
                                           int X, int Y) {
  const long long XY = (long long)X * Y;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * XY) return;
  const int side = t < XY ? 0 : 1;
  const long long xy = t - side * XY;
  const int x = (int)(xy / Y);
  const int y = (int)(xy - (long long)x * Y);
  const int sign = side == 0 ? 1 : -1;
  const long long ca = (long long)d3q19::pmod(x + sign * i0, X) * Y + y;
  const long long cb = (long long)d3q19::pmod(x + sign * (i0 + 1), X) * Y + y;
  float a[19], b[19];
#pragma unroll
  for (int q = 0; q < 19; ++q) {
    a[q] = pair[(q * XY + ca) * 2 + side];
    b[q] = pair[(q * XY + cb) * 2 + side];
  }
  correct_column(a, b, frac, shear_velocity, side, planes, xy, XY);
}

}  // namespace

// f [19, X, Y, Z] and force [3, X, Y, Z] of the all-fluid box or of one
// rank's x-slab; omega_field [X, Y, Z] or null (then the scalar omega): the
// collided wrap planes into pair [19, X, Y, 2] ...
extern "C" int hc_le_pair_collide(const void* f, const void* force, const void* omega_field,
                                  float omega, void* pair, int X, int Y, int Z, void* stream) {
  const long long columns = 2LL * X * Y;
  const int threads = 64;
  const unsigned blocks = (unsigned)((columns + threads - 1) / threads);
  le_pair_collide_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)f, (const float*)force, (const float*)omega_field, omega, (float*)pair, X,
      Y, Z);
  return (int)cudaGetLastError();
}

// ... and, from the pair of the whole width (on the x mesh gathered from
// the ranks) and i0 and frac, the integer and fractional part of the
// displacement wrapped into [0, X), the corrected planes [38, X, Y].
extern "C" int hc_le_planes_from_pair(const void* pair, int i0, float frac,
                                      float shear_velocity, void* planes, int X, int Y,
                                      void* stream) {
  const long long columns = 2LL * X * Y;
  const int threads = 64;
  const unsigned blocks = (unsigned)((columns + threads - 1) / threads);
  le_planes_from_pair_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)pair, i0, frac, shear_velocity, (float*)planes, X, Y);
  return (int)cudaGetLastError();
}
