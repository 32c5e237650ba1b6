// K10: one D3Q19 BGK+Guo stream-collide step, tiled over (x, y) with a pull
// stream through shared memory, for large cross-sections (256^3).
//
// Replaces: hemocell_tpu/fluid/pallas_lbm_2d.py::stream_collide_pallas_2d
//   (kernel body _kernel2d).  Computes lbm.stream_collide of
//   hemocell_tpu_torch/fluid/lbm.py, the plain version, and the same output
//   as K1: force as a [3, X, Y, Z] field, uniform [3] or none; wall,
//   velocity and pressure nodes; scalar omega; periodic; no Lees-Edwards
//   planes.
//
// Halo mode (hc_stream_collide_2d_halo), the TPU kernel's halos= operand
//   (pallas_lbm_2d.py, the x-edge regions of the first and last x program
//   taken from the neighbours' rows): the kernel on one rank's x-slab.  The
//   tile loader reads slab x = -1 and x = X from the rows of halo_rows.cuh
//   (f, force, flags, bc velocity) instead of wrapping; y and z stay
//   periodic.  The plain version is fluid/halo.py::stream_collide_halo_plain.
//
// Bound on the H100: bytes.  19 f32 read and 19 written per node plus the
//   flag byte, 153 B per node with a uniform force (256^3: 0.766 ms) and 165
//   B with a force field (0.826 ms), over 3.35 TB/s; the collision is about
//   350 flops per node (0.088 ms at 67 TFLOP/s).
//
// Design: the TPU kernel owns a [tx, ty, Z] tile, fetches the 8 halo pieces
//   around it in (x, y), collides the 9 regions and assembles the pulled
//   output.  Here a block owns a 4 x 4 tile in (x, y) over a z-chunk of 32:
//   it loads the tile with a one-node halo in all three axes (6 x 6 x 34
//   nodes, periodic wrap by modular index) together with flags, force and
//   bc velocity, collides every node once in registers
//   (d3q19::collide_node, the function K1 calls) and keeps the
//   post-collision populations in shared memory (93,024 B, so two blocks
//   share an SM and one loads while the other writes).  After one barrier
//   every thread PULLS: node x takes population q from x - c_q in the tile,
//   so each global write is the thread's own node, 32 consecutive z per
//   warp: 19 coalesced 128-byte rows, where K1 pushes to 19 neighbours.
//   The price is the halo: 1,224 nodes are read and collided for 512
//   written (2.39x); the halo reads mostly hit L2, where the neighbouring
//   block's tile has just been.  Larger tiles have less halo but leave one
//   block per SM, and came out slower on the card; so did z-chunks that
//   are not whole 128-byte rows.
//
//   The tile is a compile-time constant; shapes it does not divide are
//   handled by guards on the write.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d3q19_collide.cuh"
#include "halo_rows.cuh"

namespace {

constexpr int kThreads = 384;
constexpr int kBlocksPerSM = 2;
constexpr int IX = 4, IY = 4, IZ = 32;           // the nodes a block writes
constexpr int TX = IX + 2, TY = IY + 2, TZ = IZ + 2;  // with the halo
constexpr int kNodes = TX * TY * TZ;
constexpr size_t kSharedBytes = (size_t)kNodes * 19 * sizeof(float);

// force_mode: 0 none, 1 uniform (fu), 2 field [3, X, Y, Z].  HALO: the
// slab kernel with the neighbours' x rows in place of the periodic wrap.
template <bool HALO>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) stream_collide_2d_kernel(
    const float* __restrict__ f, float* __restrict__ out,
    const float* __restrict__ force, int force_mode, float fux, float fuy, float fuz,
    float omega, const uint8_t* __restrict__ flags, const float* __restrict__ bc_vel,
    int has_rho0, float rho0, HaloRows rows, int X, int Y, int Z) {
  D3Q19_TABLES
  extern __shared__ float s[];  // [19][kNodes] post-collision populations

  const long long YZ = (long long)Y * Z;
  const long long N = (long long)X * YZ;
  const int ox = blockIdx.x * IX - 1, oy = blockIdx.y * IY - 1, oz = blockIdx.z * IZ - 1;

  // collide tile and halo; tile node (i, j, l) is lattice node
  // (ox + i, oy + j, oz + l) of the periodic lattice, or in halo mode a
  // node of a neighbour's row where ox + i is -1 or X
  for (int n = threadIdx.x; n < kNodes; n += kThreads) {
    const int l = n % TZ, j = (n / TZ) % TY, i = n / (TZ * TY);
    const int gy = d3q19::pmod(oy + j, Y), gz = d3q19::pmod(oz + l, Z);
    const long long r = (long long)gy * Z + gz;
    // the rows also stand in beyond x = X, where a tile overhangs a slab it
    // does not divide: those nodes feed no written node
    const int side = HALO ? (ox + i < 0 ? 0 : (ox + i >= X ? 1 : -1)) : -1;
    const long long g = side < 0 ? (long long)(HALO ? ox + i : d3q19::pmod(ox + i, X)) * YZ + r
                                 : r;
    const long long st = side < 0 ? N : YZ;
    const float* fp = side < 0 ? f : pick(rows.f, side);
    const uint8_t* flp = side < 0 ? flags : pick(rows.flags, side);
    const float* fop = side < 0 ? force : pick(rows.force, side);
    const float* bcp = side < 0 ? bc_vel : pick(rows.bc, side);
    float h[19];
#pragma unroll
    for (int q = 0; q < 19; ++q) h[q] = fp[q * st + g];
    const uint8_t flag = flp ? flp[g] : (uint8_t)0;
    const bool velocity_node = flag == d3q19::kVelocity && bcp != nullptr;
    float bux = 0.f, buy = 0.f, buz = 0.f;
    float Fx = 0.f, Fy = 0.f, Fz = 0.f;
    if (velocity_node) {
      bux = bcp[g]; buy = bcp[st + g]; buz = bcp[2 * st + g];
    } else if (flag != d3q19::kWall) {
      if (force_mode == 1) {
        Fx = fux; Fy = fuy; Fz = fuz;
      } else if (force_mode == 2) {
        Fx = fop[g]; Fy = fop[st + g]; Fz = fop[2 * st + g];
      }
    }
    float res[19];
    d3q19::collide_node(h, res, flag, Fx, Fy, Fz, omega, velocity_node, bux, buy, buz,
                        has_rho0 != 0, rho0);
#pragma unroll
    for (int q = 0; q < 19; ++q) s[q * kNodes + n] = res[q];
  }
  __syncthreads();

  // pull: population q of a node comes from its neighbour at -c_q
  for (int r = threadIdx.x; r < IX * IY * IZ; r += kThreads) {
    const int l = r % IZ, j = (r / IZ) % IY, i = r / (IZ * IY);
    const int gx = blockIdx.x * IX + i, gy = blockIdx.y * IY + j, gz = blockIdx.z * IZ + l;
    if (gx >= X || gy >= Y || gz >= Z) continue;
    const long long g = ((long long)gx * Y + gy) * Z + gz;
    const int n = ((i + 1) * TY + (j + 1)) * TZ + (l + 1);
#pragma unroll
    for (int q = 0; q < 19; ++q)
      out[q * N + g] = s[q * kNodes + n - ((kCX[q] * TY + kCY[q]) * TZ + kCZ[q])];
  }
}

template <bool HALO>
int launch(const void* f, void* out, const void* force, int force_mode, float fux, float fuy,
           float fuz, float omega, const void* flags, const void* bc_vel, int has_rho0,
           float rho0, const HaloRows& rows, int X, int Y, int Z, void* stream) {
  // more than 48 KB of shared memory must be asked for per kernel
  cudaError_t err = cudaFuncSetAttribute(stream_collide_2d_kernel<HALO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSharedBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((X + IX - 1) / IX, (Y + IY - 1) / IY, (Z + IZ - 1) / IZ);
  stream_collide_2d_kernel<HALO><<<grid, kThreads, kSharedBytes, (cudaStream_t)stream>>>(
      (const float*)f, (float*)out, (const float*)force, force_mode, fux, fuy, fuz,
      omega, (const uint8_t*)flags, (const float*)bc_vel, has_rho0, rho0, rows, X, Y, Z);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hc_stream_collide_2d(
    const void* f, void* out, const void* force, int force_mode,
    float fux, float fuy, float fuz, float omega, const void* flags,
    const void* bc_vel, int has_rho0, float rho0, int X, int Y, int Z, void* stream) {
  return launch<false>(f, out, force, force_mode, fux, fuy, fuz, omega, flags, bc_vel,
                       has_rho0, rho0, HaloRows{}, X, Y, Z, stream);
}

// The slab [X, Y, Z] with its neighbours' rows: ``rows`` holds the twelve
// row pointers of halo_rows.cuh (f, force, flags and bc are read).
extern "C" int hc_stream_collide_2d_halo(
    const void* f, void* out, const void* force, int force_mode,
    float fux, float fuy, float fuz, float omega, const void* flags,
    const void* bc_vel, int has_rho0, float rho0, const void* const* rows, int X, int Y,
    int Z, void* stream) {
  return launch<true>(f, out, force, force_mode, fux, fuy, fuz, omega, flags, bc_vel,
                      has_rho0, rho0, halo_rows_from(rows), X, Y, Z, stream);
}
