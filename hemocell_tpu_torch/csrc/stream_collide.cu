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
//   x-sample and Galilean equilibrium shift) come from the launch before,
//   le_planes.cu, as the TPU path computes them outside its kernel.  Same
//   bound as K1 plus the
//   planes: 38 f32 per (x, y) column, 2/Z of the population traffic.
//
// Halo mode (hc_stream_collide_halo): the kernel on one rank's x-slab.
//   Replaces: hemocell_tpu/fluid/sharded_pallas.py::make_sharded_stream_collide
//   (stream_collide_pallas(halos=), the TPU kernel with its x-neighbour rows
//   as operands).  Computes lbm.stream_collide on the slab extended by the
//   neighbours' rows (halo_rows.cuh), sliced back to the slab: the plain
//   version fluid/halo.py::stream_collide_halo_plain.  The TPU kernel pulls
//   from the rows; K1 pushes, so it launches over the X + 2 rows: a thread
//   on a neighbour's row reads that row's operands, collides with the same
//   d3q19::collide_node and pushes only the populations that land in the
//   slab, and a thread of the slab drops the pushes that leave it in x
//   (they are the neighbour's).  y and z stay periodic.  Every node of the
//   slab so receives exactly what one whole-domain launch gives it, bit for
//   bit.  Bound: K1's bytes plus the two rows (2/X of the traffic).

#include <cuda_runtime.h>
#include <stdint.h>

#include "d3q19_collide.cuh"
#include "halo_rows.cuh"

namespace {

// The collide and push of one node.  Its operands sit at index g of
// channel planes s apart (the slab: s = X*Y*Z; a neighbour's row: s = Y*Z);
// le_planes is [38, lX, Y] with the node in column lx.  HALO drops the
// pushes that leave the slab in x instead of wrapping them.
template <bool HALO>
__device__ __forceinline__ void collide_push(
    const float* __restrict__ f, long long g, long long s, float* __restrict__ out,
    const float* __restrict__ force, int force_mode, float fux, float fuy, float fuz,
    const float* __restrict__ omega_field, float omega,
    const uint8_t* __restrict__ flags, const float* __restrict__ bc_vel,
    int has_rho0, float rho0, const float* __restrict__ le_planes, int lx, int lX,
    int x, int y, int z, int X, int Y, int Z) {
  D3Q19_TABLES
  const long long N = (long long)X * Y * Z;
  float h[19];
#pragma unroll
  for (int i = 0; i < 19; ++i) h[i] = f[i * s + g];
  const uint8_t flag = flags ? flags[g] : 0;

  // the collision itself is d3q19::collide_node, shared with K8-K10
  const bool velocity_node = flag == d3q19::kVelocity && bc_vel != nullptr;
  float bux = 0.f, buy = 0.f, buz = 0.f;
  float Fx = 0.f, Fy = 0.f, Fz = 0.f;
  if (velocity_node) {
    bux = bc_vel[g]; buy = bc_vel[s + g]; buz = bc_vel[2 * s + g];
  } else if (flag != d3q19::kWall) {
    if (force_mode == 1) {
      Fx = fux; Fy = fuy; Fz = fuz;
    } else if (force_mode == 2) {
      Fx = force[g]; Fy = force[s + g]; Fz = force[2 * s + g];
    } else if (force_mode == 3) {
      Fx = force[0]; Fy = force[1]; Fz = force[2];
    }
  }
  const float om = omega_field ? omega_field[g] : omega;
  float res[19];
  d3q19::collide_node(h, res, flag, Fx, Fy, Fz, om, velocity_node, bux, buy, buz,
                      has_rho0 != 0, rho0);

#pragma unroll
  for (int i = 0; i < 19; ++i) {
    int dx = x + kCX[i], dy = y + kCY[i], dz = z + kCZ[i];
    if (HALO) {
      if (dx < 0 || dx >= X) continue;  // the neighbour's node
    } else {
      dx = dx < 0 ? dx + X : (dx >= X ? dx - X : dx);
    }
    dy = dy < 0 ? dy + Y : (dy >= Y ? dy - Y : dy);
    dz = dz < 0 ? dz + Z : (dz >= Z ? dz - Z : dz);
    float v = res[i];
    if (le_planes != nullptr) {
      // Lees-Edwards: populations leaving through a z face come from the
      // pre-corrected planes (top 0:19, bottom 19:38)
      if (kCZ[i] == 1 && z == Z - 1) v = le_planes[((long long)i * lX + lx) * Y + y];
      if (kCZ[i] == -1 && z == 0) v = le_planes[((long long)(19 + i) * lX + lx) * Y + y];
    }
    out[i * N + ((long long)dx * Y + dy) * Z + dz] = v;
  }
}

// force_mode: 0 none, 1 uniform (fu), 2 field [3, X, Y, Z], 3 uniform read
// from the 3 floats at ``force`` in device memory (a force the card computed,
// which the host never reads: the preInlet's adaptive drive).  HALO: the
// slab kernel with the neighbours' rows (halo_rows.cuh) in place of the
// periodic wrap in x; its threads cover the rows x = -1 .. X, and the two
// neighbours' rows take their operands from the rows.
template <bool HALO>
__global__ void stream_collide_kernel(
    const float* __restrict__ f, float* __restrict__ out,
    const float* __restrict__ force, int force_mode, float fux, float fuy, float fuz,
    const float* __restrict__ omega_field, float omega,
    const uint8_t* __restrict__ flags, const float* __restrict__ bc_vel,
    int has_rho0, float rho0, const float* __restrict__ le_planes, HaloRows rows,
    int X, int Y, int Z) {
  const long long YZ = (long long)Y * Z;
  const long long N = (long long)X * YZ;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x - (HALO ? YZ : 0);
  if (n >= (HALO ? N + YZ : N)) return;
  if (HALO && (n < 0 || n >= N)) {
    // a node of the row x = -1 (side 0) or x = X (side 1): the operands of
    // the neighbour's row, pushes into the slab only
    const int side = n < 0 ? 0 : 1;
    const long long r = side ? n - N : n + YZ;
    const int ri = (int)r;
    collide_push<true>(pick(rows.f, side), r, YZ, out,
                       force_mode == 3 ? force : pick(rows.force, side), force_mode,
                       fux, fuy, fuz, pick(rows.omega, side), omega, pick(rows.flags, side),
                       pick(rows.bc, side), has_rho0, rho0, pick(rows.le, side), 0, 1,
                       side ? X : -1, ri / Z, ri % Z, X, Y, Z);
    return;
  }
  const int x = (int)(n / YZ);
  const int r = (int)(n - (long long)x * YZ);
  collide_push<HALO>(f, n, N, out, force, force_mode, fux, fuy, fuz, omega_field, omega,
                     flags, bc_vel, has_rho0, rho0, le_planes, x, X, x, r / Z, r % Z, X, Y,
                     Z);
}

template <bool HALO>
int launch(const void* f, void* out, const void* force, int force_mode, float fux, float fuy,
           float fuz, const void* omega_field, float omega, const void* flags,
           const void* bc_vel, int has_rho0, float rho0, const void* le_planes,
           const HaloRows& rows, int X, int Y, int Z, void* stream) {
  const long long nodes = (long long)(HALO ? X + 2 : X) * Y * Z;
  const int threads = 256;
  const unsigned blocks = (unsigned)((nodes + threads - 1) / threads);
  stream_collide_kernel<HALO><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)f, (float*)out, (const float*)force, force_mode, fux, fuy, fuz,
      (const float*)omega_field, omega, (const uint8_t*)flags, (const float*)bc_vel,
      has_rho0, rho0, (const float*)le_planes, rows, X, Y, Z);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hc_stream_collide(
    const void* f, void* out, const void* force, int force_mode,
    float fux, float fuy, float fuz, const void* omega_field, float omega,
    const void* flags, const void* bc_vel, int has_rho0, float rho0,
    const void* le_planes, int X, int Y, int Z, void* stream) {
  return launch<false>(f, out, force, force_mode, fux, fuy, fuz, omega_field, omega, flags,
                       bc_vel, has_rho0, rho0, le_planes, HaloRows{}, X, Y, Z, stream);
}

// The slab [X, Y, Z] with its neighbours' rows: ``rows`` holds the twelve
// row pointers of halo_rows.cuh (null where the operand is absent).
extern "C" int hc_stream_collide_halo(
    const void* f, void* out, const void* force, int force_mode,
    float fux, float fuy, float fuz, const void* omega_field, float omega,
    const void* flags, const void* bc_vel, int has_rho0, float rho0,
    const void* le_planes, const void* const* rows, int X, int Y, int Z, void* stream) {
  return launch<true>(f, out, force, force_mode, fux, fuy, fuz, omega_field, omega, flags,
                      bc_vel, has_rho0, rho0, le_planes, halo_rows_from(rows), X, Y, Z,
                      stream);
}
