// K10: one D3Q19 BGK+Guo stream-collide step for large cross-sections
// (256^3), marching along x through shared memory with a pull stream.
//
// Replaces: hemocell_tpu/fluid/pallas_lbm_2d.py::stream_collide_pallas_2d
//   (kernel body _kernel2d).  Computes lbm.stream_collide of
//   hemocell_tpu_torch/fluid/lbm.py, the plain version, and the same output
//   as K1 bit for bit (both call d3q19::collide_node on the same operands):
//   force as a [3, X, Y, Z] field, uniform [3] or none; wall, velocity and
//   pressure nodes; scalar omega; periodic; no Lees-Edwards planes.
//
// Halo mode (hc_stream_collide_2d_halo), the TPU kernel's halos= operand
//   (pallas_lbm_2d.py, the x-edge regions of the first and last x program
//   taken from the neighbours' rows): the kernel on one rank's x-slab.  The
//   run that starts at slab x = 0 collides plane x = -1 from the lo rows of
//   halo_rows.cuh (f, force, flags, bc velocity), the run that ends at x = X
//   plane X from the hi rows; nothing wraps in x, y and z stay periodic.  The
//   plain version is fluid/halo.py::stream_collide_halo_plain.
//
// Bound on the H100: bytes.  19 f32 read and 19 written per node plus the
//   flag byte, 153 B per node with a uniform force (256^3: 0.766 ms) and 165
//   B with a force field (0.826 ms), over 3.35 TB/s; the collision is about
//   350 flops per node (0.088 ms at 67 TFLOP/s).
//
// Design: the TPU kernel owns an [tx, ty, Z] tile and fetches the 8 halo
//   pieces around it.  Here a block owns a (y, z) tile of TY x 32 nodes (z
//   fastest: one 128-byte row a warp) and a run of consecutive x planes
//   [x0, x1), and marches along x:
//   * each step collides plane x + 1 (one thread per node of the tile with
//     a one-node y/z halo, (TY + 2) x 34 nodes, d3q19::collide_node,
//     periodic wrap by modular index) into a ring in shared memory, then
//     every thread PULLS one node of plane x, population q from its
//     neighbour at -c_q, and writes it: 19 coalesced 128-byte rows a warp,
//     where K1 pushes rows shifted by c_q;
//   * the ring keeps a population only while the pull needs it (c_x = -1
//     one plane, 0 two, +1 three: 38 population planes, not 57); the
//     staging, the ring and the pull are xmarch.cuh, shared with K8/K9;
//   * the populations (and the force field and bc velocity where present)
//     of plane x + 2 are staged by cp.async into a two-plane buffer while
//     plane x + 1 collides and plane x is written; each thread stages and
//     collides the same node, so its cp.async.wait_group alone orders the
//     two; its flag byte goes to a register.  Two barriers a plane: the
//     ring is full before the pull, and read before the next collision.
//   The halo is paid in y and z only, (TY + 2) 34 / (32 TY) collisions a
//   written node (1.33x for 8 x 32, where a 4 x 4 x 32 block tile with a
//   halo in all three axes pays 2.39x), and the x halo twice a run; the
//   halo's reads mostly hit L2, where the neighbouring tiles march at the
//   same x.  The schedule (tiles and runs) comes from
//   fluid/stream_collide_2d.py::schedule: as many runs as give every SM a
//   block, no more (one run over x at 256^3).  Shapes the tile does not
//   divide are handled by the modular index and guards on the write.
//
//   What was measured against it (PERF.md, section 6): 8 x 32 tiles with
//   two blocks an SM, 4 x 32 with three and 12 x 32 with one
//   (scripts/k10_tile_sweep.py times them), and runs of 64 planes; staging
//   3 and 4 planes ahead was slower, the more so the less L1 the shared
//   memory leaves to the 4-byte cp.async, which allocate there; 16-byte
//   cp.async.cg (L2 only) rows and TMA bulk copies of each row (570 small
//   copies a plane) were slower again, and loading the next plane into
//   registers spills.  8 x 32 with one block an SM is the fastest, and
//   still slower than K1, which collides each node once; so
//   stream_collide.py keeps large cross-sections on K1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d3q19_collide.cuh"
#include "halo_rows.cuh"
#include "xmarch.cuh"

namespace {

using xmarch::cp_async4;
using xmarch::cp_async_commit;
using xmarch::kRingPlanes;

// The (y, z) tile: TY x 32 nodes, one block an SM (__launch_bounds__).
// The library is built with these values; scripts/k10_tile_sweep.py
// builds the kernel with others (-DK10_TY, -DK10_MIN_BLOCKS) to time them.
#ifndef K10_TY
#define K10_TY 8
#endif
#ifndef K10_MIN_BLOCKS
#define K10_MIN_BLOCKS 1
#endif
constexpr int TY = K10_TY, TZ = 32, PZ = TZ + 2;
constexpr int kNodes = (TY + 2) * PZ;  // the padded plane
constexpr int kThreads = (kNodes + 31) / 32 * 32;

// The operands of one x plane p of the box (p may be -1 or X): the slab's
// arrays at plane offset off with channel stride st, or in halo mode a
// neighbour's row (off 0, stride Y*Z).
struct PlaneSrc {
  const float* f;
  const float* force;
  const uint8_t* flags;
  const float* bc;
  long long off, st;
};

template <bool HALO>
__device__ __forceinline__ PlaneSrc plane_src(int p, const float* f, const float* force,
                                              const uint8_t* flags, const float* bc,
                                              const HaloRows& rows, int X, long long YZ) {
  const int side = HALO ? (p < 0 ? 0 : (p >= X ? 1 : -1)) : -1;
  if (side >= 0)
    return PlaneSrc{pick(rows.f, side), pick(rows.force, side), pick(rows.flags, side),
                    pick(rows.bc, side), 0, YZ};
  const int xp = HALO ? p : d3q19::pmod(p, X);
  return PlaneSrc{f, force, flags, bc, (long long)xp * YZ, (long long)X * YZ};
}

// Shared memory of one block: the ring [38][kNodes] and the stage
// [2][C][kNodes] with C = 19 populations + 3 force (field) + 3 bc velocity
// (if present).
__host__ __device__ inline int stage_channels(int force_mode, bool has_bc) {
  return 19 + (force_mode == 2 ? 3 : 0) + (has_bc ? 3 : 0);
}
size_t shared_bytes(int channels) {
  return (size_t)kNodes * (kRingPlanes + 2 * channels) * sizeof(float);
}

// force_mode: 0 none, 1 uniform (fu), 2 field [3, X, Y, Z].  HALO: the
// slab kernel with the neighbours' x rows in place of the periodic wrap.
// Block (blockIdx.x = tile index, z tiles fastest; blockIdx.y = run)
// writes y in [ty TY, ty TY + TY), z in [tz TZ, tz TZ + TZ), x in
// [run r, min(run (r + 1), X)), each clipped to the box.
template <bool HALO>
__global__ void __launch_bounds__(kThreads, K10_MIN_BLOCKS) stream_collide_2d_kernel(
    const float* __restrict__ f, float* __restrict__ out, const float* __restrict__ force,
    int force_mode, float fux, float fuy, float fuz, float omega,
    const uint8_t* __restrict__ flags, const float* __restrict__ bc_vel, int has_rho0,
    float rho0, HaloRows rows, int n_z, int run, int X, int Y, int Z) {
  constexpr int NODES = kNodes;
  extern __shared__ float smem[];
  float* ring = smem;                            // [38][NODES]
  float* stage = smem + kRingPlanes * NODES;     // [2][C][NODES]
  const bool has_bc = bc_vel != nullptr || rows.bc[0] != nullptr || rows.bc[1] != nullptr;
  const int C = stage_channels(force_mode, has_bc);
  const int c_force = 19, c_bc = 19 + (force_mode == 2 ? 3 : 0);

  const long long YZ = (long long)Y * Z;
  const long long N = (long long)X * YZ;
  const int y0 = (blockIdx.x / n_z) * TY, z0 = (blockIdx.x % n_z) * TZ;
  const int x0 = blockIdx.y * run;
  const int x1 = min(x0 + run, X);

  // this thread's node of the padded plane and its offset in a plane
  const int n = threadIdx.x;
  const bool mine = n < NODES;
  const int pj = n / PZ, pl = n % PZ;
  const long long r =
      (long long)d3q19::pmod(y0 - 1 + pj, Y) * Z + d3q19::pmod(z0 - 1 + pl, Z);

  // stage the operands of plane p (cp.async, one group a plane) into
  // buffer (p - x0 + 1) & 1; the flag byte into the register ``flag``
  auto fetch = [&](int p, uint8_t& flag) {
    if (mine) {
      const PlaneSrc s = plane_src<HALO>(p, f, force, flags, bc_vel, rows, X, YZ);
      float* st = stage + ((p - x0 + 1) & 1) * C * NODES + n;
      const long long g = s.off + r;
#pragma unroll
      for (int q = 0; q < 19; ++q) cp_async4(st + q * NODES, s.f + q * s.st + g);
      if (force_mode == 2)
        for (int k = 0; k < 3; ++k) cp_async4(st + (c_force + k) * NODES, s.force + k * s.st + g);
      if (s.bc != nullptr)
        for (int k = 0; k < 3; ++k) cp_async4(st + (c_bc + k) * NODES, s.bc + k * s.st + g);
      flag = s.flags ? s.flags[g] : (uint8_t)0;
    }
    cp_async_commit();
  };

  // collide plane p (this thread's node) from the stage into the ring
  auto collide = [&](int p, uint8_t flag) {
    if (!mine) return;
    const bool bc_here = plane_src<HALO>(p, f, force, flags, bc_vel, rows, X, YZ).bc != nullptr;
    const float* st = stage + ((p - x0 + 1) & 1) * C * NODES + n;
    float h[19];
#pragma unroll
    for (int q = 0; q < 19; ++q) h[q] = st[q * NODES];
    const bool velocity_node = flag == d3q19::kVelocity && bc_here;
    float bux = 0.f, buy = 0.f, buz = 0.f;
    float Fx = 0.f, Fy = 0.f, Fz = 0.f;
    if (velocity_node) {
      bux = st[c_bc * NODES]; buy = st[(c_bc + 1) * NODES]; buz = st[(c_bc + 2) * NODES];
    } else if (flag != d3q19::kWall) {
      if (force_mode == 1) {
        Fx = fux; Fy = fuy; Fz = fuz;
      } else if (force_mode == 2) {
        Fx = st[c_force * NODES]; Fy = st[(c_force + 1) * NODES];
        Fz = st[(c_force + 2) * NODES];
      }
    }
    float res[19];
    d3q19::collide_node(h, res, flag, Fx, Fy, Fz, omega, velocity_node, bux, buy, buz,
                        has_rho0 != 0, rho0);
    xmarch::ring_store(ring, NODES, p - x0 + 3, n, res);  // >= 2: the slots by parity, mod 3
  };

  // planes x0 - 1 .. x1 are staged and collided in order
  uint8_t flag_a = 0, flag_b = 0;  // the flags of the next two staged planes
  fetch(x0 - 1, flag_a);
  fetch(x0, flag_b);
  xmarch::cp_async_wait<1>();
  collide(x0 - 1, flag_a);
  fetch(x0 + 1, flag_a);
  xmarch::cp_async_wait<1>();
  collide(x0, flag_b);
  flag_b = flag_a;

  // the pull of a written node: its index in the padded plane
  const int t = threadIdx.x;
  const int wj = t / TZ, wl = t % TZ;
  const bool writer = t < TY * TZ && y0 + wj < Y && z0 + wl < Z;
  const int wn = (wj + 1) * PZ + wl + 1;
  const long long wr = (long long)(y0 + wj) * Z + z0 + wl;

  for (int x = x0; x < x1; ++x) {
    if (x + 2 <= x1) {
      fetch(x + 2, flag_a);
    } else {
      cp_async_commit();
    }
    xmarch::cp_async_wait<1>();
    collide(x + 1, flag_b);
    __syncthreads();  // the populations of planes x - 1 .. x + 1 are in the ring
    if (writer) {
      const long long g = (long long)x * YZ + wr;
      float h[19];
      xmarch::ring_pull(ring, NODES, PZ, x - x0 + 3, wn, h);
#pragma unroll
      for (int q = 0; q < 19; ++q) out[q * N + g] = h[q];
    }
    flag_b = flag_a;
    __syncthreads();  // the ring is read: the next plane takes its slots
  }
}

template <bool HALO>
int launch(const void* f, void* out, const void* force, int force_mode, float fux, float fuy,
           float fuz, float omega, const void* flags, const void* bc_vel, int has_rho0,
           float rho0, const HaloRows& rows, int n_y, int n_z, int run, int n_runs, int X,
           int Y, int Z, void* stream) {
  // the schedule must cover the box: every node written once
  if (n_y * TY < Y || (n_y - 1) * TY >= Y || n_z * TZ < Z || (n_z - 1) * TZ >= Z || run < 1 ||
      n_runs * run < X || (n_runs - 1) * run >= X)
    return (int)cudaErrorInvalidValue;
  const bool has_bc = bc_vel != nullptr || rows.bc[0] != nullptr || rows.bc[1] != nullptr;
  const size_t bytes = shared_bytes(stage_channels(force_mode, has_bc));
  // more than 48 KB of shared memory must be asked for per kernel
  cudaError_t err = cudaFuncSetAttribute(stream_collide_2d_kernel<HALO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(n_y * n_z), (unsigned)n_runs);
  stream_collide_2d_kernel<HALO><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)f, (float*)out, (const float*)force, force_mode, fux, fuy, fuz, omega,
      (const uint8_t*)flags, (const float*)bc_vel, has_rho0, rho0, rows, n_z, run, X, Y, Z);
  return (int)cudaGetLastError();
}

}  // namespace

// The schedule (n_y x n_z tiles, runs of ``run`` x planes, n_runs) comes
// from fluid/stream_collide_2d.py::schedule.
extern "C" int hc_stream_collide_2d(
    const void* f, void* out, const void* force, int force_mode,
    float fux, float fuy, float fuz, float omega, const void* flags,
    const void* bc_vel, int has_rho0, float rho0, int n_y, int n_z, int run, int n_runs,
    int X, int Y, int Z, void* stream) {
  return launch<false>(f, out, force, force_mode, fux, fuy, fuz, omega, flags, bc_vel,
                       has_rho0, rho0, HaloRows{}, n_y, n_z, run, n_runs, X, Y, Z, stream);
}

// The slab [X, Y, Z] with its neighbours' rows: ``rows`` holds the twelve
// row pointers of halo_rows.cuh (f, force, flags and bc are read).
extern "C" int hc_stream_collide_2d_halo(
    const void* f, void* out, const void* force, int force_mode,
    float fux, float fuy, float fuz, float omega, const void* flags,
    const void* bc_vel, int has_rho0, float rho0, const void* const* rows, int n_y, int n_z,
    int run, int n_runs, int X, int Y, int Z, void* stream) {
  return launch<true>(f, out, force, force_mode, fux, fuy, fuz, omega, flags, bc_vel,
                      has_rho0, rho0, halo_rows_from(rows), n_y, n_z, run, n_runs, X, Y, Z,
                      stream);
}
