// K9 (k = 2..5) and K8 (two steps): k fused D3Q19 BGK+Guo stream-collide
// steps in one launch, bitwise equal to k launches of K1.
//
// Replaces: hemocell_tpu/fluid/pallas_lbm_kx.py::stream_collide_pallas_kx
//   (kernel body _kernel_kx) and, as the K = 2 instantiation with its own C
//   entry, hemocell_tpu/fluid/pallas_lbm_2x.py::stream_collide_pallas_2x
//   (_kernel2x).  Computes k applications of lbm.stream_collide of
//   hemocell_tpu_torch/fluid/lbm.py, the plain version.  Operands: uniform
//   [3] force or none, scalar omega, optional bounce-back wall flags,
//   periodic in all three axes, f32.
//
// Bound on the H100, per launch: bytes.  f is read once and written once
//   and the flag byte read once, (38 * 4 + 1) B per node over 3.35 TB/s
//   (128^3: 0.0958 ms for all k steps, where k launches of K1 are bound by
//   k * 0.0958 ms); the collisions are about 350 k flops per node over
//   67 TFLOP/s (k = 4 at 128^3: 0.044 ms).
//
// Design: temporal blocking along x ("3.5-D blocking"), built from K10's
//   pieces (xmarch.cuh).  A block owns a TY x TZ (y, z) tile and a run of
//   x planes [x0, x1), and marches along x through k time levels at once:
//   * level s = 1..k collides the tile with a halo of k - s + 1 nodes a
//     side in y and z (periodic wrap by modular index), one node a thread,
//     with d3q19::collide_node, into a ring of its own in shared memory
//     (38 population planes, as in K10);
//   * level 1 collides the input plane; level s >= 2 collides its
//     plane from level s - 1's ring by the pull, one plane behind level
//     s - 1; the pull from level k's ring writes the tile's rows of `out`
//     (TZ floats a row, coalesced), one plane behind level k;
//   * so each x step runs level 1, ..., level k and the write in turn, a
//     barrier after each level; the x halo (k planes at each end of a run)
//     is collided at the ends of a run only;
//   * at k = 2 the populations of the next input plane are staged by
//     cp.async (one plane, each thread its own node, so its own
//     cp.async.wait_group orders the copy with its reads) while level 2
//     collides; at k >= 3, whose rings leave little shared memory to L1,
//     each thread loads its node's into registers past L1 (ld.global.cg)
//     while level 1 collides; the flag byte goes to a register, and level
//     1 keeps the flags of its last k planes in a ring of bytes, from
//     which level s reads its nodes'.
//   HBM traffic is that of one step: f read once (plus the halo, mostly
//   from L2) and written once per k steps.  The cost is the y/z halo:
//   level s collides (TY + 2h)(TZ + 2h) nodes, h = k - s + 1, and the
//   rings take 38 x 4 B a node of every level, which the 227 KB of shared
//   memory a block must hold:
//
//     k  tile     nodes collided a level     collisions a     shared
//                 (level 1 .. k)             written node     memory
//                                            a step
//     2  8 x 32   432 340                    1.51             147.5 KB
//     3  16 x 16  484 400 324                1.57             180.7 KB
//     4  16 x 8   384 308 240 180            2.17             166.6 KB
//     5  8 x 12   396 320 252 192 140        2.71             194.9 KB
//
//   (rings 38 x 4 B, at k = 2 the stage 19 x 4 B of level 1's plane, and
//   k flag bytes a node of level 1).  A much wider tile at depth k
//   overflows the shared memory; one block an SM.  The tiles of each depth
//   were chosen by time on the H100 among those that fit (PERF.md,
//   section 6).  The schedule (tiles, runs) comes from
//   fluid/stream_collide_kx.py::schedule; shapes the tile does not divide
//   are handled by the modular index and guards on the write.  There is no
//   fallback to K1.
//
//   The arithmetic on the populations is d3q19::collide_node on the
//   operands K1 gives it, and the library is built with -fmad=false: only
//   where the values are kept differs, so the result is bitwise that of k
//   K1 launches.  The collision's float instructions are the bulk of the
//   kernel's code, so its time follows the collisions it repeats in the
//   halo, where K1's follows its bytes.
//
//   What was measured against it (PERF.md, section 6): the last level
//   pushing its populations to `out` as K1 does, which frees its ring for
//   wider tiles or two blocks an SM, was slower (scattered partial-sector
//   writes); warps of their own for each level with rings kept a plane
//   longer (57 population planes) and one barrier a step was faster at
//   128^3 and 256^3 and slower in the pipe at k = 2, and its rings leave
//   only narrower tiles at k >= 3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d3q19_collide.cuh"
#include "xmarch.cuh"

namespace {

// The (y, z) tile of each depth k = 2..5: TY, TZ pairs.  The library is
// built with these (fluid/stream_collide_kx.py: TILES); a build with
// -DKX_TILES=... compiles other tiles, for timing them.
#ifndef KX_TILES
#define KX_TILES 8, 32, 16, 16, 16, 8, 8, 12
#endif

__host__ __device__ constexpr int tile_ty(int k) {
  constexpr int t[8] = {KX_TILES};
  return t[2 * (k - 2)];
}
__host__ __device__ constexpr int tile_tz(int k) {
  constexpr int t[8] = {KX_TILES};
  return t[2 * (k - 2) + 1];
}
// level s of depth k: the tile with a halo of k - s + 1 nodes a side
__host__ __device__ constexpr int level_w(int k, int s) { return tile_tz(k) + 2 * (k - s + 1); }
__host__ __device__ constexpr int level_h(int k, int s) { return tile_ty(k) + 2 * (k - s + 1); }
__host__ __device__ constexpr int level_nodes(int k, int s) {
  return level_w(k, s) * level_h(k, s);
}
// the floats before level s's ring (the rings of levels 1 .. s - 1)
__host__ __device__ constexpr int ring_floats(int k, int s) {
  int o = 0;
  for (int i = 1; i < s; ++i) o += xmarch::kRingPlanes * level_nodes(k, i);
  return o;
}
__host__ __device__ constexpr int threads_of(int k) { return (level_nodes(k, 1) + 31) / 32 * 32; }
// Level 1's next input plane: at k = 2 cp.async stages it in shared
// memory; at k >= 3, whose rings leave little of an SM's shared memory to
// L1, each thread loads its node into registers past L1 instead (the
// faster of the two at each depth, PERF.md section 6)
__host__ __device__ constexpr bool staged(int k) { return k == 2; }
// the rings, the stage [19][P1] if staged, and the flag ring [k][P1] bytes
__host__ __device__ constexpr size_t shared_bytes(int k) {
  return (size_t)(ring_floats(k, k + 1) + (staged(k) ? 19 * level_nodes(k, 1) : 0)) *
             sizeof(float) +
         (size_t)k * level_nodes(k, 1);
}

// Block (blockIdx.x = tile index, z tiles fastest; blockIdx.y = run)
// writes y in [ty TY, ty TY + TY), z in [tz TZ, tz TZ + TZ), x in
// [run r, min(run (r + 1), X)), each clipped to the box.
template <int K>
__global__ void __launch_bounds__(threads_of(K), 1) stream_collide_kx_kernel(
    const float* __restrict__ f, float* __restrict__ out, float fux, float fuy, float fuz,
    float omega, const uint8_t* __restrict__ flags, int n_z, int run, int X, int Y, int Z) {
  constexpr int TY = tile_ty(K), TZ = tile_tz(K);
  constexpr int P1 = level_nodes(K, 1), W1 = level_w(K, 1);
  static_assert(shared_bytes(K) <= 232448, "the rings outgrow a block's shared memory");
  static_assert(threads_of(K) <= 1024, "level 1's plane outgrows a block");
  extern __shared__ float smem[];                  // the rings of levels 1 .. K
  float* stage = smem + ring_floats(K, K + 1);     // [19][P1] if staged
  uint8_t* fring = reinterpret_cast<uint8_t*>(stage + (staged(K) ? 19 * P1 : 0));  // [K][P1]

  const long long YZ = (long long)Y * Z;
  const long long N = (long long)X * YZ;
  const int y0 = (blockIdx.x / n_z) * TY, z0 = (blockIdx.x % n_z) * TZ;
  const int x0 = blockIdx.y * run;
  const int steps = min(x0 + run, X) - x0 + 2 * K;
  const bool has_flags = flags != nullptr;
  const int t = threadIdx.x;

  // Step u stages and collides at level 1 the plane x0 - K + u; level s
  // collides the plane s - 1 behind it and the write is one behind level
  // K.  A plane x has the ring index x - (x0 - K) + 3 at every level.

  // this thread's node of level 1's plane and its offset in an x plane
  const bool mine = t < P1;
  const long long r =
      (long long)d3q19::pmod(y0 - K + t / W1, Y) * Z + d3q19::pmod(z0 - K + t % W1, Z);
  // the populations of plane x0 - K + u at this node: into the stage, or
  // into ``nxt``
  uint8_t flag_next = 0;
  float nxt[19];
  auto fetch = [&](int u) {
    const long long g = (long long)d3q19::pmod(x0 - K + u, X) * YZ + r;
    if constexpr (staged(K)) {
#pragma unroll
      for (int q = 0; q < 19; ++q) xmarch::cp_async4(stage + q * P1 + t, f + q * N + g);
      xmarch::cp_async_commit();
    } else {
#pragma unroll
      for (int q = 0; q < 19; ++q) nxt[q] = __ldcg(f + q * N + g);
    }
    flag_next = has_flags ? flags[g] : (uint8_t)0;
  };
  if (mine) fetch(0);

  // the written node of this thread: its index in level K's plane
  const int wj = t / TZ, wl = t % TZ;
  const bool writer = t < TY * TZ && y0 + wj < Y && z0 + wl < Z;
  const int wn = (wj + 1) * level_w(K, K) + wl + 1;
  const long long wr = (long long)(y0 + wj) * Z + z0 + wl;

  for (int u = 0; u < steps; ++u) {
    // level 1: the fetched plane, ring index u + 3; the next plane is
    // fetched while levels 2..K collide (staged) or while this one does
    if (mine) {
      float h[19], res[19];
      const uint8_t flag = flag_next;
      if constexpr (staged(K)) {
        xmarch::cp_async_wait<0>();
#pragma unroll
        for (int q = 0; q < 19; ++q) h[q] = stage[q * P1 + t];
      } else {
#pragma unroll
        for (int q = 0; q < 19; ++q) h[q] = nxt[q];
        if (u + 1 < steps) fetch(u + 1);
      }
      d3q19::collide_node(h, res, flag, fux, fuy, fuz, omega, false, 0.f, 0.f, 0.f, false,
                          0.f);
      xmarch::ring_store(smem, P1, u + 3, t, res);
      if (has_flags) fring[((u + 3) % K) * P1 + t] = flag;
      if (staged(K) && u + 1 < steps) fetch(u + 1);  // the stage is read: the next plane
    }
    __syncthreads();

    // level s: ring index u - s + 4, once its plane is one level s needs
    // (x >= x0 - (K - s + 1)); node (j, l) is (j + 1, l + 1) of level s - 1
    // and (j + s - 1, l + s - 1) of level 1
#pragma unroll
    for (int s = 2; s <= K; ++s) {
      if (u >= 2 * (s - 1) && t < level_nodes(K, s)) {
        const int W = level_w(K, s), Wp = level_w(K, s - 1);
        const int j = t / W, l = t % W;
        const int p = u - s + 4;
        float h[19], res[19];
        xmarch::ring_pull(smem + ring_floats(K, s - 1), level_nodes(K, s - 1), Wp, p,
                          (j + 1) * Wp + l + 1, h);
        const uint8_t flag =
            has_flags ? fring[(p % K) * P1 + (j + s - 1) * W1 + l + s - 1] : (uint8_t)0;
        d3q19::collide_node(h, res, flag, fux, fuy, fuz, omega, false, 0.f, 0.f, 0.f, false,
                            0.f);
        xmarch::ring_store(smem + ring_floats(K, s), level_nodes(K, s), p, t, res);
      }
      __syncthreads();
    }

    // the write: plane x0 - 2K + u (ring index u - K + 3) pulled from level
    // K.  The next writes to level K's ring come after the next step's
    // barriers, so no barrier is needed here.
    if (u >= 2 * K && writer) {
      float h[19];
      xmarch::ring_pull(smem + ring_floats(K, K), level_nodes(K, K), level_w(K, K),
                        u - K + 3, wn, h);
      const long long g = (long long)(x0 - 2 * K + u) * YZ + wr;
#pragma unroll
      for (int q = 0; q < 19; ++q) out[q * N + g] = h[q];
    }
  }
}

template <int K>
int launch_kx(const void* f, void* out, float fux, float fuy, float fuz, float omega,
              const void* flags, int n_y, int n_z, int run, int n_runs, int X, int Y, int Z,
              void* stream) {
  constexpr int TY = tile_ty(K), TZ = tile_tz(K);
  // the schedule must cover the box: every node written once
  if (n_y * TY < Y || (n_y - 1) * TY >= Y || n_z * TZ < Z || (n_z - 1) * TZ >= Z || run < 1 ||
      n_runs * run < X || (n_runs - 1) * run >= X)
    return (int)cudaErrorInvalidValue;
  // more than 48 KB of shared memory must be asked for per kernel
  cudaError_t err = cudaFuncSetAttribute(stream_collide_kx_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shared_bytes(K));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(n_y * n_z), (unsigned)n_runs);
  stream_collide_kx_kernel<K><<<grid, threads_of(K), shared_bytes(K), (cudaStream_t)stream>>>(
      (const float*)f, (float*)out, fux, fuy, fuz, omega, (const uint8_t*)flags, n_z, run, X,
      Y, Z);
  return (int)cudaGetLastError();
}

}  // namespace

// K9: k in 2..5 fused steps with the schedule (n_y x n_z tiles of depth k,
// runs of ``run`` x planes, n_runs) of fluid/stream_collide_kx.py::schedule;
// any other k returns cudaErrorInvalidValue
extern "C" int hc_stream_collide_kx(
    const void* f, void* out, float fux, float fuy, float fuz, float omega,
    const void* flags, int k, int n_y, int n_z, int run, int n_runs, int X, int Y, int Z,
    void* stream) {
#define KX_LAUNCH(K) \
  launch_kx<K>(f, out, fux, fuy, fuz, omega, flags, n_y, n_z, run, n_runs, X, Y, Z, stream)
  switch (k) {
    case 2: return KX_LAUNCH(2);
    case 3: return KX_LAUNCH(3);
    case 4: return KX_LAUNCH(4);
    case 5: return KX_LAUNCH(5);
    default: return (int)cudaErrorInvalidValue;
  }
#undef KX_LAUNCH
}

// K8: two fused steps, the K = 2 instantiation, with the schedule of depth 2
extern "C" int hc_stream_collide_2x(
    const void* f, void* out, float fux, float fuy, float fuz, float omega,
    const void* flags, int n_y, int n_z, int run, int n_runs, int X, int Y, int Z,
    void* stream) {
  return launch_kx<2>(f, out, fux, fuy, fuz, omega, flags, n_y, n_z, run, n_runs, X, Y, Z,
                      stream);
}
