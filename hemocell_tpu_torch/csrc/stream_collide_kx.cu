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
//   k * 0.1033 ms); the collisions are about 350 k flops per node over
//   67 TFLOP/s (k = 4 at 128^3: 0.044 ms).
//
// Design: the TPU kernel keeps whole (Y, Z) planes of an x-slab with k halo
//   rows per side in VMEM; an SM has 227 KB of shared memory, about 2,900
//   nodes of 19 f32, so here a block owns a small box and carries a k-deep
//   halo in all three axes.  The block loads its box (BoxFor<K> below; periodic
//   wrap by modular index, the wall flags with it) into shared memory and
//   advances it k times in place; a thread holds one node's 19 populations
//   in registers at a time.  Step s works on the box shrunk by s nodes per
//   side (the TPU kernel's shrinking schedule, in three axes), so after k
//   steps the nodes k or more from every face are exact and only they are
//   written.  Halo nodes are collided redundantly; that is the
//   price of this simple design and it grows fast with k.
//
//   Streaming in place without a second buffer follows the AA pattern
//   (Bailey et al. 2009).  An even step reads a node's own slots, collides
//   and stores res_q in the node's slot opp(q): nothing leaves the node.
//   An odd step pulls h_q from slot opp(q) of the neighbour x - c_q (that
//   neighbour's post-collision res_q), collides and pushes res_q into slot q
//   of x + c_q.  The 19 locations a node reads in an odd step are the 19 it
//   writes, and no other node touches them, so one barrier per step is
//   enough.  After an odd step the box is in the plain layout again; for an
//   odd k the last stream is done by the write to global memory.  The
//   arithmetic on the populations is d3q19::collide_node, the same function
//   K1 calls: only where values are kept differs, so the result is bitwise
//   that of k K1 launches.
//
//   The box is a compile-time constant: shapes it does not divide are
//   handled by guards on the write, boxes narrower than the tile by the
//   modular halo load.  There is no fallback to K1.
//
// Later work (not built here): temporal blocking that marches along x with
//   a ring of planes per time level ("3.5-D blocking"), thread-block
//   clusters sharing a larger tile through distributed shared memory, and
//   TMA loads of the tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "d3q19_collide.cuh"

namespace {

// The box a block holds in shared memory (inner tile plus K halo nodes per
// side), its threads and the blocks an SM holds at once; a node takes 19 f32
// and a flag byte of the SM's 227 KB of shared memory.
template <int TX_, int TY_, int TZ_, int THREADS_, int BLOCKS_>
struct Box {
  static constexpr int TX = TX_, TY = TY_, TZ = TZ_, kThreads = THREADS_, kBlocks = BLOCKS_;
  static constexpr int kNodes = TX * TY * TZ;
  static constexpr size_t kSharedBytes = (size_t)kNodes * (19 * sizeof(float) + 1);
  static_assert(BLOCKS_ * (kSharedBytes + 1024) <= 233472, "the boxes outgrow an SM");
};

// The box of each depth, chosen by time on the H100 among the boxes that
// fill the shared memory of an SM (1024 threads, one block) or half of it
// (512 threads, two blocks, so that one block loads while the other
// computes); the launch bounds hold each to 64 registers a thread.  At
// K = 2 and 3, rows along z of 20 and 22 nodes beat the more cubic boxes that
// leave more inner nodes: the written rows of 16 nodes are whole 32-byte
// sectors.
template <int K> struct BoxFor;
template <> struct BoxFor<2> : Box<8, 9, 20, 512, 2> {};     // writes 4 x 5 x 16
template <> struct BoxFor<3> : Box<11, 12, 22, 1024, 1> {};  // writes 5 x 6 x 16
template <> struct BoxFor<4> : Box<13, 14, 16, 1024, 1> {};  // writes 5 x 6 x 8
template <> struct BoxFor<5> : Box<14, 14, 15, 1024, 1> {};  // writes 4 x 4 x 5

template <int K, class B>
__global__ void __launch_bounds__(B::kThreads, B::kBlocks) stream_collide_kx_kernel(
    const float* __restrict__ f, float* __restrict__ out,
    float fux, float fuy, float fuz, float omega,
    const uint8_t* __restrict__ flags, int X, int Y, int Z) {
  constexpr int TX = B::TX, TY = B::TY, TZ = B::TZ;
  constexpr int kNodes = B::kNodes, kThreads = B::kThreads;
  D3Q19_TABLES
  constexpr int IX = TX - 2 * K, IY = TY - 2 * K, IZ = TZ - 2 * K;
  static_assert(IX > 0 && IY > 0 && IZ > 0, "the halo leaves no inner tile");
  extern __shared__ float smem[];
  float* s = smem;  // [19][kNodes]
  uint8_t* sflag = reinterpret_cast<uint8_t*>(smem + 19 * kNodes);  // [kNodes]

  const long long N = (long long)X * Y * Z;
  const int ox = blockIdx.x * IX - K, oy = blockIdx.y * IY - K, oz = blockIdx.z * IZ - K;

  // load the box with its halo; box node (i, j, l) is lattice node
  // (ox + i, oy + j, oz + l) of the periodic lattice
  for (int n = threadIdx.x; n < kNodes; n += kThreads) {
    const int l = n % TZ, j = (n / TZ) % TY, i = n / (TZ * TY);
    const int gx = d3q19::pmod(ox + i, X), gy = d3q19::pmod(oy + j, Y),
              gz = d3q19::pmod(oz + l, Z);
    const long long g = ((long long)gx * Y + gy) * Z + gz;
#pragma unroll
    for (int q = 0; q < 19; ++q) s[q * kNodes + n] = f[q * N + g];
    sflag[n] = flags ? flags[g] : (uint8_t)0;
  }
  __syncthreads();

#pragma unroll
  for (int st = 0; st < K; ++st) {
    // step st + 1 on the box shrunk by st nodes per side
    const int RX = TX - 2 * st, RY = TY - 2 * st, RZ = TZ - 2 * st;
    const int RN = RX * RY * RZ;
    const bool local = (st % 2) == 0;
    for (int r = threadIdx.x; r < RN; r += kThreads) {
      const int l = r % RZ + st, j = (r / RZ) % RY + st, i = r / (RZ * RY) + st;
      const int n = (i * TY + j) * TZ + l;
      float h[19], res[19];
      if (local) {
#pragma unroll
        for (int q = 0; q < 19; ++q) h[q] = s[q * kNodes + n];
      } else {
#pragma unroll
        for (int q = 0; q < 19; ++q)
          h[q] = s[kOPP[q] * kNodes + n - ((kCX[q] * TY + kCY[q]) * TZ + kCZ[q])];
      }
      d3q19::collide_node(h, res, sflag[n], fux, fuy, fuz, omega,
                          false, 0.f, 0.f, 0.f, false, 0.f);
      if (local) {
#pragma unroll
        for (int q = 0; q < 19; ++q) s[kOPP[q] * kNodes + n] = res[q];
      } else {
#pragma unroll
        for (int q = 0; q < 19; ++q)
          s[q * kNodes + n + ((kCX[q] * TY + kCY[q]) * TZ + kCZ[q])] = res[q];
      }
    }
    __syncthreads();
  }

  // write the inner tile; after an odd number of steps the box holds
  // post-collision values in swapped slots and this write streams them
  for (int r = threadIdx.x; r < IX * IY * IZ; r += kThreads) {
    const int l = r % IZ, j = (r / IZ) % IY, i = r / (IZ * IY);
    const int gx = blockIdx.x * IX + i, gy = blockIdx.y * IY + j, gz = blockIdx.z * IZ + l;
    if (gx >= X || gy >= Y || gz >= Z) continue;
    const long long g = ((long long)gx * Y + gy) * Z + gz;
    const int n = ((i + K) * TY + (j + K)) * TZ + (l + K);
    if (K % 2 == 0) {
#pragma unroll
      for (int q = 0; q < 19; ++q) out[q * N + g] = s[q * kNodes + n];
    } else {
#pragma unroll
      for (int q = 0; q < 19; ++q)
        out[q * N + g] =
            s[kOPP[q] * kNodes + n - ((kCX[q] * TY + kCY[q]) * TZ + kCZ[q])];
    }
  }
}

template <int K, class B>
int launch_kx(const void* f, void* out, float fux, float fuy, float fuz, float omega,
              const void* flags, int X, int Y, int Z, void* stream) {
  constexpr int IX = B::TX - 2 * K, IY = B::TY - 2 * K, IZ = B::TZ - 2 * K;
  // more than 48 KB of shared memory must be asked for per kernel
  cudaError_t err = cudaFuncSetAttribute(stream_collide_kx_kernel<K, B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)B::kSharedBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((X + IX - 1) / IX, (Y + IY - 1) / IY, (Z + IZ - 1) / IZ);
  stream_collide_kx_kernel<K, B><<<grid, B::kThreads, B::kSharedBytes, (cudaStream_t)stream>>>(
      (const float*)f, (float*)out, fux, fuy, fuz, omega, (const uint8_t*)flags, X, Y, Z);
  return (int)cudaGetLastError();
}

}  // namespace

// K9: k in 2..5 fused steps; any other k returns cudaErrorInvalidValue
extern "C" int hc_stream_collide_kx(
    const void* f, void* out, float fux, float fuy, float fuz, float omega,
    const void* flags, int k, int X, int Y, int Z, void* stream) {
  switch (k) {
    case 2: return launch_kx<2, BoxFor<2>>(f, out, fux, fuy, fuz, omega, flags, X, Y, Z, stream);
    case 3: return launch_kx<3, BoxFor<3>>(f, out, fux, fuy, fuz, omega, flags, X, Y, Z, stream);
    case 4: return launch_kx<4, BoxFor<4>>(f, out, fux, fuy, fuz, omega, flags, X, Y, Z, stream);
    case 5: return launch_kx<5, BoxFor<5>>(f, out, fux, fuy, fuz, omega, flags, X, Y, Z, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K8: two fused steps, the K = 2 instantiation with the box of that depth
extern "C" int hc_stream_collide_2x(
    const void* f, void* out, float fux, float fuy, float fuz, float omega,
    const void* flags, int X, int Y, int Z, void* stream) {
  return launch_kx<2, BoxFor<2>>(f, out, fux, fuy, fuz, omega, flags, X, Y, Z, stream);
}
