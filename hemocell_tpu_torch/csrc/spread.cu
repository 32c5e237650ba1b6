// K2: boundary-aware trilinear spread of capped vertex forces.
//
// Replaces: the spread half of hemocell_tpu/ibm/pallas_ibm.py
//   ::pallas_spread_shadow (_spread_renorm_hit_kernel, _spread_renorm_kernel)
//   and ::pallas_spread (_spread_renorm_kernel, _spread_kernel).  Computes
//   coupling.spread(cap_force(F) , *coupling.stencil(wrap(pos), flags, act))
//   of hemocell_tpu_torch/ibm/coupling.py, the plain version.
//
// Bound on the H100: bytes, and in practice atomic throughput.  The
//   function reads 28 B per vertex (position, force, activity) plus the
//   flags of the touched nodes and writes the [3, X, Y, Z] field; each
//   vertex issues up to 24 f32 atomicAdds into L2.
//
// Design: one thread per vertex.  The thread wraps its unwrapped position
//   (positive fmod), forms the 8 trilinear weights, zeroes those on
//   non-fluid nodes, renormalises by max(total, 1e-30), scales by the
//   activity mask and the force capped at f_limit, and atomically adds the
//   deposits into a zeroed field.  Deposits on solid nodes have weight 0 and
//   are skipped, which is the destination masking of the TPU kernel.  The
//   TPU's one-hot MXU contractions, x-slab sort, window capacity and
//   overflow counter have no analog: atomics in L2 replace all of them.
//   f32 atomics make the summation order, and so the last bits of the
//   field, vary from run to run.  Sorted or binned spreads with
//   shared-memory accumulation are later work.

#include "ibm_stencil.cuh"

namespace {

__global__ void spread_kernel(const float* __restrict__ pos, const float* __restrict__ force,
                              const float* __restrict__ active,
                              const uint8_t* __restrict__ flags, float f_limit,
                              float* __restrict__ out, int P, int X, int Y, int Z) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float act = active[p];
  if (act == 0.f) return;  // dead cells deposit nothing
  hc::Stencil s;
  hc::trilinear_stencil(pos + 3 * p, flags, X, Y, Z, act, s);
  float fx = force[3 * p], fy = force[3 * p + 1], fz = force[3 * p + 2];
  const float mag = sqrtf(fx * fx + fy * fy + fz * fz);
  if (mag > f_limit) {
    const float scale = f_limit / fmaxf(mag, 1e-30f);
    fx *= scale; fy *= scale; fz *= scale;
  }
  const long long N = (long long)X * Y * Z;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = s.w[k];
    if (w == 0.f) continue;
    atomicAdd(out + s.node[k], w * fx);
    atomicAdd(out + N + s.node[k], w * fy);
    atomicAdd(out + 2 * N + s.node[k], w * fz);
  }
}

}  // namespace

// out must be zeroed [3, X, Y, Z] f32; pos/force [P, 3] f32, active [P] f32.
extern "C" int hc_spread(const void* pos, const void* force, const void* active,
                         const void* flags, float f_limit, void* out,
                         int P, int X, int Y, int Z, void* stream) {
  if (P > 0) {
    const int threads = 256;
    spread_kernel<<<(P + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const float*)pos, (const float*)force, (const float*)active,
        (const uint8_t*)flags, f_limit, (float*)out, P, X, Y, Z);
  }
  return (int)cudaGetLastError();
}
