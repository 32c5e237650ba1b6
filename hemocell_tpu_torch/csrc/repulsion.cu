// K5: inter-cell repulsion, F_i = k * sum_j (cutoff / d^2) (p_i - p_j) over
// vertices j of other cells within `cutoff` of vertex i.
//
// Replaces: hemocell_tpu/cells/pallas_repulsion.py::pallas_repulsion
//   (kernel body _repulsion_kernel, and the argsort and searchsorted of its
//   wrapper).  Computes exactly
//   repulsion.repulsion_forces(pos, cell_gid, active, shape, k, cutoff) of
//   hemocell_tpu_torch/cells/repulsion.py, the plain version: minimum image
//   in all three axes, the first `cap` vertices (in vertex order) of
//   each of the 27 bins around the vertex's nearest node, dead vertices in
//   no pair.  The TPU kernel's dropped y/z face-wrap pairs are not
//   reproduced.
//
// Bound on the H100: bytes.  The function reads 20 B per vertex (position,
//   cell id, activity) and writes 12 B; per candidate pair it does ~25
//   flops, a few tens of pairs per vertex in a dense suspension, far below
//   the card's f32 balance point.  In practice the 27 run-word lookups and
//   the scattered candidate loads per vertex set the time.
//
// Design: one ctypes call, seven launches.  The node bins of csrc/bin_nodes.cu
//   (a counting sort on the card, design in binned.cuh) leave the records --
//   wrapped position and cell id as one float4 -- in bin order, so a bin's
//   members are one contiguous run, and at each node one 32-bit word, its
//   run's first rank and length (at most 31, which bounds `cap`), zero at
//   every node with no live vertex in this call.  Then one thread per
//   sorted record: neighbouring threads hold the same or neighbouring
//   nodes and read the same runs (L1 hits).  Each thread walks its 27 bins
//   in the fixed order ox, oy, oz, then rank (the three words of a row
//   loaded together), and writes its own sum: no atomics, the result
//   repeats bit for bit.  The
//   minimum image divides only where a difference exceeds half the box,
//   the square root only where d^2 is near the cutoff: the arithmetic of
//   the plain version, without its work on the far candidates.  Measured
//   and not kept: a block per node tile staging the capped runs of the
//   tile and its halo in shared memory (same sums; the staging and the
//   threads idle in sparse tiles cost more than the L1 hits save), and
//   the candidate loop unrolled or flattened over a row's runs.  The TPU
//   kernel's slab windows, capacities, 128-alignment, parking slab and MXU
//   distance algebra have no analog.

#include "binned.cuh"

namespace hc {
namespace {

constexpr int PAIR_THREADS = 128;

__global__ void __launch_bounds__(PAIR_THREADS)
    repulsion_pairs_kernel(NodeBins nb, const float* __restrict__ active,
                           float* __restrict__ out, float k_rep, float cutoff, int cap, int P,
                           int X, int Y, int Z) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= P) return;
  const int i = nb.order[t];
  if (t >= *nb.n_live) {  // dead vertex: no force
    out[3 * (long long)i] = 0.f;
    out[3 * (long long)i + 1] = 0.f;
    out[3 * (long long)i + 2] = 0.f;
    return;
  }
  const float4 A = nb.rec_s[t];
  const int my_gid = __float_as_int(A.w);
  const int nx = nearest_node(A.x, X), ny = nearest_node(A.y, Y), nz = nearest_node(A.z, Z);
  const int zs[3] = {nz == 0 ? Z - 1 : nz - 1, nz, nz + 1 == Z ? 0 : nz + 1};
  const float LX = (float)X, LY = (float)Y, LZ = (float)Z;
  // d < cutoff implies d^2 below this (sqrtf rounds by half an ulp): the
  // square root is taken for the few candidates near enough
  const float cut2 = cutoff * cutoff * (1.0f + 1e-5f);

  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int ox = -1; ox <= 1; ++ox) {
    int bx = nx + ox; bx = bx < 0 ? bx + X : (bx >= X ? bx - X : bx);
    for (int oy = -1; oy <= 1; ++oy) {
      int by = ny + oy; by = by < 0 ? by + Y : (by >= Y ? by - Y : by);
      int s[3], e[3];  // the row's three runs, their loads in flight together
#pragma unroll
      for (int oz = 0; oz < 3; ++oz) {
        const unsigned w = __ldg(nb.words + node_slot(bx, by, zs[oz], Y, Z));
        s[oz] = (int)(w >> RUN_LEN_BITS);
        e[oz] = s[oz] + min((int)(w & ((1u << RUN_LEN_BITS) - 1u)), cap);
      }
#pragma unroll
      for (int oz = 0; oz < 3; ++oz) {
        for (int r = s[oz]; r < e[oz]; ++r) {
          const float4 B = nb.rec_s[r];
          if (__float_as_int(B.w) == my_gid) continue;
          float dx = A.x - B.x;
          float dy = A.y - B.y;
          float dz = A.z - B.z;
          // minimum image, rintf(d / L) * L (round half to even); it is 0
          // where |d| <= L / 2
          if (fabsf(dx) > 0.5f * LX) dx -= rintf(dx / LX) * LX;
          if (fabsf(dy) > 0.5f * LY) dy -= rintf(dy / LY) * LY;
          if (fabsf(dz) > 0.5f * LZ) dz -= rintf(dz / LZ) * LZ;
          const float d2 = dx * dx + dy * dy + dz * dz;
          if (d2 < cut2) {
            const float d = sqrtf(fmaxf(d2, 1e-30f));
            if (d < cutoff) {
              const float mag = k_rep * (cutoff / d) / d;
              fx += mag * dx; fy += mag * dy; fz += mag * dz;
            }
          }
        }
      }
    }
  }
  const float act = active[i];
  out[3 * (long long)i] = fx * act;
  out[3 * (long long)i + 1] = fy * act;
  out[3 * (long long)i + 2] = fz * act;
}

int pairs(const NodeBins& nb, const float* active, float* out, float k_rep, float cutoff,
          int cap, int P, int X, int Y, int Z, cudaStream_t s) {
  if (P > 0)
    repulsion_pairs_kernel<<<(P + PAIR_THREADS - 1) / PAIR_THREADS, PAIR_THREADS, 0, s>>>(
        nb, active, out, k_rep, cutoff, cap, P, X, Y, Z);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace hc

// The whole of K5: the node bins, then the pair sums.  `scratch` holds
// hc_node_bins_ints(P, X, Y, Z) int32 words, zero before the first call and
// kept from call to call at these P and shape (each call clears the node
// words of the last one that it does not rewrite).  cap <= 31, P <= 2^26.
extern "C" int hc_repulsion(const void* pos, const void* gid, const void* active, void* out,
                            float k_rep, float cutoff, int cap, void* scratch, int P, int X,
                            int Y, int Z, void* stream) {
  if (cap < 0 || cap >= (1 << hc::RUN_LEN_BITS) || P > (1 << (31 - hc::RUN_LEN_BITS)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const hc::NodeBins nb = hc::node_bins_carve((int*)scratch, P, X, Y, Z);
  int err = hc::node_bins((const float*)pos, (const int*)gid, (const float*)active, P, X, Y, Z,
                          nb, s);
  if (!err)
    err = hc::pairs(nb, (const float*)active, (float*)out, k_rep, cutoff, cap, P, X, Y, Z, s);
  return err;
}

// The pair sums alone on the layout the last hc_bin_nodes or hc_repulsion
// left in `scratch` (for the timing of chip_smoke.py).
extern "C" int hc_repulsion_pairs(const void* active, void* out, float k_rep, float cutoff,
                                  int cap, void* scratch, int P, int X, int Y, int Z,
                                  void* stream) {
  if (cap < 0 || cap >= (1 << hc::RUN_LEN_BITS)) return (int)cudaErrorInvalidValue;
  const hc::NodeBins nb = hc::node_bins_carve((int*)scratch, P, X, Y, Z);
  return hc::pairs(nb, (const float*)active, (float*)out, k_rep, cutoff, cap, P, X, Y, Z,
                   (cudaStream_t)stream);
}
