// Binning on the card for the deterministic spread (K2, K11) and the slab
// counts of K11 and K12: counting sorts of vertex indices by an integer key
// with integer atomics, no sort library and no float atomics.  The design
// is described in binned.cuh.
//
// Replaces: the wrapper-side binning of hemocell_tpu_torch/ibm/static.py
//   (torch.remainder, floor, a stable torch.sort, searchsorted and the
//   gathers; in the reference hemocell_tpu/ibm/pallas_ibm.py::build_bins),
//   and gives K2 the tile bins its tile gather reads.
//
// Bound on the H100: launch latency and bytes.  The tile count reads each
//   vertex once (position, force, activity, the flags of its 8 nodes) and
//   writes its record and its slots (64 B); the placement's blocks each
//   read the tile counts, then each vertex's record and slots, and write
//   1-8 list entries.  The slab counts read each position once and write
//   the [X, tiles] counts, which the scan reads and writes once; K11's rank
//   reads each position again.

#include "binned.cuh"

namespace hc {
namespace {

// ---- tile bins -----------------------------------------------------------

__global__ void __launch_bounds__(COUNT_THREADS)
    count_k2_kernel(const float* __restrict__ pos, const float* __restrict__ force,
                    const float* __restrict__ force_extra, const float* __restrict__ active,
                    const uint8_t* __restrict__ flags, float f_limit, int P, int X, int Y, int Z,
                    Tiles t, TileBins tb, float4* __restrict__ rec) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int bits = 0;
  bool live = false;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (p < P) {
    const float act = active[p];
    const float* p3 = pos + 3 * (long long)p;
    px = wrap_pos(p3[0], X);
    py = wrap_pos(p3[1], Y);
    pz = wrap_pos(p3[2], Z);
    float fx = force[3 * (long long)p], fy = force[3 * (long long)p + 1],
          fz = force[3 * (long long)p + 2];
    const float mag = sqrtf(fx * fx + fy * fy + fz * fz);
    if (mag > f_limit) {
      const float scale = f_limit / fmaxf(mag, 1e-30f);
      fx *= scale; fy *= scale; fz *= scale;
    }
    if (force_extra != nullptr) {  // uncapped (repulsion), added after the cap
      fx += force_extra[3 * (long long)p];
      fy += force_extra[3 * (long long)p + 1];
      fz += force_extra[3 * (long long)p + 2];
    }
    // the weights' fluid mask and renormalisation: coupling.stencil
    int bx, by, bz;
    base_of(px, py, pz, X, Y, Z, bx, by, bz);
    const float gx = px - floorf(px), gy = py - floorf(py), gz = pz - floorf(pz);
    const int cx[2] = {bx, bx + 1 == X ? 0 : bx + 1};
    const int cy[2] = {by, by + 1 == Y ? 0 : by + 1};
    const int cz[2] = {bz, bz + 1 == Z ? 0 : bz + 1};
    float total = 0.f;
    int mask = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int a = (c >> 2) & 1, b = (c >> 1) & 1, cc = c & 1;
      if (flags[((long long)cx[a] * Y + cy[b]) * Z + cz[cc]] == 0) {
        total += ((a ? gx : 1.0f - gx) * (b ? gy : 1.0f - gy)) * (cc ? gz : 1.0f - gz);
        mask |= 1 << c;
      }
    }
    rec[2 * (long long)p] = make_float4(px, py, pz, act / fmaxf(total, 1e-30f));
    rec[2 * (long long)p + 1] = make_float4(fx, fy, fz, __int_as_float(mask));
    live = act != 0.f;  // dead cells deposit nothing
    // the renormalised weights of a vertex sum to 1: no node gets more
    // than |act| * max |F| from it
    if (live) bits = __float_as_int(fabsf(act) * fmaxf(fabsf(fx), fmaxf(fabsf(fy), fabsf(fz))));
  }
  count_tiles(p < P ? p : -1, live, px, py, pz, X, Y, Z, t, t.nx * t.ny * t.nz, tb);
  block_bound(bits, tb.bound);
}

// K11's counting: the vertices kept within their slab's capacity (record
// activity 1) into their tiles; the periodic weights of a vertex sum to 1.
__global__ void __launch_bounds__(COUNT_THREADS)
    count_records_kernel(const float4* __restrict__ rec, int P, int X, int Y, int Z, Tiles t,
                         TileBins tb) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int bits = 0;
  bool live = false;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p < P) {
    A = rec[2 * (long long)p];
    live = A.w != 0.f;
    if (live) {
      const float4 B = rec[2 * (long long)p + 1];
      bits = __float_as_int(fmaxf(fabsf(B.x), fmaxf(fabsf(B.y), fabsf(B.z))));
    }
  }
  count_tiles(p < P ? p : -1, live, A.x, A.y, A.z, X, Y, Z, t, t.nx * t.ny * t.nz, tb);
  block_bound(bits, tb.bound);
}

// Each block scans the tile counts itself (they are few) and places its
// vertices into their tiles' lists; block 0 writes the starts and the
// scale (and resets the bound), the last block to finish zeroes the counts
// for the next call.
__global__ void place_kernel(const float4* __restrict__ rec, int P, int X, int Y, int Z, Tiles t,
                             TileBins tb) {
  extern __shared__ int start[];  // [T + 1]
  __shared__ int sh[32];
  __shared__ bool last;
  const int T = t.nx * t.ny * t.nz;
  int carry = 0;
  for (int c = 0; c < T; c += blockDim.x) {
    const int i = c + threadIdx.x;
    int total;
    const int ex = block_exclusive_scan(i < T ? tb.counts[i] : 0, sh, &total);
    if (i < T) start[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) {
    start[T] = carry;
    __threadfence();
    last = atomicAdd(tb.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i <= T; i += blockDim.x) tb.starts[i] = start[i];
    if (threadIdx.x == 0) {
      const float m = __int_as_float(*tb.bound);
      *tb.bound = 0;
      double scale = 1.0;
      if (!(m <= 3.402823466e38f)) {
        scale = __longlong_as_double(0x7ff8000000000000LL);  // a force is not finite
      } else if (m > 0.f) {
        int e;
        frexpf(m, &e);  // m < 2^e
        scale = ldexp(1.0, 30 - e);
      }
      *tb.scale = scale;
    }
  }
  if (last) {  // every block has read the counts
    for (int i = threadIdx.x; i < T; i += blockDim.x) tb.counts[i] = 0;
    if (threadIdx.x == 0) *tb.ticket = 0u;
  }
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float4 A = rec[2 * (long long)p];
  if (A.w == 0.f) return;
  int bx, by, bz, ids[8];
  base_of(A.x, A.y, A.z, X, Y, Z, bx, by, bz);
  stencil_tiles(bx, by, bz, X, Y, Z, t, ids);
  const int4* s4 = reinterpret_cast<const int4*>(tb.slot + 8 * (long long)p);
  const int4 s0 = s4[0], s1 = s4[1];
  const int slots[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (ids[c] >= 0) tb.list[start[ids[c]] + slots[c]] = p;
}

// ---- slab bins -----------------------------------------------------------

// Each block counts its tile's slabs in shared memory, a thread a vertex:
// the peers of a slab in a warp add their number with one integer atomic.
__global__ void __launch_bounds__(SLAB_TILE)
    slab_hist_kernel(const float* __restrict__ pos, int P, int X, int nt,
                     int* __restrict__ tilehist) {
  extern __shared__ int hist[];  // [X]
  const int t = blockIdx.x;
  const long long p = (long long)t * SLAB_TILE + threadIdx.x;
  const int g = p < P ? slab_of(__ldg(pos + 3 * p), X) : -1;
  for (int s = threadIdx.x; s < X; s += SLAB_TILE) hist[s] = 0;
  const unsigned peers = __match_any_sync(FULL, g);
  __syncthreads();
  if (g >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(hist + g, __popc(peers));
  __syncthreads();
  for (int s = threadIdx.x; s < X; s += SLAB_TILE) tilehist[(long long)s * nt + t] = hist[s];
}

// Block g: exclusive scan of slab g's tile counts (in place), its total.
// The last block to finish scans the totals into starts and sums the
// overflow past `capacity`, then resets the ticket.
__global__ void slab_scan_kernel(int* __restrict__ tilehist, int nt, int X, int capacity,
                                 SlabBins sb, long long* __restrict__ overflow) {
  __shared__ int sh[32];
  __shared__ bool last;
  __shared__ unsigned long long osh[32];
  const int g = blockIdx.x;
  int* row = tilehist + (long long)g * nt;
  int carry = 0;
  for (int c = 0; c < nt; c += blockDim.x) {
    const int i = c + threadIdx.x;
    const int v = i < nt ? row[i] : 0;
    int total;
    const int ex = block_exclusive_scan(v, sh, &total);
    if (i < nt) row[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) {
    sb.totals[g] = carry;
    __threadfence();
    last = atomicAdd(sb.ticket, 1u) == (unsigned)(X - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int run = 0;
  unsigned long long over = 0;
  for (int c = 0; c < X; c += blockDim.x) {
    const int i = c + threadIdx.x;
    const int v = i < X ? __ldcg(sb.totals + i) : 0;
    int total;
    const int ex = block_exclusive_scan(v, sh, &total);
    if (i < X) sb.starts[i] = run + ex;
    run += total;
    if (v > capacity) over += (unsigned long long)(v - capacity);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) over += __shfl_down_sync(FULL, over, o);
  if ((threadIdx.x & 31) == 0) osh[threadIdx.x >> 5] = over;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) sum += osh[w];
    *overflow = (long long)sum;
    sb.starts[X] = run;
    *sb.ticket = 0u;
  }
}

// Each warp walks its tile again in vertex order and gives every vertex its
// stable position in the slab order: K11's records, activity 1 for the
// vertices within capacity.
__global__ void slab_rank_kernel(const float* __restrict__ pos, const float* __restrict__ force,
                                 int P, int X, int Y, int Z, int nt, int capacity, SlabBins sb,
                                 float4* __restrict__ rec) {
  extern __shared__ int run[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int t = blockIdx.x * SLAB_WARPS + w;
  if (t >= nt) return;
  int* r0 = run + w * X;
  for (int g = lane; g < X; g += 32) r0[g] = sb.starts[g] + sb.tilehist[(long long)g * nt + t];
  __syncwarp();
  const unsigned lt = (1u << lane) - 1u;
  const long long base = (long long)t * SLAB_TILE;
  float q[SLAB_ROUNDS][3];  // the tile's loads first, all in flight together
#pragma unroll
  for (int r = 0; r < SLAB_ROUNDS; ++r) {
    const long long pl = base + r * 32 + lane;
#pragma unroll
    for (int d = 0; d < 3; ++d) q[r][d] = pl < P ? __ldg(pos + 3 * pl + d) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < SLAB_ROUNDS; ++r) {
    const long long pl = base + r * 32 + lane;
    const bool valid = pl < P;
    float px = 0.f, py = 0.f, pz = 0.f;
    int g = -1;
    if (valid) {
      px = wrap_pos(q[r][0], X);
      py = wrap_pos(q[r][1], Y);
      pz = wrap_pos(q[r][2], Z);
      g = wrap_idx((int)floorf(px), X);
    }
    const unsigned peers = __match_any_sync(FULL, g);
    const int at = valid ? r0[g] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) r0[g] = at + __popc(peers);
    __syncwarp();
    if (!valid) continue;
    const int dst = at + __popc(peers & lt);
    const float* f3 = force + 3 * pl;
    rec[2 * pl] = make_float4(px, py, pz, dst - sb.starts[g] < capacity ? 1.f : 0.f);
    rec[2 * pl + 1] = make_float4(f3[0], f3[1], f3[2], __int_as_float(0xff));
  }
}

int blocks(long long n, int per) { return (int)((n + per - 1) / per); }

int slab_smem(int X) { return SLAB_WARPS * X * (int)sizeof(int); }

}  // namespace

Tiles gather_tiles(int X, int Y, int Z) {
  Tiles t;
  const int per_node = 3 * 2 * (int)sizeof(int);  // three sums of two words
  t.tz = min(Z, TILE_BYTES / per_node);
  t.tx = min(8, X);
  t.ty = min(8, Y);
  while ((long long)per_node * t.tx * t.ty * t.tz > TILE_BYTES) {
    if (t.ty >= t.tx && t.ty > 1) t.ty = (t.ty + 1) / 2;
    else t.tx = (t.tx + 1) / 2;
  }
  t.nx = blocks(X, t.tx);
  t.ny = blocks(Y, t.ty);
  t.nz = blocks(Z, t.tz);
  t.smem = per_node * t.tx * t.ty * t.tz;
  return t;
}

long long tile_bins_ints(int P, int X, int Y, int Z) {
  const Tiles t = gather_tiles(X, Y, Z);
  const long long T = (long long)t.nx * t.ny * t.nz;
  return 4 + 8LL * P + T + (T + 1) + 8LL * P;
}

TileBins tile_bins_carve(int* s, int P, int X, int Y, int Z) {
  const Tiles t = gather_tiles(X, Y, Z);
  const long long T = (long long)t.nx * t.ny * t.nz;
  TileBins tb;
  tb.scale = reinterpret_cast<double*>(s);
  tb.bound = s + 2;
  tb.ticket = reinterpret_cast<unsigned*>(s + 3);
  tb.slot = s + 4;  // 16-byte aligned: read and written as int4
  tb.counts = tb.slot + 8LL * P;
  tb.starts = tb.counts + T;
  tb.list = tb.starts + T + 1;
  return tb;
}

long long slab_bins_ints(int P, int X) {
  const long long n = (long long)blocks(P, SLAB_TILE) * X + X + 1 + (X + 1);
  return (n + 3) / 4 * 4;  // what follows stays 16-byte aligned
}

SlabBins slab_bins_carve(int* s, int P, int X) {
  SlabBins sb;
  sb.tilehist = s;
  sb.totals = sb.tilehist + (long long)blocks(P, SLAB_TILE) * X;
  sb.ticket = reinterpret_cast<unsigned*>(sb.totals + X);
  sb.starts = sb.totals + X + 1;
  return sb;
}

int tile_bins_count_k2(const float* pos, const float* force, const float* force_extra,
                       const float* active, const uint8_t* flags, float f_limit, int P, int X,
                       int Y, int Z, const TileBins& tb, float4* rec, cudaStream_t s) {
  if (P > 0)
    count_k2_kernel<<<blocks(P, COUNT_THREADS), COUNT_THREADS, 0, s>>>(
        pos, force, force_extra, active, flags, f_limit, P, X, Y, Z, gather_tiles(X, Y, Z), tb,
        rec);
  return (int)cudaGetLastError();
}

int tile_bins_place(const TileBins& tb, const float4* rec, int P, int X, int Y, int Z,
                    cudaStream_t s) {
  const Tiles t = gather_tiles(X, Y, Z);
  const int smem = (t.nx * t.ny * t.nz + 1) * (int)sizeof(int);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  place_kernel<<<max(blocks(P, PLACE_THREADS), 1), PLACE_THREADS, smem, s>>>(rec, P, X, Y, Z, t,
                                                                            tb);
  return (int)cudaGetLastError();
}

int tile_bins_count_records(const float4* rec, int P, int X, int Y, int Z, const TileBins& tb,
                            cudaStream_t s) {
  if (P > 0)
    count_records_kernel<<<blocks(P, COUNT_THREADS), COUNT_THREADS, 0, s>>>(
        rec, P, X, Y, Z, gather_tiles(X, Y, Z), tb);
  return (int)cudaGetLastError();
}

int slab_counts(const float* pos, int P, int X, int capacity, const SlabBins& sb,
                long long* overflow, cudaStream_t s) {
  const int nt = blocks(P, SLAB_TILE);
  const int smem = X * (int)sizeof(int);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(slab_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (nt > 0) slab_hist_kernel<<<nt, SLAB_TILE, smem, s>>>(pos, P, X, nt, sb.tilehist);
  slab_scan_kernel<<<X, 1024, 0, s>>>(sb.tilehist, nt, X, capacity, sb, overflow);
  return (int)cudaGetLastError();
}

int slab_bins(const float* pos, const float* force, int P, int X, int Y, int Z, int capacity,
              const SlabBins& sb, long long* overflow, float4* rec, cudaStream_t s) {
  int err = slab_counts(pos, P, X, capacity, sb, overflow, s);
  const int nt = blocks(P, SLAB_TILE);
  const int smem = slab_smem(X);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(slab_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (!err && nt > 0)
    slab_rank_kernel<<<blocks(nt, SLAB_WARPS), 32 * SLAB_WARPS, smem, s>>>(
        pos, force, P, X, Y, Z, nt, capacity, sb, rec);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace hc

extern "C" long long hc_tile_bins_ints(int P, int X, int Y, int Z) {
  return hc::tile_bins_ints(P, X, Y, Z);
}

extern "C" long long hc_slab_bins_ints(int P, int X) { return hc::slab_bins_ints(P, X); }

// K2's tile bins alone, for the checks and the timing of chip_smoke.py:
// the records rec [2 P] float4, starts [T + 1] and the lists list [8 P]
// (the first starts[T] entries; within a tile in the order of the atomics).
extern "C" int hc_bin_tiles(const void* pos, const void* force, const void* active,
                            const void* flags, float f_limit, void* rec, void* starts,
                            void* list, void* scratch, int P, int X, int Y, int Z,
                            void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const hc::TileBins tb = hc::tile_bins_carve((int*)scratch, P, X, Y, Z);
  const hc::Tiles t = hc::gather_tiles(X, Y, Z);
  const long long T = (long long)t.nx * t.ny * t.nz;
  int err = hc::tile_bins_count_k2((const float*)pos, (const float*)force, nullptr,
                                   (const float*)active, (const uint8_t*)flags, f_limit, P, X,
                                   Y, Z, tb, (float4*)rec, s);
  if (!err) err = hc::tile_bins_place(tb, (const float4*)rec, P, X, Y, Z, s);
  if (!err)
    err = (int)cudaMemcpyAsync(starts, tb.starts, (T + 1) * sizeof(int),
                               cudaMemcpyDeviceToDevice, s);
  if (!err)
    err = (int)cudaMemcpyAsync(list, tb.list, 8LL * P * sizeof(int), cudaMemcpyDeviceToDevice,
                               s);
  return err;
}

// The slab counts alone (K12's first two launches), for the checks of
// chip_smoke.py: starts [X + 1] int32 (slab g holds the vertices of the
// stable slab order starts[g] .. starts[g + 1] - 1) and the overflow past
// `capacity` (int64).
extern "C" int hc_slab_starts(const void* pos, int capacity, void* starts, void* overflow,
                              void* scratch, int P, int X, void* stream) {
  hc::SlabBins sb = hc::slab_bins_carve((int*)scratch, P, X);
  sb.starts = (int*)starts;
  return hc::slab_counts((const float*)pos, P, X, capacity, sb, (long long*)overflow,
                         (cudaStream_t)stream);
}
