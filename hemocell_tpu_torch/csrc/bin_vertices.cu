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
// Bound on the H100: bytes.  The tile count reads each vertex once
//   (position, force, activity, the flags of its 8 nodes) and writes its
//   32-byte record, its key and its places (4 B an entry); its last block
//   reads and writes the T tile counts once.  The placement reads each
//   key, each entry's place and start and writes the entry.  In practice
//   the count waits on its loads and atomics (a round of a vertex a thread
//   a loop, about 60% of its time before any binning at 256^3).  The slab
//   counts read each position once and write the [X, tiles] counts, which
//   the scan reads and writes once; K11's rank reads each position again.

#include "binned.cuh"

namespace hc {
namespace {

// ---- tile bins -----------------------------------------------------------

__global__ void __launch_bounds__(COUNT_THREADS, 6)
    count_k2_kernel(const float* __restrict__ pos, const float* __restrict__ force,
                    const float* __restrict__ force_extra, const float* __restrict__ active,
                    const uint8_t* __restrict__ flags, float f_limit, int P, int X, int Y, int Z,
                    Tiles t, TileBins tb, float4* __restrict__ rec) {
  // a grid-stride loop over rounds of a vertex a thread, the block's end
  // (its ticket) once; at least one block, the last one writing the starts
  extern __shared__ int local[];  // [T] with T <= SMEM_TILES (count_tiles)
  const int T = t.nx * t.ny * t.nz;
  int bits = 0;
  for (long long r0 = (long long)blockIdx.x * blockDim.x; r0 < P;
       r0 += (long long)gridDim.x * blockDim.x) {
    const long long p = r0 + threadIdx.x;
    bool live = false;
    float px = 0.f, py = 0.f, pz = 0.f;
    if (p < P) {
      const float act = active[p];
      const float* p3 = pos + 3 * p;
      px = wrap_pos_fast(p3[0], X);
      py = wrap_pos_fast(p3[1], Y);
      pz = wrap_pos_fast(p3[2], Z);
      float fx = force[3 * p], fy = force[3 * p + 1], fz = force[3 * p + 2];
      const float mag = sqrtf(fx * fx + fy * fy + fz * fz);
      if (mag > f_limit) {
        const float scale = f_limit / fmaxf(mag, 1e-30f);
        fx *= scale; fy *= scale; fz *= scale;
      }
      if (force_extra != nullptr) {  // uncapped (repulsion), added after the cap
        fx += force_extra[3 * p];
        fy += force_extra[3 * p + 1];
        fz += force_extra[3 * p + 2];
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
      const float w = act / fmaxf(total, 1e-30f);
      rec[2 * p] = make_float4(px, py, pz, w);
      rec[2 * p + 1] = make_float4(fx, fy, fz, __int_as_float(mask));
      // dead cells (act 0) deposit nothing; the placement reads the same
      // test from the record (w is 0 exactly where act is)
      live = w != 0.f;
      // the renormalised weights of a vertex sum to 1: no node gets more
      // than |act| * max |F| from it
      if (live)
        bits = max(bits, __float_as_int(fabsf(act) *
                                        fmaxf(fabsf(fx), fmaxf(fabsf(fy), fabsf(fz)))));
    }
    count_tiles(p, P, live, px, py, pz, X, Y, Z, t, T, local, tb);
  }
  finish_counts(bits, tb, T);
}

// K11's counting: the vertices kept within their slab's capacity (record
// activity 1) into their tiles; the periodic weights of a vertex sum to 1.
// A grid-stride loop, as count_k2_kernel.
__global__ void __launch_bounds__(COUNT_THREADS)
    count_records_kernel(const float4* __restrict__ rec, int P, int X, int Y, int Z, Tiles t,
                         TileBins tb) {
  extern __shared__ int local[];  // [T] with T <= SMEM_TILES (count_tiles)
  const int T = t.nx * t.ny * t.nz;
  int bits = 0;
  for (long long r0 = (long long)blockIdx.x * blockDim.x; r0 < P;
       r0 += (long long)gridDim.x * blockDim.x) {
    const long long p = r0 + threadIdx.x;
    bool live = false;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < P) {
      A = rec[2 * p];
      live = A.w != 0.f;
      if (live) {
        const float4 B = rec[2 * p + 1];
        bits = max(bits, __float_as_int(fmaxf(fabsf(B.x), fmaxf(fabsf(B.y), fabsf(B.z)))));
      }
    }
    count_tiles(p, P, live, A.x, A.y, A.z, X, Y, Z, t, T, local, tb);
  }
  finish_counts(bits, tb, T);
}

// Each live vertex writes its index into its tiles' lists, at the start
// of each list plus the place the counting gave it there: it reads its
// stencil's key (4 bytes), its places and the starts, not its record.
__global__ void __launch_bounds__(PLACE_THREADS) place_kernel(int P, Tiles t, TileBins tb) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  int ids[8];
  key_tiles(__ldg(tb.key + p), t, ids);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    if (ids[c] >= 0)
      tb.list[__ldg(tb.starts + ids[c]) + __ldg(tb.slot + (long long)c * P + p)] = p;
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

// The share of a tile's entries a stencil adds along an axis of L nodes cut
// in tiles of t: the bases whose +1 node lies in the next tile, 1 where one
// tile spans the axis.
double axis_entries(int t, int L) {
  const int n = blocks(L, t);
  return n > 1 ? 1.0 + (double)n / L : 1.0;
}

// The candidate extents of a tile along an axis of L nodes: the powers of
// two below L, and L.
int axis_candidates(int L, int* out) {
  int n = 0;
  for (int t = 1; t < L; t *= 2) out[n++] = t;
  out[n++] = L;
  return n;
}

// The strides of the sums: the 8 nodes of a stencil, at offsets {0, 1} x
// {0, sy} x {0, sx}, in 8 different banks of 32, where the padding costs
// little (a z run of 16 or more, a plane of 64 words or more).
void pad_strides(Tiles& t) {
  const int r = t.tz % 32;
  t.sy = t.tz >= 16 && (r <= 1 || r == 31) ? t.tz + 2 : t.tz;
  t.sx = t.ty * t.sy;
  if (t.sx >= 64) {
    const int own[4] = {0, 1, t.sy % 32, (t.sy + 1) % 32};
    for (;; ++t.sx) {  // found within 32 words
      bool clash = false;
      for (int a = 0; a < 4; ++a)
        for (int b = 0; b < 4; ++b) clash = clash || (t.sx + own[b]) % 32 == own[a];
      if (!clash) break;
    }
  }
  t.words = t.tx * t.sx;
}

// The near-cubic tile of at most `budget` nodes: of the candidate extents,
// the fewest entries a vertex makes; then the fewest tiles; then the
// longest z, then y (the first found).  tz at least 8 where Z allows (stores
// of 32 bytes along z).
Tiles cut_tiles(int X, int Y, int Z, int budget) {
  int cx[33], cy[33], cz[33];
  const int nx = axis_candidates(X, cx), ny = axis_candidates(Y, cy),
            nz = axis_candidates(Z, cz);
  const int min_tz = min(Z, 8);
  Tiles best{};
  double best_cost = 0.0;
  long long best_T = 0;
  for (int k = nz - 1; k >= 0; --k) {
    if (cz[k] < min_tz) continue;
    for (int j = ny - 1; j >= 0; --j) {
      for (int i = nx - 1; i >= 0; --i) {
        if ((long long)cx[i] * cy[j] * cz[k] > budget) continue;
        const double cost = axis_entries(cx[i], X) * axis_entries(cy[j], Y) *
                            axis_entries(cz[k], Z);
        const long long T = (long long)blocks(X, cx[i]) * blocks(Y, cy[j]) * blocks(Z, cz[k]);
        if (best_T == 0 || cost < best_cost - 1e-12 ||
            (cost <= best_cost + 1e-12 && T < best_T)) {
          best = Tiles{cx[i], cy[j], cz[k], blocks(X, cx[i]), blocks(Y, cy[j]),
                       blocks(Z, cz[k]), 0, 0, 0};
          best_cost = cost;
          best_T = T;
        }
      }
    }
  }
  return best;
}

// The tiles of a lattice: TILE_NODES nodes a tile, halved down to
// MIN_TILE_NODES while the lattice has fewer than MIN_TILES of them (a small
// lattice's densest tiles would otherwise hold the gather's last blocks).
Tiles find_tiles(int X, int Y, int Z) {
  Tiles t = cut_tiles(X, Y, Z, TILE_NODES);
  for (int budget = TILE_NODES / 2;
       budget >= MIN_TILE_NODES && (long long)t.nx * t.ny * t.nz < MIN_TILES; budget /= 2)
    t = cut_tiles(X, Y, Z, budget);
  pad_strides(t);
  return t;
}

}  // namespace

// The tiles of the last lattice asked for are kept: every call of K2 asks
// for them three times.
Tiles gather_tiles(int X, int Y, int Z) {
  static thread_local int key[3] = {0, 0, 0};
  static thread_local Tiles kept;
  if (key[0] != X || key[1] != Y || key[2] != Z) {
    kept = find_tiles(X, Y, Z);
    key[0] = X;
    key[1] = Y;
    key[2] = Z;
  }
  return kept;
}

long long tile_bins_ints(int P, int X, int Y, int Z) {
  const Tiles t = gather_tiles(X, Y, Z);
  const long long T = (long long)t.nx * t.ny * t.nz;
  return 4 + T + (T + 1) + P + 8LL * P + 8LL * P;
}

TileBins tile_bins_carve(int* s, int P, int X, int Y, int Z) {
  const Tiles t = gather_tiles(X, Y, Z);
  const long long T = (long long)t.nx * t.ny * t.nz;
  TileBins tb;
  tb.scale = reinterpret_cast<double*>(s);
  tb.bound = s + 2;
  tb.ticket = reinterpret_cast<unsigned*>(s + 3);
  tb.counts = s + 4;
  tb.starts = tb.counts + T;
  tb.key = tb.starts + T + 1;
  tb.slot = tb.key + P;
  tb.list = tb.slot + 8LL * P;
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

// The blocks of `threads` that the card holds at once (every SM full), for
// a grid-stride kernel: the first call's count is kept.
int resident_blocks(const void* kernel, int threads, int& kept) {
  if (kept == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    kept = max(1, sms * per_sm);
  }
  return kept;
}

// The counting's shared memory: the tile counts where they fit.
int count_smem(const Tiles& t) {
  const int T = t.nx * t.ny * t.nz;
  return T <= SMEM_TILES ? T * (int)sizeof(int) : 0;
}

// The counting's grid: a block a round of vertices where they count in
// shared memory, else the blocks the card holds at once, each looping.
int count_grid(const void* kernel, int P, const Tiles& t, int& resident) {
  const int all = max(1, blocks(P, COUNT_THREADS));
  if (count_smem(t) > 0) return all;
  return min(all, resident_blocks(kernel, COUNT_THREADS, resident));
}

int tile_bins_count_k2(const float* pos, const float* force, const float* force_extra,
                       const float* active, const uint8_t* flags, float f_limit, int P, int X,
                       int Y, int Z, const Tiles& t, const TileBins& tb, float4* rec,
                       cudaStream_t s) {
  static thread_local int resident = 0;
  count_k2_kernel<<<count_grid((const void*)count_k2_kernel, P, t, resident), COUNT_THREADS,
                    count_smem(t), s>>>(pos, force, force_extra, active, flags, f_limit, P, X,
                                        Y, Z, t, tb, rec);
  return (int)cudaGetLastError();
}

int tile_bins_place(const TileBins& tb, int P, const Tiles& t, cudaStream_t s) {
  place_kernel<<<max(blocks(P, PLACE_THREADS), 1), PLACE_THREADS, 0, s>>>(P, t, tb);
  return (int)cudaGetLastError();
}

int tile_bins_count_records(const float4* rec, int P, int X, int Y, int Z, const Tiles& t,
                            const TileBins& tb, cudaStream_t s) {
  static thread_local int resident = 0;
  count_records_kernel<<<count_grid((const void*)count_records_kernel, P, t, resident),
                         COUNT_THREADS, count_smem(t), s>>>(rec, P, X, Y, Z, t, tb);
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
                                   Y, Z, t, tb, (float4*)rec, s);
  if (!err) err = hc::tile_bins_place(tb, P, t, s);
  if (!err)
    err = (int)cudaMemcpyAsync(starts, tb.starts, (T + 1) * sizeof(int),
                               cudaMemcpyDeviceToDevice, s);
  if (!err)
    err = (int)cudaMemcpyAsync(list, tb.list, 8LL * P * sizeof(int), cudaMemcpyDeviceToDevice,
                               s);
  return err;
}

// The tile shape K2 and K11 cut a lattice into: tile [3] = (TX, TY, TZ),
// for the checks of chip_smoke.py and the tests on the card.
extern "C" int hc_gather_tiles(int X, int Y, int Z, void* tile) {
  const hc::Tiles t = hc::gather_tiles(X, Y, Z);
  int* out = (int*)tile;
  out[0] = t.tx;
  out[1] = t.ty;
  out[2] = t.tz;
  return 0;
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
