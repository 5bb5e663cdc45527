// K3 min_span_filter_gapped and K4 pair_mers_gapped: nearest-neighbour
// passes over a gapped, position-ordered mer stream.
//
// K3 replaces pgrtk_tpu/ops/pairs.py:134 min_span_filter_gapped (with its
// jump-pointer helper _next_valid :108).  K4 replaces
// pgrtk_tpu/ops/pairs.py:290 pair_mers_gapped.
//
// What bounds them on this card: device memory and launch count.  The
// stream is ~1/150 of the bases (C ~ 110k entries per 16-Mbase row), a
// few tens of bytes per entry; the work per entry is a handful of
// compares.  K3 reads 17 bytes an entry and writes one; K4 writes five
// int64 planes and a flag per entry (41 bytes against 17 read), so its
// stores set its floor.
//
// Both find an entry's nearest marked neighbours without ranks.  The TPU
// took log2(C) rounds of shift-and-select over whole planes; here a block
// takes a 1024-entry tile of a row, 256 threads with four entries each
// (column tid + 256 r).  Each warp ballots its 32 consecutive entries: an
// entry's next marked column inside those 32 is the lowest set bit of the
// ballot above its lane, its previous one the highest set bit below.  The
// 32 groups of the tile share their first and last marked columns through
// shared memory, and one warp turns them into each group's nearest marked
// column after it (and before it, for K3).  The entries at the tile's
// ends take the nearest marked column outside the tile from a per-tile
// summary (first and last marked column of each 1,024 entries) that a
// first, small launch writes; a warp reads it 32 tiles a load, so a
// marked-free run of tens of thousands of entries costs a few loads, not
// one per tile.  x and y of an in-tile neighbour come from shared memory,
// the at most two neighbours outside the tile from device memory.  Two
// launches (one when a row is a single tile), no scratch beyond the
// summary, each plane read once and written once.
//
// K3 marks the valid entries and keeps an entry by its previous and next
// valid neighbour; K4 marks the kept entries and pairs each with its next
// kept neighbour.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPairTile = 1024;    // entries a block takes
constexpr int kPairThreads = 256;  // four entries a thread
constexpr int kPairRounds = kPairTile / kPairThreads;
constexpr int kNone = -1;

__host__ __device__ inline long long pair_tiles(long long C) {
  return (C + kPairTile - 1) / kPairTile;
}

// The first and, where `last` is given, the last marked column of each
// 1024-entry tile of each row (kNone if the tile marks nothing), one warp
// a tile: 32 entries a lane in two 16-byte loads where the tile is whole
// and aligned, else a byte a load.
__global__ void tile_summary_kernel(const bool* __restrict__ mark,
                                    long long C, int ntiles, int row0,
                                    int* __restrict__ first,
                                    int* __restrict__ last) {
  const int warps = blockDim.x >> 5;
  const int t = blockIdx.x * warps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= ntiles) return;  // uniform across the warp
  const long long b = (long long)row0 + blockIdx.y;
  const bool* row = mark + b * C;
  const long long c0 = (long long)t * kPairTile;
  int f = kNone, l = kNone;
  if (((uintptr_t)(row + c0) & 15) == 0 && c0 + kPairTile <= C) {
    const uint4* p = reinterpret_cast<const uint4*>(row + c0) + lane * 2;
    const uint4 lo = __ldg(p), hi = __ldg(p + 1);
    const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    // the lane's first and last marked entry of its 32 (bytes 0/1)
    int mine = 32, mine_last = -1;
#pragma unroll
    for (int k = 7; k >= 0; --k)
      if (w[k]) mine = 4 * k + ((__ffs(w[k]) - 1) >> 3);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (w[k]) mine_last = 4 * k + ((31 - __clz(w[k])) >> 3);
    const unsigned has = __ballot_sync(kFull, mine < 32);
    const int lf = has ? __ffs(has) - 1 : 0;
    const int ll = has ? 31 - __clz(has) : 0;
    const int at = __shfl_sync(kFull, mine, lf);
    const int at_last = __shfl_sync(kFull, mine_last, ll);
    if (has) {
      f = (int)c0 + lf * 32 + at;
      l = (int)c0 + ll * 32 + at_last;
    }
  } else {
    bool k[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const long long c = c0 + q * 32 + lane;
      k[q] = c < C && row[c];
    }
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const unsigned m = __ballot_sync(kFull, k[q]);
      if (m) {
        if (f == kNone) f = (int)c0 + q * 32 + __ffs(m) - 1;
        l = (int)c0 + q * 32 + 31 - __clz(m);
      }
    }
  }
  if (lane == 0) {
    first[b * ntiles + t] = f;
    if (last) last[b * ntiles + t] = l;
  }
}

// The summary launch of a (B, C) mask: rows in tiles of gridDim.y.
void tile_summary(const bool* mark, int B, long long C, int* first,
                  int* last, cudaStream_t st) {
  const int nt = (int)pair_tiles(C);
  const int warps = 8;
  for (int r0 = 0; r0 < B; r0 += pgrtk::kMaxGridY) {
    const int rows = B - r0 < pgrtk::kMaxGridY ? B - r0 : pgrtk::kMaxGridY;
    tile_summary_kernel<<<dim3((unsigned)((nt + warps - 1) / warps),
                               (unsigned)rows),
                          warps * 32, 0, st>>>(mark, C, nt, r0, first, last);
  }
}

// shmmrutils.rs:536-555: first and last valid mers are kept; an interior
// one needs a span > min_span to both valid neighbours and a hash
// distinct from both.
__global__ void __launch_bounds__(kPairThreads)
    min_span_kernel(const int64_t* __restrict__ x,
                    const int64_t* __restrict__ y,
                    const bool* __restrict__ valid, long long C, int ntiles,
                    int row0, int min_span, const int* __restrict__ first,
                    const int* __restrict__ last, bool* __restrict__ keep) {
  __shared__ int64_t sx[kPairTile], sy[kPairTile];
  __shared__ int group_first[32], group_last[32], group_next[32],
      group_prev[32];
  __shared__ int tile_after, tile_before;
  const long long b = (long long)row0 + blockIdx.y;
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = b * C;
  const int c0 = t * kPairTile;  // C < 2^31 (the entry point checks)

  bool v[kPairRounds];
  unsigned m[kPairRounds];
#pragma unroll
  for (int r = 0; r < kPairRounds; ++r) {
    const int e = r * kPairThreads + tid;
    const long long c = (long long)c0 + e;
    v[r] = c < C && valid[base + c];
    if (v[r]) {
      sx[e] = x[base + c];
      sy[e] = y[base + c];
    }
    m[r] = __ballot_sync(kFull, v[r]);
    if (lane == 0) {
      const int g0 = c0 + r * kPairThreads + warp * 32;
      group_first[r * 8 + warp] = m[r] ? g0 + __ffs(m[r]) - 1 : kNone;
      group_last[r * 8 + warp] = m[r] ? g0 + 31 - __clz(m[r]) : kNone;
    }
  }
  // the nearest valid columns outside this tile, from the summary: the
  // first after it (C if none) and the last before it (kNone if none)
  if (warp == 0) {
    int after = (int)C;
    for (int t2 = t + 1; t2 < ntiles; t2 += 32) {
      const int f = t2 + lane < ntiles ? first[b * ntiles + t2 + lane] : kNone;
      const unsigned ne = __ballot_sync(kFull, f != kNone);
      if (ne) {
        after = __shfl_sync(kFull, f, __ffs(ne) - 1);
        break;
      }
    }
    if (lane == 0) tile_after = after;
  } else if (warp == 1) {
    int before = kNone;
    for (int t2 = t - 1; t2 >= 0; t2 -= 32) {
      const int l = t2 - lane >= 0 ? last[b * ntiles + t2 - lane] : kNone;
      const unsigned ne = __ballot_sync(kFull, l != kNone);
      if (ne) {
        before = __shfl_sync(kFull, l, __ffs(ne) - 1);
        break;
      }
    }
    if (lane == 0) tile_before = before;
  }
  __syncthreads();
  if (warp == 0) {  // each group's nearest valid columns outside it
    const int f = group_first[lane];
    const unsigned ne = __ballot_sync(kFull, f != kNone);
    const unsigned later = ne & ~((2u << lane) - 1u);  // lane 31: none
    const int nf = __shfl_sync(kFull, f, later ? __ffs(later) - 1 : 0);
    group_next[lane] = later ? nf : tile_after;
    const int l = group_last[lane];
    const unsigned nl = __ballot_sync(kFull, l != kNone);
    const unsigned earlier = nl & ((1u << lane) - 1u);
    const int pl = __shfl_sync(kFull, l, earlier ? 31 - __clz(earlier) : 0);
    group_prev[lane] = earlier ? pl : tile_before;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kPairRounds; ++r) {
    const int e = r * kPairThreads + tid;
    const long long c = (long long)c0 + e;
    if (c >= C) break;  // later rounds are further right
    bool k = false;
    if (v[r]) {
      const int g0 = c0 + r * kPairThreads + warp * 32;
      const unsigned below = m[r] & ((1u << lane) - 1u);
      const unsigned above = m[r] & ~((2u << lane) - 1u);
      const int pc = below ? g0 + 31 - __clz(below) : group_prev[r * 8 + warp];
      const int nc = above ? g0 + __ffs(above) - 1 : group_next[r * 8 + warp];
      if (pc == kNone || nc >= C) {
        k = true;  // the row's first or last valid entry
      } else {
        int64_t px, py, nx, ny;
        if (pc >= c0) {
          px = sx[pc - c0];
          py = sy[pc - c0];
        } else {
          px = x[base + pc];
          py = y[base + pc];
        }
        if (nc < c0 + kPairTile) {
          nx = sx[nc - c0];
          ny = sy[nc - c0];
        } else {
          nx = x[base + nc];
          ny = y[base + nc];
        }
        const int64_t pos = sy[e] >> 1;
        const int64_t xx = sx[e];
        k = pos - (py >> 1) > min_span && (ny >> 1) - pos > min_span &&
            px != xx && nx != xx;
      }
    }
    keep[base + c] = k;
  }
}

// seq_db.rs:386-399: each kept mer pairs with the next kept one; the key
// is the ordered pair of 56-bit hashes.  Index side: a tie keeps
// orientation 0 (s0 <= s1); query side (tie_one): a tie swaps
// (seq_db.rs:1213).
__global__ void __launch_bounds__(kPairThreads)
    pair_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                const bool* __restrict__ kept, long long C, int ntiles,
                int row0, int tie_one, const int* __restrict__ first,
                int64_t* __restrict__ k0, int64_t* __restrict__ k1,
                int64_t* __restrict__ bgn, int64_t* __restrict__ end,
                int64_t* __restrict__ ori, bool* __restrict__ pair_valid) {
  __shared__ int64_t sx[kPairTile], sy[kPairTile];
  __shared__ int group_first[32], group_next[32];
  const long long b = (long long)row0 + blockIdx.y;
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = b * C;
  const int c0 = t * kPairTile;  // C < 2^31 (the entry point checks)

  bool k[kPairRounds];
  unsigned m[kPairRounds];
#pragma unroll
  for (int r = 0; r < kPairRounds; ++r) {
    const int e = r * kPairThreads + tid;
    const long long c = (long long)c0 + e;
    k[r] = c < C && kept[base + c];
    if (k[r]) {
      sx[e] = x[base + c];
      sy[e] = y[base + c];
    }
    m[r] = __ballot_sync(kFull, k[r]);
    if (lane == 0)
      group_first[r * 8 + warp] =
          m[r] ? c0 + r * kPairThreads + warp * 32 + __ffs(m[r]) - 1 : kNone;
  }
  // the first kept column after this tile (C if none), from the summary
  int after = (int)C;
  if (warp == 0) {
    for (int t2 = t + 1; t2 < ntiles; t2 += 32) {
      const int f = t2 + lane < ntiles ? first[b * ntiles + t2 + lane] : kNone;
      const unsigned ne = __ballot_sync(kFull, f != kNone);
      if (ne) {
        after = __shfl_sync(kFull, f, __ffs(ne) - 1);
        break;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {  // each group's next kept column after the group
    const int f = group_first[lane];
    const unsigned ne = __ballot_sync(kFull, f != kNone);
    const unsigned later = ne & ~((2u << lane) - 1u);  // lane 31: none
    const int nf = __shfl_sync(kFull, f, later ? __ffs(later) - 1 : 0);
    group_next[lane] = later ? nf : after;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kPairRounds; ++r) {
    const int e = r * kPairThreads + tid;
    const long long c = (long long)c0 + e;
    if (c >= C) break;  // later rounds are further right
    bool ok = false;
    int64_t o_k0 = 0, o_k1 = 0, o_bgn = 0, o_end = 0, o_ori = 0;
    if (k[r]) {
      const unsigned above = m[r] & ~((2u << lane) - 1u);
      const int nc = above ? c0 + r * kPairThreads + warp * 32 +
                                 __ffs(above) - 1
                           : group_next[r * 8 + warp];
      ok = nc < C;
      if (ok) {
        int64_t nx, ny;
        if (nc < c0 + kPairTile) {
          nx = sx[nc - c0];
          ny = sy[nc - c0];
        } else {
          nx = x[base + nc];
          ny = y[base + nc];
        }
        const uint64_t h = (uint64_t)sx[e] >> 8;
        const uint64_t nh = (uint64_t)nx >> 8;
        const bool swap = h > nh || (tie_one && h == nh);
        o_k0 = (int64_t)(swap ? nh : h);
        o_k1 = (int64_t)(swap ? h : nh);
        o_bgn = (sy[e] >> 1) + 1;
        o_end = (ny >> 1) + 1;
        o_ori = swap ? 1 : 0;
      }
    }
    k0[base + c] = o_k0;
    k1[base + c] = o_k1;
    bgn[base + c] = o_bgn;
    end[base + c] = o_end;
    ori[base + c] = o_ori;
    pair_valid[base + c] = ok;
  }
}

}  // namespace

// Number of int32 entries of one summary plane of a (B, C) stream: a
// column of each 1024-entry tile.  K4 takes one plane (the first kept
// columns), K3 two (the first, then the last valid columns).
extern "C" long long pgrtk_pair_summary_ints(int B, long long C) {
  return (long long)B * pair_tiles(C);
}

// x, y (B, C) int64; valid (B, C) bool; summary int32
// [2 * pgrtk_pair_summary_ints(B, C)]; keep (B, C) bool.  C must be below
// 2^31.
extern "C" int pgrtk_min_span_filter_gapped(const void* x, const void* y,
                                            const void* valid, int B,
                                            long long C, int min_span,
                                            void* summary, void* keep,
                                            void* stream) {
  if (B < 0 || C < 0 || C >= (1ll << 31) - kPairTile)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * C == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nt = (int)pair_tiles(C);
  int* first = (int*)summary;
  int* last = first + (long long)B * nt;
  if (nt > 1)  // a single tile has nothing before or after it
    tile_summary((const bool*)valid, B, C, first, last, st);
  for (int r0 = 0; r0 < B; r0 += pgrtk::kMaxGridY) {
    const int rows = B - r0 < pgrtk::kMaxGridY ? B - r0 : pgrtk::kMaxGridY;
    min_span_kernel<<<dim3((unsigned)nt, (unsigned)rows), kPairThreads, 0,
                      st>>>((const int64_t*)x, (const int64_t*)y,
                            (const bool*)valid, C, nt, r0, min_span, first,
                            last, (bool*)keep);
  }
  return (int)cudaGetLastError();
}

// x, y (B, C) int64; kept (B, C) bool; summary int32
// [pgrtk_pair_summary_ints(B, C)]; outputs (B, C): k0, k1, bgn, end, ori
// int64 and pair_valid bool.  Entries without a pair are zero.  C must be
// below 2^31.
extern "C" int pgrtk_pair_mers_gapped(const void* x, const void* y,
                                      const void* kept, int B, long long C,
                                      int tie_one, void* summary, void* k0,
                                      void* k1, void* bgn, void* end,
                                      void* ori, void* pair_valid,
                                      void* stream) {
  if (B < 0 || C < 0 || C >= (1ll << 31) - kPairTile)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * C == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nt = (int)pair_tiles(C);
  if (nt > 1)  // a single tile has nothing after it
    tile_summary((const bool*)kept, B, C, (int*)summary, nullptr, st);
  for (int r0 = 0; r0 < B; r0 += pgrtk::kMaxGridY) {
    const int rows = B - r0 < pgrtk::kMaxGridY ? B - r0 : pgrtk::kMaxGridY;
    pair_kernel<<<dim3((unsigned)nt, (unsigned)rows), kPairThreads, 0, st>>>(
        (const int64_t*)x, (const int64_t*)y, (const bool*)kept, C, nt, r0,
        tie_one, (const int*)summary, (int64_t*)k0, (int64_t*)k1,
        (int64_t*)bgn, (int64_t*)end, (int64_t*)ori, (bool*)pair_valid);
  }
  return (int)cudaGetLastError();
}
