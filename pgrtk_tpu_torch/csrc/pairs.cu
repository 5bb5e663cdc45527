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
// compares.  K4 writes five int64 planes and a flag per entry (41 bytes
// against 17 read), so its stores set its floor.
//
// K3's design: the TPU found each entry's nearest valid neighbour with
// log2(C) rounds of shift-and-select over whole planes.  Here a row-wide
// exclusive prefix count of the mask ranks every entry, the valid
// entries scatter their column to a compacted index (vidx[rank] = col),
// and each entry then reads its neighbours directly: the previous valid
// entry is vidx[rank - 1], the next one vidx[rank + 1].  Rows are wider
// than a block, so the prefix count runs in three launches over
// 1024-entry tiles (rank.cuh); a fourth applies the filter.
//
// K4's design: an entry needs only the next kept entry of its row, which
// needs no ranks.  A block takes a 1024-entry tile of a row, 256 threads
// with four entries each (column tid + 256 r).  Each warp ballots its 32
// consecutive entries: an entry's next kept column inside those 32 is the
// lowest set bit of the ballot above its lane.  The 32 groups of the tile
// share their first kept columns through shared memory, and one warp
// turns them into each group's next kept column after it.  The last kept
// entries of a tile take the first kept column after the tile from a
// per-tile summary (one int per 1,024 entries) that a first, small launch
// writes; the warp reads it 32 tiles a load, so a kept-free run of tens of
// thousands of entries costs a few loads, not one per tile.  x and y of
// an in-tile neighbour come from shared memory, the one neighbour past
// the tile from device memory.  Two launches (one when a row is a single
// tile), no rank scratch, each plane read once and written once.
#include "rank.cuh"

namespace {

using pgrtk::RankScratch;

// shmmrutils.rs:536-555: first and last valid mers are kept; an interior
// one needs a span > min_span to both neighbours and a hash distinct
// from both.
__global__ void min_span_kernel(const int64_t* __restrict__ x,
                                const int64_t* __restrict__ y,
                                const bool* __restrict__ valid, long long C,
                                long long n, int min_span, RankScratch s,
                                bool* __restrict__ keep) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const long long b = g / C;
  bool k = false;
  if (valid[g]) {
    const int r = s.rank_excl[g];
    if (r == 0 || r + 1 >= s.totals[b]) {
      k = true;
    } else {
      const long long pi = b * C + s.vidx[b * C + r - 1];
      const long long ni = b * C + s.vidx[b * C + r + 1];
      const int64_t pos = y[g] >> 1;
      const int64_t xx = x[g];
      k = pos - (y[pi] >> 1) > min_span && (y[ni] >> 1) - pos > min_span &&
          x[pi] != xx && x[ni] != xx;
    }
  }
  keep[g] = k;
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPairTile = 1024;    // entries a block takes
constexpr int kPairThreads = 256;  // four entries a thread
constexpr int kPairRounds = kPairTile / kPairThreads;
constexpr int kNone = -1;

__host__ __device__ inline long long pair_tiles(long long C) {
  return (C + kPairTile - 1) / kPairTile;
}

// The first kept column of each 1024-entry tile of each row (kNone if
// the tile keeps nothing), one warp a tile: 32 entries a lane in two
// 16-byte loads where the tile is whole and aligned, else a byte a load.
__global__ void pair_summary_kernel(const bool* __restrict__ kept,
                                    long long C, int ntiles, int row0,
                                    int* __restrict__ first) {
  const int warps = blockDim.x >> 5;
  const int t = blockIdx.x * warps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= ntiles) return;  // uniform across the warp
  const long long b = (long long)row0 + blockIdx.y;
  const bool* row = kept + b * C;
  const long long c0 = (long long)t * kPairTile;
  int f = kNone;
  if (((uintptr_t)(row + c0) & 15) == 0 && c0 + kPairTile <= C) {
    const uint4* p = reinterpret_cast<const uint4*>(row + c0) + lane * 2;
    const uint4 lo = __ldg(p), hi = __ldg(p + 1);
    const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    int mine = 32;  // the lane's first kept entry of its 32 (bytes 0/1)
#pragma unroll
    for (int k = 7; k >= 0; --k)
      if (w[k]) mine = 4 * k + ((__ffs(w[k]) - 1) >> 3);
    const unsigned has = __ballot_sync(kFull, mine < 32);
    const int l = has ? __ffs(has) - 1 : 0;
    const int at = __shfl_sync(kFull, mine, l);
    if (has) f = (int)c0 + l * 32 + at;
  } else {
    bool k[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const long long c = c0 + q * 32 + lane;
      k[q] = c < C && row[c];
    }
#pragma unroll
    for (int q = 31; q >= 0; --q) {
      const unsigned m = __ballot_sync(kFull, k[q]);
      if (m) f = (int)c0 + q * 32 + __ffs(m) - 1;
    }
  }
  if (lane == 0) first[b * ntiles + t] = f;
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

// Number of int32 scratch entries K3's entry below needs for a (B, C)
// stream (its row ranks).
extern "C" long long pgrtk_row_rank_scratch(int B, long long C) {
  return pgrtk::rank_scratch_ints(B, C);
}

// x, y (B, C) int64; valid (B, C) bool; scratch int32
// [pgrtk_row_rank_scratch(B, C)]; keep (B, C) bool.
extern "C" int pgrtk_min_span_filter_gapped(const void* x, const void* y,
                                            const void* valid, int B,
                                            long long C, int min_span,
                                            void* scratch, void* keep,
                                            void* stream) {
  const long long n = (long long)B * C;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const RankScratch s = pgrtk::carve_rank((int*)scratch, B, C);
  pgrtk::row_rank((const bool*)valid, B, C, s, st);
  const int threads = 256;
  min_span_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                    st>>>((const int64_t*)x, (const int64_t*)y,
                          (const bool*)valid, C, n, min_span, s, (bool*)keep);
  return (int)cudaGetLastError();
}

// Number of int32 summary entries pgrtk_pair_mers_gapped needs for a
// (B, C) stream: the first kept column of each 1024-entry tile.
extern "C" long long pgrtk_pair_summary_ints(int B, long long C) {
  return (long long)B * pair_tiles(C);
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
  const int summary_warps = 8;
  for (int r0 = 0; r0 < B; r0 += pgrtk::kMaxGridY) {
    const int rows = B - r0 < pgrtk::kMaxGridY ? B - r0 : pgrtk::kMaxGridY;
    if (nt > 1)  // a single tile has nothing after it
      pair_summary_kernel<<<dim3((unsigned)((nt + summary_warps - 1) /
                                            summary_warps),
                                 (unsigned)rows),
                            summary_warps * 32, 0, st>>>(
          (const bool*)kept, C, nt, r0, (int*)summary);
    pair_kernel<<<dim3((unsigned)nt, (unsigned)rows), kPairThreads, 0, st>>>(
        (const int64_t*)x, (const int64_t*)y, (const bool*)kept, C, nt, r0,
        tie_one, (const int*)summary, (int64_t*)k0, (int64_t*)k1,
        (int64_t*)bgn, (int64_t*)end, (int64_t*)ori, (bool*)pair_valid);
  }
  return (int)cudaGetLastError();
}
