// Row-wide ranks of a (B, C) bool mask, for rows wider than a block.
//
// For each row: rank_excl[c] counts the set entries strictly before
// column c, vidx[r] is the column of the set entry of rank r (a
// compacted index of the set columns), and totals[b] counts them all.
// Three launches over 1024-entry tiles: per-tile counts, a per-row scan
// of the tile counts, and the per-tile scan with the tile's offset
// added.  The exact walk (walk.cuh, for sketch.cu and sketch1.cu) uses it
// to find the nearest chunk with an ACGT base before a chunk directly.
#pragma once

#include "common.cuh"

namespace pgrtk {
// Internal linkage throughout: each translation unit that includes this
// header gets its own copy of the kernels.
namespace {

constexpr int kTile = 1024;

struct RankScratch {
  int* tile_counts;  // (B, ntiles)
  int* tile_off;     // (B, ntiles)
  int* totals;       // (B,)
  int* rank_excl;    // (B, C) set entries strictly before each column
  int* vidx;         // (B, C) column of the set entry of each rank
};

__host__ __device__ inline long long n_tiles(long long C) {
  return (C + kTile - 1) / kTile;
}

// int32 entries of scratch a (B, C) mask needs.
inline long long rank_scratch_ints(int B, long long C) {
  return 2 * B * n_tiles(C) + B + 2 * B * C;
}

inline RankScratch carve_rank(int* p, int B, long long C) {
  const long long nt = n_tiles(C);
  RankScratch s;
  s.tile_counts = p;
  s.tile_off = p + B * nt;
  s.totals = p + 2 * B * nt;
  s.rank_excl = s.totals + B;
  s.vidx = s.rank_excl + B * C;
  return s;
}

__global__ void tile_count_kernel(const bool* __restrict__ mask, long long C,
                                  int row0, int* __restrict__ tile_counts) {
  __shared__ int warp_sums[32];
  const long long b = (long long)row0 + blockIdx.y;
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const int v = (i < C && mask[b * C + i]) ? 1 : 0;
  int total;
  block_exclusive_scan(v, &total, warp_sums);
  if (threadIdx.x == 0) tile_counts[b * gridDim.x + blockIdx.x] = total;
}

__global__ void tile_offset_kernel(const int* __restrict__ tile_counts,
                                   int ntiles, int* __restrict__ tile_off,
                                   int* __restrict__ totals) {
  __shared__ int warp_sums[32];
  const long long b = blockIdx.x;
  int carry = 0;
  for (int t0 = 0; t0 < ntiles; t0 += kTile) {
    const int t = t0 + threadIdx.x;
    const int v = t < ntiles ? tile_counts[b * ntiles + t] : 0;
    int total;
    const int ex = block_exclusive_scan(v, &total, warp_sums);
    if (t < ntiles) tile_off[b * ntiles + t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) totals[b] = carry;
}

__global__ void tile_rank_kernel(const bool* __restrict__ mask, long long C,
                                 int row0, const int* __restrict__ tile_off,
                                 int* __restrict__ rank_excl,
                                 int* __restrict__ vidx) {
  __shared__ int warp_sums[32];
  const long long b = (long long)row0 + blockIdx.y;
  const long long i = (long long)blockIdx.x * kTile + threadIdx.x;
  const bool in = i < C;
  const int v = (in && mask[b * C + i]) ? 1 : 0;
  int total;
  const int ex = block_exclusive_scan(v, &total, warp_sums) +
                 tile_off[b * gridDim.x + blockIdx.x];
  if (in) {
    rank_excl[b * C + i] = ex;
    if (v) vidx[b * C + ex] = (int)i;
  }
}

// rank_excl, vidx and totals of `mask` (B, C) into the scratch buffer.
inline void row_rank(const bool* mask, int B, long long C,
                     const RankScratch& s, cudaStream_t stream) {
  const long long nt = n_tiles(C);
  for (int r0 = 0; r0 < B; r0 += kMaxGridY) {
    const int rows = B - r0 < kMaxGridY ? B - r0 : kMaxGridY;
    const dim3 grid((unsigned)nt, (unsigned)rows);
    tile_count_kernel<<<grid, kTile, 0, stream>>>(mask, C, r0,
                                                  s.tile_counts);
  }
  tile_offset_kernel<<<B, kTile, 0, stream>>>(s.tile_counts, (int)nt,
                                              s.tile_off, s.totals);
  for (int r0 = 0; r0 < B; r0 += kMaxGridY) {
    const int rows = B - r0 < kMaxGridY ? B - r0 : kMaxGridY;
    const dim3 grid((unsigned)nt, (unsigned)rows);
    tile_rank_kernel<<<grid, kTile, 0, stream>>>(mask, C, r0, s.tile_off,
                                                 s.rank_excl, s.vidx);
  }
}

}  // namespace
}  // namespace pgrtk
