// K18 min_span_filter_dense and K19 pair_mers_dense: the filter and the
// pairing of a DENSE compacted mer stream, where neighbours are the
// entries at the next and previous index, not the next valid entry.
//
// K18 replaces pgrtk_tpu/ops/pairs.py:221 min_span_filter_dense.  An entry
// is kept when it is valid and it is at index 0, or at index n_valid - 1
// (n_valid the row's count of valid entries, wherever they lie), or its
// index neighbours (0 past either end, as the JAX roll-and-set fills)
// are more than min_span away on both sides and hold other hashes.  On a
// mask that is not a valid prefix this differs from K3 (pairs.cu), which
// looks for the nearest valid entry; it is not built as K3.  What bounds
// it: the valid mask read once, x and y only where an entry is valid (a
// quarter of the index path's slots) and a flag written per entry.  Two
// launches.  The first is a block per 2,048-column tile of a row, 8
// columns a lane, a warp's 256 columns in contiguous runs (lane l takes
// l, l + 32, ...; a column's neighbours come from the lanes beside it by
// shuffles).  It counts the tile's valid entries into a partial count
// (so no memset), and only where a warp holds a valid entry reads x and
// y, then applies the rule but for the n_valid - 1 term.  The second, a
// warp per row, sums the row's partials to n_valid and sets
// keep[n_valid - 1] where that entry is valid.  The input planes are read
// in place at their row strides and offsets (the dense pipeline hands
// K18 the first `capacity` columns of wider planes; a copy would cost
// more than the kernel).
//
// K19 replaces pgrtk_tpu/ops/pairs.py:248 pair_mers_dense.  Entry i pairs
// mer i with mer i + 1 (the JAX roll by one; the last column never pairs),
// the key is the ordered pair of 56-bit hashes with the index tie rule (a
// tie keeps orientation 0, seq_db.rs:391), bgn and end are the positions
// plus one.  One thread per entry; an entry without a pair is 0, as K4
// writes it.
//
// What bounds both on this card: device memory (each plane read about
// once, the outputs written once); the work per entry is a few compares.
// The TPU form shifted whole planes with jnp.roll; here a thread reads
// its neighbour's index.
#include "common.cuh"

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;

constexpr int kPer = 8;                  // K18: columns a lane
constexpr int kSpan = 32 * kPer;         // K18: columns a warp
constexpr int kTile = kThreads * kPer;   // K18: columns a block

// The row strides of K18's input planes, in elements.
struct Strides {
  i64 x, y, valid;
};

// K18's first launch: block blockIdx.x is tile (blockIdx.x % tiles) of
// row (blockIdx.x / tiles); a warp takes kSpan columns, lane l columns
// l, l + 32, ..., so every load and store of the warp is one contiguous
// run, and a column's neighbours are the lanes beside it (shuffles).
__global__ void __launch_bounds__(kThreads)
    min_span_tile_kernel(const i64* __restrict__ x, const i64* __restrict__ y,
                         const bool* __restrict__ valid, Strides st, i64 C,
                         i64 tiles, int min_span, int* __restrict__ partial,
                         bool* __restrict__ keep) {
  __shared__ int warp_sums[32];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const i64 r = blockIdx.x / tiles;
  const i64 s0 = (i64)(blockIdx.x % tiles) * kTile + (threadIdx.x >> 5) *
                 kSpan;  // the warp's first column
  x += r * st.x;
  y += r * st.y;
  valid += r * st.valid;
  keep += r * C;
  unsigned m = 0;  // bit j: column s0 + lane + 32 j is valid
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const i64 c = s0 + lane + 32 * j;
    if (c < C && valid[c]) m |= 1u << j;
  }
  int total;
  pgrtk::block_exclusive_scan(__popc(m), &total, warp_sums);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
  unsigned kp = 0;  // bit j: keep the column (but the n_valid - 1 rule)
  if (__any_sync(full, m)) {
    // x and y only where the warp has a valid column; 0 past the row's
    // end, as the JAX fill
    i64 xv[kPer], pv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const i64 c = s0 + lane + 32 * j;
      xv[j] = c < C ? x[c] : 0;
      pv[j] = c < C ? y[c] >> 1 : 0;
    }
    // the span's outer neighbours, 0 past the row's ends
    i64 xw = s0 > 0 ? x[s0 - 1] : 0;  // at lane 0: the column before
    i64 pw = s0 > 0 ? y[s0 - 1] >> 1 : 0;
    const bool more = s0 + kSpan < C;
    const i64 xr = more ? x[s0 + kSpan] : 0;
    const i64 pr = more ? y[s0 + kSpan] >> 1 : 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      // the previous column is lane - 1's (lane 0: lane 31's of j - 1),
      // the next lane + 1's (lane 31: lane 0's of j + 1)
      const int jn = j + 1 < kPer ? j + 1 : j;
      const i64 xe = __shfl_sync(full, xv[jn], 0);
      const i64 pe = __shfl_sync(full, pv[jn], 0);
      i64 xp = __shfl_up_sync(full, xv[j], 1);
      i64 pp = __shfl_up_sync(full, pv[j], 1);
      i64 xn = __shfl_down_sync(full, xv[j], 1);
      i64 pn = __shfl_down_sync(full, pv[j], 1);
      if (lane == 0) {
        xp = xw;
        pp = pw;
      }
      if (lane == 31) {
        xn = j + 1 < kPer ? xe : xr;
        pn = j + 1 < kPer ? pe : pr;
      }
      xw = __shfl_sync(full, xv[j], 31);
      pw = __shfl_sync(full, pv[j], 31);
      const bool ok =
          s0 + lane + 32 * j == 0 ||
          (pv[j] - pp > min_span && pn - pv[j] > min_span && xp != xv[j] &&
           xn != xv[j]);
      kp |= (((m >> j) & 1u) && ok) << j;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const i64 c = s0 + lane + 32 * j;
    if (c < C) keep[c] = (kp >> j) & 1u;
  }
}

// K18's second launch: a warp a row sums its tiles' counts to n_valid and
// keeps the entry at n_valid - 1 where it is valid.
__global__ void last_valid_kernel(const bool* __restrict__ valid,
                                  i64 valid_stride, i64 B, i64 C, i64 tiles,
                                  const int* __restrict__ partial,
                                  bool* __restrict__ keep) {
  const i64 r = ((i64)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= B) return;  // whole warps leave together
  int s = 0;
  for (i64 t = lane; t < tiles; t += 32) s += partial[r * tiles + t];
  s = __reduce_add_sync(0xffffffffu, s);
  if (lane == 0 && s > 0 && valid[r * valid_stride + s - 1])
    keep[r * C + s - 1] = true;
}

__global__ void pair_dense_kernel(const i64* __restrict__ x,
                                  const i64* __restrict__ y,
                                  const bool* __restrict__ valid, i64 C, i64 n,
                                  i64* __restrict__ k0, i64* __restrict__ k1,
                                  i64* __restrict__ bgn, i64* __restrict__ end,
                                  i64* __restrict__ ori,
                                  bool* __restrict__ pair_valid) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const bool ok = g % C + 1 < C && valid[g] && valid[g + 1];
  i64 a = 0, b = 0, s = 0, e = 0, o = 0;
  if (ok) {
    const i64 h = (i64)((u64)x[g] >> 8);  // logical: x is a u64 pattern
    const i64 nh = (i64)((u64)x[g + 1] >> 8);
    const bool swap = h > nh;
    a = swap ? nh : h;
    b = swap ? h : nh;
    s = (y[g] >> 1) + 1;
    e = (y[g + 1] >> 1) + 1;
    o = swap;
  }
  k0[g] = a;
  k1[g] = b;
  bgn[g] = s;
  end[g] = e;
  ori[g] = o;
  pair_valid[g] = ok;
}

unsigned blocks(i64 n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// K18's partial counts: B * ceil(C / 2,048) int32.
extern "C" long long pgrtk_min_span_dense_ints(long long B, long long C) {
  return B * ((C + kTile - 1) / kTile);
}

// K18.  (B, C) planes x, y (int64), valid (bool), each at its row
// stride (elements; columns contiguous); partial:
// pgrtk_min_span_dense_ints(B, C) int32 of scratch.  Writes keep (B, C)
// bool, contiguous.
extern "C" int pgrtk_min_span_filter_dense(
    const void* x, const void* y, const void* valid, long long B,
    long long C, long long x_stride, long long y_stride,
    long long valid_stride, int min_span, void* partial, void* keep,
    void* stream) {
  if (B < 0 || C < 0 || C > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  const i64 tiles = (C + kTile - 1) / kTile;
  if (B * tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Strides sd{x_stride, y_stride, valid_stride};
  min_span_tile_kernel<<<(unsigned)(B * tiles), kThreads, 0, st>>>(
      (const i64*)x, (const i64*)y, (const bool*)valid, sd, C, tiles,
      min_span, (int*)partial, (bool*)keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  last_valid_kernel<<<blocks(B * 32), kThreads, 0, st>>>(
      (const bool*)valid, valid_stride, B, C, tiles, (const int*)partial,
      (bool*)keep);
  return (int)cudaGetLastError();
}

// K19.  (B, C) planes x, y (int64), valid (bool).  Writes the (B, C) pair
// planes k0, k1, bgn, end, orientation (int64) and pair_valid (bool).
extern "C" int pgrtk_pair_mers_dense(const void* x, const void* y,
                                     const void* valid, long long B,
                                     long long C, void* k0, void* k1,
                                     void* bgn, void* end, void* ori,
                                     void* pair_valid, void* stream) {
  if (B < 0 || C < 0) return (int)cudaErrorInvalidValue;
  const i64 n = B * C;
  if (n == 0) return (int)cudaSuccess;
  pair_dense_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const i64*)x, (const i64*)y, (const bool*)valid, C, n, (i64*)k0,
      (i64*)k1, (i64*)bgn, (i64*)end, (i64*)ori, (bool*)pair_valid);
  return (int)cudaGetLastError();
}
