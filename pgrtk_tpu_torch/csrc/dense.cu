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
// looks for the nearest valid entry; it is not built as K3.  Two
// launches: one block per row counts its valid entries, then one thread
// per entry applies the rule.
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

__global__ void row_count_kernel(const bool* __restrict__ valid, i64 C,
                                 int* __restrict__ count) {
  __shared__ int warp_sums[32];
  const bool* v = valid + (i64)blockIdx.x * C;
  int c = 0;
  for (i64 i = threadIdx.x; i < C; i += blockDim.x) c += v[i];
  int total;
  pgrtk::block_exclusive_scan(c, &total, warp_sums);
  if (threadIdx.x == 0) count[blockIdx.x] = total;
}

__global__ void min_span_dense_kernel(const i64* __restrict__ x,
                                      const i64* __restrict__ y,
                                      const bool* __restrict__ valid, i64 C,
                                      i64 n, int min_span,
                                      const int* __restrict__ count,
                                      bool* __restrict__ keep) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const i64 i = g % C;
  bool k = false;
  if (valid[g]) {
    if (i == 0 || i == (i64)count[g / C] - 1) {
      k = true;
    } else {  // i > 0: the previous index is in the row
      const i64 pos = y[g] >> 1;
      const i64 xx = x[g];
      const bool has_next = i + 1 < C;
      const i64 n_pos = has_next ? y[g + 1] >> 1 : 0;
      const i64 n_x = has_next ? x[g + 1] : 0;
      k = pos - (y[g - 1] >> 1) > min_span && n_pos - pos > min_span &&
          x[g - 1] != xx && n_x != xx;
    }
  }
  keep[g] = k;
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

// K18.  (B, C) planes x, y (int64), valid (bool); count: B int32 of
// scratch.  Writes keep (B, C) bool.
extern "C" int pgrtk_min_span_filter_dense(const void* x, const void* y,
                                           const void* valid, long long B,
                                           long long C, int min_span,
                                           void* count, void* keep,
                                           void* stream) {
  if (B < 0 || C < 0 || B > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const i64 n = B * C;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  row_count_kernel<<<(unsigned)B, kThreads, 0, st>>>((const bool*)valid, C,
                                                    (int*)count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  min_span_dense_kernel<<<blocks(n), kThreads, 0, st>>>(
      (const i64*)x, (const i64*)y, (const bool*)valid, C, n, min_span,
      (const int*)count, (bool*)keep);
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
