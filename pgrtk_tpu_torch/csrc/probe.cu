// K5 probe_fetch: fence probe of the pair-key table fused with the
// postings-row fetch (or, with width 0, the probe alone: the found-only
// use of parallel/device_query.py).  K11 probe_keys: the probe of the
// padded-bucket layout.
//
// Replaces pgrtk_tpu/ops/probe.py:228 probe_keys_aligned (window 128)
// and :282 probe_keys_dense (window 256), and the row gather that
// follows them in pgrtk_tpu/ops/query_e2e.py:612-620.
//
// What bounds it on this card: memory latency.  Each key costs a random
// 4-byte fence read, a read of its bucket's window (16 bytes per slot,
// one 2 KB row for the aligned layout, often left early) that depends on
// it, and one postings row (3P words, 384 bytes at P=32) that depends on
// the match.  At the query step's ~25k keys against a 4.2M-key table the
// card is far from its bandwidth; the dependent chain of three reads is
// the cost.
//
// Design: one warp per query key.  Lane l compares slots base + c + l
// of the window, c stepping by 32; a ballot finds the lowest matching
// slot (jnp.argmax's first maximum) and the warp stops at the first
// 32-slot step with a match.  Slots past the table read as all-ones pad,
// as jnp.take fills them.  The warp then copies the matched row (or the
// not-found sentinel, the last row) with coalesced 4-byte loads.
#include "common.cuh"

namespace {

__global__ void probe_fetch_kernel(
    const long long* __restrict__ qk0, const long long* __restrict__ qk1,
    long long Q, int shift, const long long* __restrict__ tk0,
    const long long* __restrict__ tk1, long long n_slots,
    const int* __restrict__ fence, long long n_fence, int window,
    const int* __restrict__ p_rows, long long n_rows, int width,
    bool* __restrict__ found_out, int* __restrict__ row_out,
    int* __restrict__ rows_out) {
  const unsigned full = 0xffffffffu;
  const long long q =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;  // uniform across the warp
  const long long k0 = qk0[q];
  const long long k1 = qk1[q];
  const unsigned long long bucket = (unsigned long long)k0 >> shift;
  int hit = -1;
  long long base = 0;
  if (bucket < (unsigned long long)n_fence) {
    base = (long long)(fence[bucket] >> 7) << 7;
    for (int c = 0; c < window; c += 32) {
      const long long s = base + c + lane;
      const long long t0 = s < n_slots ? tk0[s] : -1;
      const long long t1 = s < n_slots ? tk1[s] : -1;
      const unsigned m = __ballot_sync(full, t0 == k0 && t1 == k1);
      if (m) {
        hit = c + __ffs(m) - 1;
        break;
      }
    }
  }
  const bool found = hit >= 0;
  const long long row = found ? base + hit : -1;
  if (lane == 0) {
    found_out[q] = found;
    row_out[q] = (int)row;
  }
  if (width == 0) return;  // probe only
  const long long fetch = found ? row : n_rows - 1;
  int* dst = rows_out + q * width;
  if (fetch < n_rows) {
    const int* src = p_rows + fetch * width;
    for (int w = lane; w < width; w += 32) dst[w] = src[w];
  } else {
    for (int w = lane; w < width; w += 32) dst[w] = -1;
  }
}

}  // namespace

// qk0/qk1 (Q,) int64 query keys; tk0/tk1 (n_slots,) int64 table planes;
// fence (n_fence,) int32; p_rows (n_rows, width) int32; outputs found
// (Q,) bool, row (Q,) int32, rows (Q, width) int32.  window is 128 or
// 256.  width 0 (p_rows and rows unused) probes only.
extern "C" int pgrtk_probe_fetch(const void* qk0, const void* qk1,
                                 long long Q, int bits, const void* tk0,
                                 const void* tk1, long long n_slots,
                                 const void* fence, long long n_fence,
                                 int window, const void* p_rows,
                                 long long n_rows, int width, void* found,
                                 void* row, void* rows, void* stream) {
  if (bits < 1 || bits > 56 || (window != 128 && window != 256) ||
      n_slots < 1 || width < 0 || (width > 0 && n_rows < 1))
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const int threads = 256;  // 8 keys per block
  const long long blocks = (Q + 7) / 8;
  probe_fetch_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const long long*)qk0, (const long long*)qk1, Q, 56 - bits,
      (const long long*)tk0, (const long long*)tk1, n_slots,
      (const int*)fence, n_fence, window, (const int*)p_rows, n_rows, width,
      (bool*)found, (int*)row, (int*)rows);
  return (int)cudaGetLastError();
}

// K11 probe_keys: probe of the padded-bucket layout.
//
// Replaces pgrtk_tpu/ops/probe.py:88 probe_keys (with _probe_hits :63),
// the fallback of parallel/device_query.py:46-52 when a bucket overflows
// the aligned 128-slot window.
//
// What bounds it on this card: memory latency, as K5: one dependent read
// of the bucket's W slots (16 bytes per slot plus the 4-byte row plane)
// per key, at a few hundred thousand keys per batch.
//
// Design: one warp per query key.  The bucket is k0 >> (56 - bits); lane
// l compares slots c + l of the bucket's W slots (W a multiple of 128), c
// stepping by 32 over all of them, and keeps the lowest row among its
// hits; a warp minimum gives the lowest row of the bucket (the JAX
// min over `where(hit, row, INT32_MAX)`).  A key whose bucket lies past
// the table (k0 >= 2^56) is not found.
namespace {

__global__ void probe_keys_kernel(const long long* __restrict__ qk0,
                                  const long long* __restrict__ qk1,
                                  long long Q, int shift,
                                  const long long* __restrict__ tk0,
                                  const long long* __restrict__ tk1,
                                  const int* __restrict__ trow,
                                  long long n_buckets, int W,
                                  bool* __restrict__ found_out,
                                  int* __restrict__ row_out) {
  const unsigned full = 0xffffffffu;
  const long long q =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;  // uniform across the warp
  const long long k0 = qk0[q];
  const long long k1 = qk1[q];
  const unsigned long long bucket = (unsigned long long)k0 >> shift;
  int best = 0x7fffffff;
  bool any = false;
  if (bucket < (unsigned long long)n_buckets) {
    const long long base = (long long)bucket * W;
    for (int c = lane; c < W; c += 32) {
      const long long s = base + c;
      if (tk0[s] == k0 && tk1[s] == k1) {
        any = true;
        best = min(best, trow[s]);
      }
    }
  }
  any = __any_sync(full, any);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    best = min(best, __shfl_xor_sync(full, best, d));
  if (lane == 0) {
    found_out[q] = any;
    row_out[q] = any ? best : -1;
  }
}

}  // namespace

// qk0/qk1 (Q,) int64 query keys; tk0/tk1 (2^bits * W,) int64 planes and
// trow (2^bits * W,) int32 row plane; outputs found (Q,) bool, row (Q,)
// int32.  W a positive multiple of 128.
extern "C" int pgrtk_probe_keys(const void* qk0, const void* qk1,
                                long long Q, int bits, const void* tk0,
                                const void* tk1, const void* trow, int W,
                                void* found, void* row, void* stream) {
  if (bits < 1 || bits > 56 || W < 128 || W % 128)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const int threads = 256;  // 8 keys per block
  probe_keys_kernel<<<(unsigned)((Q + 7) / 8), threads, 0,
                      (cudaStream_t)stream>>>(
      (const long long*)qk0, (const long long*)qk1, Q, 56 - bits,
      (const long long*)tk0, (const long long*)tk1, (const int*)trow,
      1ll << bits, W, (bool*)found, (int*)row);
  return (int)cudaGetLastError();
}
