// K5: the fence probe of the pair-key table, one core behind three
// entries: probe_fetch (the JAX-shaped probe fused with the postings-row
// fetch, or with width 0 the probe alone: the found-only use of
// parallel/device_query.py) and probe_step (the query step's: found and
// the row index only, and the step's n_q_filtered counter zeroed, so K6's
// step entry can add to it with no fill launch between).  K11
// probe_keys: the probe of the padded-bucket layout.
//
// Replaces pgrtk_tpu/ops/probe.py:228 probe_keys_aligned (window 128)
// and :282 probe_keys_dense (window 256), and the row gather that
// follows them in pgrtk_tpu/ops/query_e2e.py:612-620.
//
// What bounds it on this card: memory latency.  Each key is a chain of
// dependent reads: its two words, its bucket's two fence words, the
// bucket's key slots, and (probe_fetch) a postings row of 3P words.  At
// the query step's ~25k keys against a 4.2M-key table the card is far
// from its bandwidth (the bound is the slots of the buckets probed,
// ~0.003 ms); the chain and the keys in flight are the cost.
//
// Design: a key's matches can only lie in its bucket, [fence[b],
// fence[b+1]) with b = k0 >> (56 - bits), because the table is
// key-sorted and every pad slot holds k0 = -1, which no key with k0 <
// 2^56 equals.  Under the pair rule (`pair` 1, a table whose keys share
// k0 too deeply for any k0 bucket; ops/probe.py RULE_PAIR) b = ((k0 ^ k1 *
// kPairMix) * kPairMix) >> (64 - bits) as u64, the table in (bucket, k0,
// k1) order; a key with a half past 56 bits, as a pad's, takes no bucket,
// so it matches nothing.  So the core scans only the part of the bucket
// inside the JAX window [base, base + window), base = fence[b] rounded
// down to its 128-slot row: the first match there is the first match in
// the window (jnp.argmax's first maximum; the lowest of duplicate keys in
// the dense layout), and a dense bucket that runs past its window stays
// not found beyond it, as in JAX.  A bucket at or past n_fence - 1 (k0 >=
// 2^56) has no end and is not found.  Eight lanes take a key (four keys a
// warp), each lane comparing 4 slots of a 32-slot step with all its loads
// in flight together; a bucket of up to 32 keys (the tables' average is
// 16-32) is one step.  (A thread a key, timed against it, was 3x slower:
// PERF.md, run D.)  The group's two fence words come in one load (lane
// pairs), k1 is read only on the slots whose k0 matches, and the group
// stops at its first step with a match.  probe_fetch then copies each
// key's row (or the not-found sentinel, the last row) with the whole warp,
// key by key, in coalesced 4-byte loads.
#include "common.cuh"

namespace {

constexpr int kNone = 0x7fffffff;
constexpr unsigned long long kPairMix = 0x9E3779B97F4A7C15ull;  // PAIR_MIX

__global__ void probe_kernel(
    const long long* __restrict__ qk0, const long long* __restrict__ qk1,
    long long Q, int shift, int pair, const long long* __restrict__ tk0,
    const long long* __restrict__ tk1, long long n_slots,
    const int* __restrict__ fence, long long n_fence, int window,
    const int* __restrict__ p_rows, long long n_rows, int width,
    bool* __restrict__ found_out, int* __restrict__ row_out,
    int* __restrict__ rows_out, unsigned long long* __restrict__ zero) {
  constexpr int G = 8;  // lanes a key
  constexpr int U = 32 / G;  // slots a lane compares a step
  constexpr int KW = 32 / G;  // keys a warp
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int j = lane % G;  // the lane's place in its key's group
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long q = warp * KW + lane / G;
  if (zero != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *zero = 0;
  long long k0 = 0, k1 = 0;
  bool in = false;
  unsigned long long b = 0;
  if (q < Q) {
    k0 = qk0[q];
    k1 = qk1[q];
    const unsigned long long u0 = k0, u1 = k1;
    if (!pair)
      b = u0 >> shift;
    else if ((u0 | u1) >> 56)
      b = ~0ull;  // no bucket
    else
      b = ((u0 ^ u1 * kPairMix) * kPairMix) >> (shift + 8);
    in = n_fence > 1 && b < (unsigned long long)(n_fence - 1);
  }
  // lanes 0 and 1 of the group load fence[b] and fence[b + 1]
  const int f = in ? fence[b + (j & 1)] : 0;
  const int f0 = __shfl_sync(full, f, lane - j);
  const int f1 = __shfl_sync(full, f, lane - j + 1);
  int lo = 0, hi = 0;
  if (in) {
    const long long end = min(min((long long)f1, ((long long)(f0 >> 7) << 7)
                                                     + window),
                              n_slots);
    lo = f0;
    hi = (int)max(end, (long long)f0);
  }
  int hit = kNone;
  for (int s0 = lo; __any_sync(full, hit == kNone && s0 < hi); s0 += 32) {
    const bool scan = hit == kNone;
    long long t0[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + j + G * u;
      live[u] = scan && s < hi;
      t0[u] = live[u] ? tk0[s] : 0;
    }
    int best = kNone;
#pragma unroll
    for (int u = U - 1; u >= 0; --u) {  // descending: the lowest slot wins
      const int s = s0 + j + G * u;
      if (live[u] && t0[u] == k0 && tk1[s] == k1) best = s;
    }
#pragma unroll
    for (int d = G / 2; d > 0; d >>= 1)
      best = min(best, __shfl_xor_sync(full, best, d));
    hit = min(hit, best);
  }
  const bool found = hit != kNone;
  if (q < Q && j == 0) {
    found_out[q] = found;
    row_out[q] = found ? hit : -1;
  }
  if (width == 0) return;  // uniform: probe only
  // the warp copies its keys' rows one key at a time
  const long long q0 = warp * KW;
#pragma unroll 1
  for (int k = 0; k < KW && q0 + k < Q; ++k) {
    const int r = __shfl_sync(full, found ? hit : -1, k * G);
    const long long fetch = r >= 0 ? r : n_rows - 1;
    int* dst = rows_out + (q0 + k) * width;
    if (fetch < n_rows) {
      const int* src = p_rows + fetch * width;
      for (int w = lane; w < width; w += 32) dst[w] = src[w];
    } else {
      for (int w = lane; w < width; w += 32) dst[w] = -1;
    }
  }
}

int probe_launch(const void* qk0, const void* qk1, long long Q, int bits,
                 int pair, const void* tk0, const void* tk1, long long n_slots,
                 const void* fence, long long n_fence, int window,
                 const void* p_rows, long long n_rows, int width, void* found,
                 void* row, void* rows, void* zero, cudaStream_t st) {
  if (bits < 1 || bits > 56 || (pair != 0 && pair != 1) ||
      (window != 128 && window != 256) ||
      n_slots < 1 || n_slots > 0x7fffffffll || width < 0 ||
      (width > 0 && n_rows < 1))
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const long long blocks = (Q + 31) / 32;  // 32 keys a block of 256 threads
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  probe_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      (const long long*)qk0, (const long long*)qk1, Q, 56 - bits, pair,
      (const long long*)tk0, (const long long*)tk1, n_slots,
      (const int*)fence, n_fence, window, (const int*)p_rows, n_rows, width,
      (bool*)found, (int*)row, (int*)rows, (unsigned long long*)zero);
  return (int)cudaGetLastError();
}

}  // namespace

// qk0/qk1 (Q,) int64 query keys; tk0/tk1 (n_slots,) int64 table planes;
// fence (n_fence,) int32; p_rows (n_rows, width) int32; outputs found
// (Q,) bool, row (Q,) int32, rows (Q, width) int32.  window is 128 or
// 256.  width 0 (p_rows and rows unused) probes only.  pair 1 takes the
// pair rule's bucket, 0 the k0 rule's.
extern "C" int pgrtk_probe_fetch(const void* qk0, const void* qk1,
                                 long long Q, int bits, int pair,
                                 const void* tk0, const void* tk1,
                                 long long n_slots,
                                 const void* fence, long long n_fence,
                                 int window, const void* p_rows,
                                 long long n_rows, int width, void* found,
                                 void* row, void* rows, void* stream) {
  return probe_launch(qk0, qk1, Q, bits, pair, tk0, tk1, n_slots, fence,
                      n_fence, window, p_rows, n_rows, width, found, row,
                      rows, nullptr, (cudaStream_t)stream);
}

// The query step's entry: found (Q,) bool and row (Q,) int32 as above, no
// rows; *zero (one uint64, the step's n_q_filtered) is set to 0.  Q > 0.
extern "C" int pgrtk_probe_step(const void* qk0, const void* qk1,
                                long long Q, int bits, int pair,
                                const void* tk0, const void* tk1,
                                long long n_slots,
                                const void* fence, long long n_fence,
                                int window, void* found, void* row,
                                void* zero, void* stream) {
  if (Q < 1 || zero == nullptr) return (int)cudaErrorInvalidValue;
  return probe_launch(qk0, qk1, Q, bits, pair, tk0, tk1, n_slots, fence,
                      n_fence, window, nullptr, 0, 0, found, row, nullptr,
                      zero, (cudaStream_t)stream);
}

// K11 probe_keys: probe of the padded-bucket layout.
//
// Replaces pgrtk_tpu/ops/probe.py:88 probe_keys (with _probe_hits :63),
// the fallback of parallel/device_query.py:46-52 when a bucket overflows
// the aligned 128-slot window, and the probe of the v1 probe step
// (parallel/mesh.py::sharded_query_probe_step).
//
// What bounds it on this card: the loads of its searches.  A mode-1 store
// keys on window minima, which crowd into the low buckets, so W is
// widened to thousands of slots for one bucket (8,192 at phase 7b's store,
// 16,384 at the SV path's): a scan of the bucket reads thousands of slots
// a key (~4,450 occupied at 7b), where a key needs only its lower bound
// in its bucket, about log2(occupied + 1) dependent reads.
//
// Design: the table is built from a KEY-SORTED key array (both packages'
// build_probe_table), so bucket b's entries sit key-sorted at slots
// [b W, b W + count) and all-ones pads follow them.  Compared as unsigned
// words, (k0, k1) then ascends over the whole bucket: a pad's k0 (2^64 -
// 1) is above every key whose k0 is a 56-bit hash, the only keys whose
// bucket lies inside the table.  The lowest row among a key's hits is its
// first hit (the row plane ascends with the slots), and the first hit is
// the lower bound of (k0, k1) when the slot there holds the key.  So a
// thread takes a key and halves its bucket's W slots while more than
// kScan can hold the lower bound, reading a pivot's k1 only where its k0
// is the key's; it reads the slots left (k0 and k1) in one round of
// loads, then the slot at the lower bound (its keys and row) and writes
// found and row.  A key whose bucket lies past the table (k0 >= 2^56) is
// not found.  On an H100, groups of 2 to 32 lanes a key (fewer rounds,
// more loads) and a first round of the pivots 2^i - 1 ran slower at all
// three shapes the main path gives it, and reading k1 beside k0 in each
// round cost a third more at the v1 probe step's 1,769,472 keys
// (PERF.md).  Precondition: each bucket's entries key-sorted before its
// pads; the plain version and JAX compare the whole bucket.
namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kScan = 8;  // slots of the last round, read together

__device__ __forceinline__ bool key_below(u64 a0, u64 a1, u64 b0, u64 b1) {
  return a0 < b0 || (a0 == b0 && a1 < b1);
}

__global__ void __launch_bounds__(256)
    probe_keys_kernel(const u64* __restrict__ qk0, const u64* __restrict__ qk1,
                      i64 Q, int shift, const u64* __restrict__ tk0,
                      const u64* __restrict__ tk1,
                      const int* __restrict__ trow, u64 n_buckets, int W,
                      bool* __restrict__ found_out,
                      int* __restrict__ row_out) {
  const i64 q = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const u64 k0 = qk0[q], k1 = qk1[q];
  const u64 b = k0 >> shift;
  bool f = false;
  int r = -1;
  if (b < n_buckets) {
    // the lower bound lies in [lo, lo + n]: the slots before lo are below
    // the key, the slots from lo + n on are not
    const i64 start = (i64)b * W;
    i64 lo = start, n = W;
    while (n > kScan) {
      const i64 p = lo + n / 2;
      const u64 a0 = tk0[p];
      if (a0 < k0 || (a0 == k0 && tk1[p] < k1)) {
        n -= p + 1 - lo;
        lo = p + 1;
      } else {
        n = p - lo;
      }
    }
    int nb = 0;
#pragma unroll
    for (int s = 0; s < kScan; ++s)  // no exit: the loads go together
      if (s < n) nb += key_below(tk0[lo + s], tk1[lo + s], k0, k1);
    const i64 lb = lo + nb;
    if (lb < start + W) {
      const u64 a0 = tk0[lb], a1 = tk1[lb];
      const int at = trow[lb];
      f = a0 == k0 && a1 == k1;
      r = f ? at : -1;
    }
  }
  found_out[q] = f;
  row_out[q] = r;
}

}  // namespace

// qk0/qk1 (Q,) int64 query keys; tk0/tk1 (2^bits * W,) int64 planes and
// trow (2^bits * W,) int32 row plane, each bucket's entries key-sorted
// before its all-ones pads; outputs found (Q,) bool, row (Q,) int32.  W a
// positive multiple of 128.
extern "C" int pgrtk_probe_keys(const void* qk0, const void* qk1,
                                long long Q, int bits, const void* tk0,
                                const void* tk1, const void* trow, int W,
                                void* found, void* row, void* stream) {
  if (bits < 1 || bits > 56 || W < 128 || W % 128 || Q < 0)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const i64 blocks = (Q + 255) / 256;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  probe_keys_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const u64*)qk0, (const u64*)qk1, Q, 56 - bits, (const u64*)tk0,
      (const u64*)tk1, (const int*)trow, 1ull << bits, W, (bool*)found,
      (int*)row);
  return (int)cudaGetLastError();
}
