// K16 pair_key_search: membership of pair keys in the replicated v1 table.
//
// Replaces pgrtk_tpu/parallel/mesh.py:259 _searchsorted_pairkey, the lookup
// of sharded_query_count_step (:169).  Each (k0, k1) int64 query key is
// looked up in the (N,) table sorted on (k0, k1), then tested for
// equality.  The table is the v1 table as it stands, invalid tail
// included: its keys are INT64_MAX, which no 56-bit hash equals, and both
// keys of every entry are either a hash in [0, 2^56) or that fill, so
// comparing them as signed int64 orders them as the JAX package's (hi, lo)
// u32 planes do.  `bad` is set when a query key, a table k0 or a table k1
// the search compares is neither (the wrapper raises, or the count step
// returns the flag).
//
// The TPU form ran ceil(log2(N + 1)) rounds of a vectorised binary search
// over four u32 planes.  A lower_bound over the whole table on this card
// is ~21 dependent loads a key, of which only the top levels are shared
// between keys: bound by the latency of that chain, not by bytes.  The
// keys are uniform 56-bit hashes, so the search is narrowed first: one
// pass over the table's k0 (a thread an entry, which also checks every
// k0) writes a directory of run starts on the top `dir_bits` bits of k0,
// dir[d] = the first entry whose bucket is at least d (the fill's bucket
// is 2^dir_bits, so the directory's last entry is the tail's start), with
// dir_bits about log2(N) - 3, a few entries a bucket.  Then a thread
// takes a key (more keys in flight than a group of lanes a key gives,
// which on an H100 ran slower: PERF.md): it reads its bucket's bounds
// dir[d], dir[d + 1], halves them while more than kScan positions can
// hold the lower bound, and reads the positions left (k0 and k1) in one
// round of loads and tests them for equality.  A bucket of up to kScan - 1
// entries (nearly all of them) takes no halving: the chain is the key,
// the directory and the bucket's entries.  Equal keys share k0 and so a
// bucket; the lower bound inside the bucket is the whole table's.
#include "common.cuh"

namespace {

typedef long long i64;

constexpr int kThreads = 256;
constexpr i64 kHashLimit = 1LL << 56;
constexpr i64 kFill = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ bool bad_key(i64 t) {
  return t < 0 || (t >= kHashLimit && t != kFill);
}

// The directory bucket of k0: its top bits; the fill (and any key at or
// above 2^56) D, a negative key 0, so that every bucket is in [0, D].
__device__ __forceinline__ i64 dir_bucket(i64 t, int shift, i64 D) {
  return t < 0 ? 0 : (t >= kHashLimit ? D : t >> shift);
}

// One thread an entry: dir[d] = i for the buckets d after its
// predecessor's, up to its own; the last entry also writes the buckets
// after its own with n.  On a sorted table every d in [0, D] is written
// once.
__global__ void pair_key_dir_kernel(const i64* __restrict__ tk0, i64 n,
                                    int shift, i64 D, i64* __restrict__ dir,
                                    i64* __restrict__ bad) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 t = tk0[i];
  const i64 b = dir_bucket(t, shift, D);
  const i64 a = i == 0 ? -1 : dir_bucket(tk0[i - 1], shift, D);
  for (i64 d = a + 1; d <= b; ++d) dir[d] = i;
  if (i == n - 1)
    for (i64 d = b + 1; d <= D; ++d) dir[d] = n;
  if (bad_key(t)) *bad = 1;
}

// positions a key's final scan reads in one round of loads
constexpr int kScan = 8;

__global__ void __launch_bounds__(kThreads)
    pair_key_search_kernel(const i64* __restrict__ tk0,
                           const i64* __restrict__ tk1, i64 n,
                           const i64* __restrict__ dir, int shift, i64 D,
                           const i64* __restrict__ qk0,
                           const i64* __restrict__ qk1, i64 Q,
                           bool* __restrict__ found, i64* __restrict__ bad) {
  const i64 q = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const i64 a = qk0[q];
  const i64 b = qk1[q];
  bool odd = a < 0 || a >= kHashLimit || b < 0 || b >= kHashLimit;
  bool f = false;
  if (n > 0) {
    // the lower bound of (a, b) is in [lo, hi]; entries from `end` on are
    // past the bucket (clamped, so that a table that is not sorted reads
    // nothing outside)
    const i64 d = min(dir_bucket(a, shift, D), D - 1);
    const i64 end = min(max(dir[d + 1], 0LL), n);
    i64 lo = min(max(dir[d], 0LL), end), hi = end;
    while (hi - lo >= kScan) {
      const i64 mid = lo + ((hi - lo) >> 1);
      const i64 t0 = tk0[mid], t1 = tk1[mid];
      odd |= bad_key(t1);
      if (t0 < a || (t0 == a && t1 < b))
        lo = mid + 1;
      else
        hi = mid;
    }
#pragma unroll
    for (int j = 0; j < kScan; ++j) {  // no exit: the loads go together
      const i64 p = lo + j;
      if (p <= hi && p < end) {
        const i64 t0 = tk0[p], t1 = tk1[p];
        odd |= bad_key(t1);
        f |= t0 == a && t1 == b;
      }
    }
  }
  found[q] = f;
  if (odd) *bad = 1;
}

int blocks(i64 n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

// K16.  Table keys tk0, tk1 (int64, n entries, sorted on (k0, k1)), query
// keys qk0, qk1 (int64, Q of them), dir_bits in [0, 40].  work: 2^dir_bits
// + 2 int64, the directory and then the flag.  Writes found (Q,) bool and
// the flag, non-zero when a key it read is neither a 56-bit hash nor, in
// the table, the INT64_MAX fill.
extern "C" int pgrtk_pair_key_search(const void* tk0, const void* tk1,
                                     long long n, const void* qk0,
                                     const void* qk1, long long Q,
                                     int dir_bits, void* work, void* found,
                                     void* stream) {
  if (n < 0 || Q < 0 || dir_bits < 0 || dir_bits > 40)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const i64 D = (i64)1 << dir_bits;
  const int shift = 56 - dir_bits;
  i64* dir = (i64*)work;
  i64* bad = dir + D + 1;
  cudaMemsetAsync(bad, 0, sizeof(i64), st);
  if (n > 0)
    pair_key_dir_kernel<<<blocks(n), kThreads, 0, st>>>((const i64*)tk0, n,
                                                        shift, D, dir, bad);
  if (Q > 0)
    pair_key_search_kernel<<<blocks(Q), kThreads, 0, st>>>(
        (const i64*)tk0, (const i64*)tk1, n, dir, shift, D, (const i64*)qk0,
        (const i64*)qk1, Q, (bool*)found, bad);
  return (int)cudaGetLastError();
}
