// K16 pair_key_search: membership of pair keys in the replicated v1 table.
//
// Replaces pgrtk_tpu/parallel/mesh.py:259 _searchsorted_pairkey, the lookup
// of sharded_query_count_step (:169).  Each (k0, k1) int64 query key is
// looked up in the (N,) table sorted on (k0, k1): a lower_bound over the
// whole table, then an equality test.  The table is the v1 table as it
// stands, invalid tail included: its keys are INT64_MAX, which no 56-bit
// hash equals, and both keys of every entry are either a hash in
// [0, 2^56) or that fill, so comparing them as signed int64 orders them
// as the JAX package's (hi, lo) u32 planes do.  Each thread checks that
// of its query key and of every table key it compares, and sets `bad`
// otherwise (the wrapper raises): no pass over the whole table.
//
// The TPU form ran ceil(log2(N + 1)) rounds of a vectorised binary search
// over four u32 planes, one gather per plane and round.  Here one thread
// per key walks its own search.  What bounds it on this card: dependent
// loads, ~log2(N) of them per key, mostly from L2 (the top levels of the
// search are shared by every key); by the bytes and operations the work
// needs, the query keys read once and the found flags written once.
#include "common.cuh"

namespace {

typedef long long i64;

constexpr int kThreads = 256;
constexpr i64 kHashLimit = 1LL << 56;
constexpr i64 kFill = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ bool bad_key(i64 t) {
  return t < 0 || (t >= kHashLimit && t != kFill);
}

__global__ void pair_key_search_kernel(const i64* __restrict__ tk0,
                                       const i64* __restrict__ tk1, i64 n,
                                       const i64* __restrict__ qk0,
                                       const i64* __restrict__ qk1, i64 Q,
                                       bool* __restrict__ found,
                                       int* __restrict__ bad) {
  const i64 q = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const i64 a = qk0[q];
  const i64 b = qk1[q];
  bool odd = a < 0 || a >= kHashLimit || b < 0 || b >= kHashLimit;
  i64 lo = 0, hi = n;  // the first entry not less than (a, b)
  while (lo < hi) {
    const i64 mid = lo + ((hi - lo) >> 1);
    const i64 t0 = tk0[mid];
    odd |= bad_key(t0);
    bool less = t0 < a;
    if (t0 == a) {
      const i64 t1 = tk1[mid];
      odd |= bad_key(t1);
      less = t1 < b;
    }
    if (less)
      lo = mid + 1;
    else
      hi = mid;
  }
  bool f = false;
  if (lo < n) {
    const i64 t0 = tk0[lo], t1 = tk1[lo];
    odd |= bad_key(t0) || bad_key(t1);
    f = t0 == a && t1 == b;
  }
  found[q] = f;
  if (odd) *bad = 1;
}

}  // namespace

// K16.  Table keys tk0, tk1 (int64, n entries, sorted on (k0, k1)), query
// keys qk0, qk1 (int64, Q of them).  Writes found (Q,) bool, and sets
// *bad (int32, zeroed by the caller) when a key it compared is neither a
// 56-bit hash nor, in the table, the INT64_MAX fill.
extern "C" int pgrtk_pair_key_search(const void* tk0, const void* tk1,
                                     long long n, const void* qk0,
                                     const void* qk1, long long Q,
                                     void* found, void* bad, void* stream) {
  if (n < 0 || Q < 0) return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const i64 grid = (Q + kThreads - 1) / kThreads;
  pair_key_search_kernel<<<(unsigned)grid, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const i64*)tk0, (const i64*)tk1, n, (const i64*)qk0, (const i64*)qk1,
      Q, (bool*)found, (int*)bad);
  return (int)cudaGetLastError();
}
