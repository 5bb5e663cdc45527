// K14 shard_probe_planes, K15 owner_postings and K17 shard_probe_found:
// the owner side of the hash-range-sharded v2 index.
//
// K14 replaces pgrtk_tpu/parallel/mesh.py:312 _shard_probe_planes.  Each
// valid entry of a key-sorted shard table goes to bucket b = the top
// `bits` of k0's low 32 bits, at column c = its rank among the entries of
// its bucket in shard order, in (2^bits, 128) planes: k0, k1 (int64),
// sid, ori<<31|bgn, end and the entry's shard row (int32).  A bucket of
// more than 128 entries keeps its first 128 and raises the flag.  What
// bounds it on this card: device memory (the shard planes read once, the
// 2^bits * 128 slots written once).  The rank must be stable, or a key's
// postings stop being one contiguous run of its bucket row in (sid, bgn)
// order, which K15 and the chain tie-breaks rely on.  The JAX function
// sorted (bucket, entry) pairs with lax.sort and scattered with a
// searchsorted for the run starts.  Here:
//   1. one pass writes each entry's bucket key (2^bits for an invalid
//      entry) and its index;
//   2. K12's stable radix engine (adj.cu) sorts the index by the bucket
//      key: equal buckets keep shard order;
//   3. one pass marks each bucket's run [start, end) in the sorted order;
//   4. one pass over the 2^bits * 128 slots, a thread each, gathers the
//      entry at start + c when c < the run's length and writes the fills
//      (INT64_MAX keys, 0 postings, row -1) otherwise, so every slot is
//      written exactly once and none is left uninitialised.
//
// K15 replaces the owner block of pgrtk_tpu/parallel/mesh.py:764-887
// (inside sharded_query_v2_e2e_step).  For each received key (one warp
// each) it reads the key's 128-slot bucket row, 4 slots a lane, takes the
// hit mask by __ballot_sync, its count and first hit by __popc and
// __ffs, reads the run first + j straight into the postings_cap (Pp)
// slots, derives each slot's occurrence rank m and group size mult from
// the same-sid runs of the compacted slots (in shared memory), and writes
// the single-chip meta word keyovf(1) | mult(7) | m(4) | sid(20) with the
// bgnori and end words: (Q, 3*Pp) int32.  keyovf is count > Pp or a valid
// m > 15.  Padded route slots (INT64_MAX keys) never hit.  The TPU form
// compacted the run by a 7-step funnel-shift lane roll and propagated run
// bounds by log shifts; a warp reads the row directly.  What bounds it on
// this card: device memory (the received keys, each probed bucket row of
// keys, the postings of the hits, the output).
//
// K17 replaces the compare block of pgrtk_tpu/parallel/mesh.py:576-582
// (inside sharded_query_v2_step, the v2 probe-only fan-out): is each
// gathered query key in its bucket row of this rank's K14 planes?  The
// bucket is K14's, the top `bits` of k0's low word (not K11's top bits of
// the 56-bit hash).  One warp per key reads the 128-slot row, 4 slots a
// lane, with the same ballot as K15 (`row_hits`), and lane 0 writes the
// OR of the four masks.  An INT64_MAX key (a padded slot) never hits.
// What bounds it on this card: device memory (the keys, each probed
// bucket row of keys once, the flags).
#include "common.cuh"

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kW = 128;               // PROBE_W: one bucket row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr i64 kKeyFill = 0x7FFFFFFFFFFFFFFFLL;
constexpr unsigned kMetaEmpty = 0xFFFFFFFFu;

__global__ void bucket_key_kernel(const bool* __restrict__ valid,
                                  const i64* __restrict__ k0, i64 n, int bits,
                                  i64* __restrict__ key,
                                  i64* __restrict__ index) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u64 lo = (u64)k0[i] & 0xFFFFFFFFull;  // logical: no sign smear
  key[i] = valid[i] ? (i64)(lo >> (32 - bits)) : ((i64)1 << bits);
  index[i] = i;
}

__global__ void bucket_bounds_kernel(const i64* __restrict__ bkey, i64 n,
                                     i64 nb, i64* __restrict__ start,
                                     i64* __restrict__ end) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 b = bkey[i];
  if (b >= nb) return;
  if (i == 0 || bkey[i - 1] != b) start[b] = i;
  if (i == n - 1 || bkey[i + 1] != b) end[b] = i + 1;
}

struct Shard {
  const i64 *k0, *k1, *sid, *bgn, *end, *ori;
};

struct Planes {
  i64 *k0, *k1;
  int *sid, *bgnori, *end, *row;
};

__global__ void fill_planes_kernel(const i64* __restrict__ start,
                                   const i64* __restrict__ end,
                                   const i64* __restrict__ perm, i64 nb,
                                   Shard sh, Planes pl,
                                   int* __restrict__ overflow) {
  const i64 s = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nb * kW) return;
  const i64 b = s / kW;
  const int c = (int)(s % kW);
  const i64 st = start[b];
  const i64 cnt = end[b] - st;
  if (c == 0 && cnt > kW) *overflow = 1;
  if (c < cnt) {
    const i64 e = perm[st + c];
    pl.k0[s] = sh.k0[e];
    pl.k1[s] = sh.k1[e];
    pl.sid[s] = (int)(unsigned)sh.sid[e];
    pl.bgnori[s] = (int)(((unsigned)sh.ori[e] << 31) | (unsigned)sh.bgn[e]);
    pl.end[s] = (int)(unsigned)sh.end[e];
    pl.row[s] = (int)e;
  } else {
    pl.k0[s] = kKeyFill;
    pl.k1[s] = kKeyFill;
    pl.sid[s] = 0;
    pl.bgnori[s] = 0;
    pl.end[s] = 0;
    pl.row[s] = -1;
  }
}

// The 128-slot row compare of K15 and K17: bit s of mask[t] is set when
// slot 32 t + s of the row at `row` holds (k0, k1) and the key is live.
// Every lane of the warp must call it.
__device__ __forceinline__ void row_hits(const i64* __restrict__ pk0,
                                         const i64* __restrict__ pk1, i64 row,
                                         i64 k0, i64 k1, bool live, int lane,
                                         unsigned mask[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const i64 p = row + 32 * t + lane;
    mask[t] = __ballot_sync(0xffffffffu, live && pk0[p] == k0 && pk1[p] == k1);
  }
}

__device__ __forceinline__ i64 row_of(i64 k0, int bits) {
  return (i64)(((u64)k0 & 0xFFFFFFFFull) >> (32 - bits)) * kW;
}

__global__ void owner_postings_kernel(const i64* __restrict__ qk0,
                                      const i64* __restrict__ qk1, i64 Q,
                                      int bits, const i64* __restrict__ pk0,
                                      const i64* __restrict__ pk1,
                                      const int* __restrict__ psid,
                                      const int* __restrict__ pbgnori,
                                      const int* __restrict__ pend, int Pp,
                                      int* __restrict__ out) {
  __shared__ unsigned sid_s[kWarps][kW];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const i64 q = ((i64)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (q >= Q) return;  // whole warps leave together
  const i64 k0 = qk0[q];
  const i64 k1 = qk1[q];
  const bool live = k0 != kKeyFill;  // padded route slots never hit
  const i64 row = live ? row_of(k0, bits) : 0;
  unsigned mask[4];
  row_hits(pk0, pk1, row, k0, k1, live, lane, mask);
  int count = 0;
  for (int t = 0; t < 4; ++t) count += __popc(mask[t]);
  int first = kW;
  for (int t = 3; t >= 0; --t)
    if (mask[t]) first = 32 * t + __ffs(mask[t]) - 1;
  const int nv = min(count, Pp);
  int* o = out + q * 3 * Pp;
  // slot j <- row position first + j (masked to 0 where not a hit)
  for (int t = 0; t < 4; ++t) {
    const int j = lane + 32 * t;
    if (j >= Pp) break;
    const int p = first + j;
    const bool h = p < kW && ((mask[p >> 5] >> (p & 31)) & 1u);
    sid_s[w][j] = h ? (unsigned)psid[row + p] : 0u;
    o[Pp + j] = h ? pbgnori[row + p] : 0;
    o[2 * Pp + j] = h ? pend[row + p] : 0;
  }
  __syncwarp();
  // m and mult from the same-sid run around each valid slot
  unsigned meta[4];
  bool m_ovf = false;
  for (int t = 0; t < 4; ++t) {
    const int j = lane + 32 * t;
    meta[t] = kMetaEmpty;
    if (j >= nv) continue;
    const unsigned s = sid_s[w][j];
    int a = j, e = j;
    while (a > 0 && sid_s[w][a - 1] == s) --a;
    while (e + 1 < nv && sid_s[w][e + 1] == s) ++e;
    const unsigned m = (unsigned)(j - a);
    const unsigned mult = (unsigned)(e - a + 1);
    m_ovf |= m > 15u;
    meta[t] = (min(mult, 127u) << 24) | (min(m, 15u) << 20) | s;
  }
  const bool keyovf = __any_sync(full, m_ovf) || count > Pp;
  for (int t = 0; t < 4; ++t) {
    const int j = lane + 32 * t;
    if (j >= Pp) break;
    o[j] = (int)(j < nv && keyovf ? meta[t] | 0x80000000u : meta[t]);
  }
}

__global__ void shard_probe_found_kernel(const i64* __restrict__ qk0,
                                         const i64* __restrict__ qk1, i64 Q,
                                         int bits, const i64* __restrict__ pk0,
                                         const i64* __restrict__ pk1,
                                         bool* __restrict__ found) {
  const int lane = threadIdx.x & 31;
  const i64 q = ((i64)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (q >= Q) return;  // whole warps leave together
  const i64 k0 = qk0[q];
  const i64 k1 = qk1[q];
  const bool live = k0 != kKeyFill;
  unsigned mask[4];
  row_hits(pk0, pk1, live ? row_of(k0, bits) : 0, k0, k1, live, lane, mask);
  if (lane == 0) found[q] = (mask[0] | mask[1] | mask[2] | mask[3]) != 0u;
}

int blocks(i64 n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

// K14.  Shard planes valid (bool), k0, k1, sid, bgn, end, ori (int64),
// n entries, key-sorted; bits in [1, 31].  scratch: 4n + 2 * 2^bits
// int64; radix_scratch: pgrtk_radix_scratch_bytes(n) bytes; wide: one
// device int64 for K12's width flag (the bucket keys always fit).  Writes
// the (2^bits, 128) planes and *overflow (int).
extern "C" int pgrtk_shard_probe_planes(
    const void* valid, const void* k0, const void* k1, const void* sid,
    const void* bgn, const void* end, const void* ori, long long n, int bits,
    void* scratch, void* radix_scratch, void* wide, void* pk0, void* pk1,
    void* psid, void* pbgnori, void* pend, void* prow, void* overflow,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || bits < 1 || bits > 31) return (int)cudaErrorInvalidValue;
  const i64 nb = (i64)1 << bits;
  i64* key = (i64*)scratch;
  i64* index = key + n;
  i64* bkey = index + n;
  i64* perm = bkey + n;
  i64* bstart = perm + n;
  i64* bend = bstart + nb;
  cudaMemsetAsync(bstart, 0, 2 * nb * sizeof(i64), st);
  cudaMemsetAsync(overflow, 0, sizeof(int), st);
  if (n > 0) {
    bucket_key_kernel<<<blocks(n), kThreads, 0, st>>>(
        (const bool*)valid, (const i64*)k0, n, bits, key, index);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const void* keys[1] = {key};
    const int kbits[1] = {bits + 1};
    const void* in[2] = {key, index};
    void* outs[2] = {bkey, perm};
    const int rc = pgrtk::radix_engine(keys, kbits, 1, n, in, outs, 2,
                                       nullptr, nullptr, nullptr,
                                       radix_scratch, wide, stream);
    if (rc != 0) return rc;
    bucket_bounds_kernel<<<blocks(n), kThreads, 0, st>>>(bkey, n, nb, bstart,
                                                         bend);
  }
  Shard sh{(const i64*)k0, (const i64*)k1, (const i64*)sid, (const i64*)bgn,
           (const i64*)end, (const i64*)ori};
  Planes pl{(i64*)pk0, (i64*)pk1, (int*)psid, (int*)pbgnori, (int*)pend,
            (int*)prow};
  fill_planes_kernel<<<blocks(nb * kW), kThreads, 0, st>>>(
      bstart, bend, perm, nb, sh, pl, (int*)overflow);
  return (int)cudaGetLastError();
}

// K15.  Received keys qk0, qk1 (int64, Q of them; INT64_MAX = padded
// slot), the probe planes of K14 (2^bits rows of 128), Pp in [1, 127].
// Writes out (Q, 3*Pp) int32: meta | bgnori | end.
extern "C" int pgrtk_owner_postings(const void* qk0, const void* qk1,
                                    long long Q, int bits, const void* pk0,
                                    const void* pk1, const void* psid,
                                    const void* pbgnori, const void* pend,
                                    int Pp, void* out, void* stream) {
  if (Q < 0 || bits < 1 || bits > 31 || Pp < 1 || Pp > 127)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const i64 grid = (Q + kWarps - 1) / kWarps;
  owner_postings_kernel<<<(unsigned)grid, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const i64*)qk0, (const i64*)qk1, Q, bits, (const i64*)pk0,
      (const i64*)pk1, (const int*)psid, (const int*)pbgnori,
      (const int*)pend, Pp, (int*)out);
  return (int)cudaGetLastError();
}

// K17.  Query keys qk0, qk1 (int64, Q of them; INT64_MAX = padded slot),
// the key planes of K14 (2^bits rows of 128).  Writes found (Q,) bool.
extern "C" int pgrtk_shard_probe_found(const void* qk0, const void* qk1,
                                       long long Q, int bits, const void* pk0,
                                       const void* pk1, void* found,
                                       void* stream) {
  if (Q < 0 || bits < 1 || bits > 31) return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const i64 grid = (Q + kWarps - 1) / kWarps;
  shard_probe_found_kernel<<<(unsigned)grid, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const i64*)qk0, (const i64*)qk1, Q, bits, (const i64*)pk0,
      (const i64*)pk1, (bool*)found);
  return (int)cudaGetLastError();
}
