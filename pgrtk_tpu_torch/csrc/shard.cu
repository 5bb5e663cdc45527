// K14 shard_probe_planes, K15 owner_postings and K17 shard_probe_found:
// the owner side of the hash-range-sharded v2 index.
//
// K14 replaces pgrtk_tpu/parallel/mesh.py:312 _shard_probe_planes.  Each
// valid entry of a key-sorted shard table goes to bucket b = the top
// `bits` of k0's low 32 bits, at column c = its rank among the valid
// entries of its bucket in shard order, in (2^bits, 128) planes: k0, k1
// (int64), sid, ori<<31|bgn, end and the entry's shard row (int32).  A
// bucket of more than 128 entries keeps its first 128 and raises the flag.
// The rank must be stable, or a key's postings stop being one contiguous
// run of its bucket row in (sid, bgn) order, which K15 and the chain
// tie-breaks rely on.  The JAX function sorted (bucket, entry) pairs with
// lax.sort and scattered with a searchsorted for the run starts.  What
// bounds it on this card: device memory, and almost all of it is the
// output (the 2^bits * 128 slots written once; at ~5 entries a bucket
// over 95% of them are fills), so nothing is sorted across the shard:
//   1. one memset zeroes the bucket counts and the flag;
//   2. one pass takes, for each valid entry, a place in its bucket by an
//      atomic on the bucket's count and, when that place is below 128,
//      stages the entry's index in the row plane at that slot (the order
//      the atomics chose is arbitrary);
//   3. one warp a bucket row reads its count and its staged indices,
//      ranks them (they are unique, so their rank is the shard order), and
//      writes the whole 128-slot row of every plane, entries gathered and
//      fills (INT64_MAX keys, 0 postings, row -1) alike, in 16-byte
//      streaming stores of which each warp instruction writes 512
//      contiguous bytes.  A bucket of more than 128 entries (rare: the
//      lambda retry of the v2 step reacts to it) did not stage them all;
//      its warp scans the shard from the start for its bucket's entries,
//      32 a step, until it holds the first 128.
// At 10b's shapes the stores alone run near a fill's rate; the gathers'
// dependent loads (count, staged index, six random fields) add ~0.04 ms
// (PERF.md).
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
// gathered query key in its bucket row of this rank's K14 planes, and is
// its pair valid?  The bucket is K14's, the top `bits` of k0's low word
// (not K11's top bits of the 56-bit hash).  What bounds it on this card:
// device memory, and the bytes it needs are few: each key's valid flag,
// the two words of a valid key, and the occupied prefix of its bucket row
// (K14 writes a row's entries first and INT64_MAX fills after them; at
// 10b's shapes a row holds ~5 entries of 128), and what holds a kernel
// back at these bytes is its chain of dependent loads and how many keys
// are in flight (on an H100 at 10b's shapes, 8 lanes a key reading k1
// only where k0 matched took ~0.1 ms; PERF.md has the layouts tried).  So
// a pair of lanes takes a key (16 keys a warp): it reads the key's flag
// and then, only for a valid key, its words, in place at the caller's
// strides (the step's gathered (Q, 3) rows, no copy); then from slot 0 it
// reads 8 slots of the k0 and k1 rows a step (64 contiguous bytes of
// each, 32 a lane, in one round of loads) and stops at the step that
// holds the row's first fill or the key.  A full row of 128 has no fill
// and takes 16 steps.  The found flag is written AND-ed with the valid
// flag.  An INT64_MAX key (a padded slot) never hits.  The precondition
// is K14's layout: in each row, entries before fills (the plain version
// compares the whole row).
#include "common.cuh"

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kW = 128;               // PROBE_W: one bucket row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr i64 kKeyFill = 0x7FFFFFFFFFFFFFFFLL;
constexpr unsigned kMetaEmpty = 0xFFFFFFFFu;

__device__ __forceinline__ i64 bucket_of(i64 k0, int bits) {
  return (i64)(((u64)k0 & 0xFFFFFFFFull) >> (32 - bits));  // logical
}

// Step 2: each valid entry's place in its bucket; the first 128 of each
// bucket stage their index in the row plane.
__global__ void bucket_place_kernel(const bool* __restrict__ valid,
                                    const i64* __restrict__ k0, i64 n,
                                    int bits, int* __restrict__ count,
                                    int* __restrict__ prow) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const i64 b = bucket_of(k0[i], bits);
  const int r = atomicAdd(count + b, 1);
  if (r < kW) prow[b * kW + r] = (int)i;
}

struct Shard {
  const bool* valid;
  const i64 *k0, *k1, *sid, *bgn, *end, *ori;
};

struct Planes {
  i64 *k0, *k1;
  int *sid, *bgnori, *end, *row;
};

// Step 3: one warp a bucket row.  idx_s holds the row's entries in any
// order, then row_s in shard order.
__global__ void __launch_bounds__(kThreads)
    fill_rows_kernel(const int* __restrict__ count, i64 nb, i64 n, int bits,
                     Shard sh, Planes pl, int* __restrict__ overflow) {
  __shared__ int idx_s[kWarps][kW];
  __shared__ int row_s[kWarps][kW];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const i64 b = (i64)blockIdx.x * kWarps + w;
  if (b >= nb) return;  // whole warps leave together
  const int c = count[b];
  int kept = c < kW ? c : kW;
  if (c <= kW) {
    for (int j = lane; j < c; j += 32) idx_s[w][j] = pl.row[b * kW + j];
    __syncwarp();
    for (int j = lane; j < c; j += 32) {  // rank = entries of lower index
      const int v = idx_s[w][j];
      int r = 0;
      for (int k = 0; k < c; ++k) r += idx_s[w][k] < v;
      row_s[w][r] = v;
    }
  } else {  // overflow: the bucket's first 128 entries in shard order
    if (lane == 0) *overflow = 1;
    kept = 0;
    for (i64 base = 0; base < n && kept < kW; base += 32) {
      const i64 i = base + lane;
      const bool hit = i < n && sh.valid[i] && bucket_of(sh.k0[i], bits) == b;
      const unsigned m = __ballot_sync(full, hit);
      const int at = kept + __popc(m & ((1u << lane) - 1u));
      if (hit && at < kW) row_s[w][at] = (int)i;
      kept += __popc(m);
    }
    kept = kW;
  }
  __syncwarp();
  // Each store of the warp writes 512 contiguous bytes, so every 32-byte
  // sector is written whole by one instruction (a sector written in two
  // halves by two stores ran the writer at 2.4 TB/s, not 3.2).  Lane l
  // writes the key planes' slots 2l, 2l + 1, 64 + 2l, 65 + 2l and the
  // int32 planes' slots 4l to 4l + 3.
  i64 k0[4], k1[4];
  int sid[4], bgnori[4], end[4], row[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = (t < 2 ? 2 * lane : 62 + 2 * lane) + t;
    const int e = j < kept ? row_s[w][j] : -1;
    k0[t] = e >= 0 ? sh.k0[e] : kKeyFill;
    k1[t] = e >= 0 ? sh.k1[e] : kKeyFill;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = 4 * lane + t;
    const int e = j < kept ? row_s[w][j] : -1;
    sid[t] = e >= 0 ? (int)(unsigned)sh.sid[e] : 0;
    bgnori[t] =
        e >= 0 ? (int)(((unsigned)sh.ori[e] << 31) | (unsigned)sh.bgn[e]) : 0;
    end[t] = e >= 0 ? (int)(unsigned)sh.end[e] : 0;
    row[t] = e;
  }
  const i64 r = b * kW;
  __stcs((longlong2*)(pl.k0 + r + 2 * lane), make_longlong2(k0[0], k0[1]));
  __stcs((longlong2*)(pl.k0 + r + 64 + 2 * lane),
         make_longlong2(k0[2], k0[3]));
  __stcs((longlong2*)(pl.k1 + r + 2 * lane), make_longlong2(k1[0], k1[1]));
  __stcs((longlong2*)(pl.k1 + r + 64 + 2 * lane),
         make_longlong2(k1[2], k1[3]));
  const i64 s = r + 4 * lane;
  __stcs((int4*)(pl.sid + s), make_int4(sid[0], sid[1], sid[2], sid[3]));
  __stcs((int4*)(pl.bgnori + s),
         make_int4(bgnori[0], bgnori[1], bgnori[2], bgnori[3]));
  __stcs((int4*)(pl.end + s), make_int4(end[0], end[1], end[2], end[3]));
  __stcs((int4*)(pl.row + s), make_int4(row[0], row[1], row[2], row[3]));
}

// K15's 128-slot row compare: bit s of mask[t] is set when
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

// K17's layout, set for its measured best (PERF.md): lanes a key, and
// 16-byte loads a lane, step and plane
constexpr int kGroup = 2;
constexpr int kPer = 2;
constexpr int kStep = 2 * kPer * kGroup;  // slots a step: 8, 64 bytes

__global__ void __launch_bounds__(kThreads)
    shard_probe_found_kernel(const i64* __restrict__ qk0, i64 s0,
                             const i64* __restrict__ qk1, i64 s1,
                             const i64* __restrict__ qvalid, i64 sv, i64 Q,
                             int bits, const i64* __restrict__ pk0,
                             const i64* __restrict__ pk1,
                             bool* __restrict__ found) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kGroup - 1);
  const unsigned mine = (0xffffffffu >> (32 - kGroup))
                        << (lane & ~(kGroup - 1));  // my group's lanes
  const i64 t = (i64)blockIdx.x * kThreads + threadIdx.x;
  if ((t & ~31LL) / kGroup >= Q) return;  // whole warps leave together
  const i64 q = t / kGroup;
  // every lane of the warp stays for the votes below; a lane past Q or
  // of an invalid or padded key reads no row
  bool live = q < Q && (qvalid == nullptr || qvalid[q * sv] != 0);
  i64 k0 = 0, k1 = 0;
  if (live) {
    k0 = qk0[q * s0];
    k1 = qk1[q * s1];
    live = k0 != kKeyFill;
  }
  const i64 row = live ? row_of(k0, bits) : 0;
  bool more = live, hit = false;
  for (int base = 0; base < kW; base += kStep) {
    bool match = false, fill = false;
    if (more) {
      const i64 p = row + base + 2 * kPer * sub;
      longlong2 v[kPer], w[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        v[j] = __ldg((const longlong2*)(pk0 + p) + j);
        w[j] = __ldg((const longlong2*)(pk1 + p) + j);
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        fill |= v[j].x == kKeyFill || v[j].y == kKeyFill;
        match |= (v[j].x == k0 && w[j].x == k1) ||
                 (v[j].y == k0 && w[j].y == k1);
      }
    }
    const unsigned h = __ballot_sync(full, match);
    const unsigned f = __ballot_sync(full, fill);
    hit |= (h & mine) != 0u;
    more = more && !hit && (f & mine) == 0u;
    if (!__any_sync(full, more)) break;
  }
  if (q < Q && sub == 0) found[q] = hit;
}

int blocks(i64 n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

// K14.  Shard planes valid (bool), k0, k1, sid, bgn, end, ori (int64),
// n entries, key-sorted; bits in [1, 31]; the planes (2^bits rows of 128)
// 16-byte aligned.  work: 2^bits + 1 int32, the bucket counts and then
// the overflow flag.  Writes the planes and the flag.
extern "C" int pgrtk_shard_probe_planes(
    const void* valid, const void* k0, const void* k1, const void* sid,
    const void* bgn, const void* end, const void* ori, long long n, int bits,
    void* work, void* pk0, void* pk1, void* psid, void* pbgnori, void* pend,
    void* prow, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || n > 0x7FFFFFFFLL || bits < 1 || bits > 31)
    return (int)cudaErrorInvalidValue;
  const i64 nb = (i64)1 << bits;
  int* count = (int*)work;
  cudaMemsetAsync(count, 0, (nb + 1) * sizeof(int), st);
  if (n > 0)
    bucket_place_kernel<<<blocks(n), kThreads, 0, st>>>(
        (const bool*)valid, (const i64*)k0, n, bits, count, (int*)prow);
  Shard sh{(const bool*)valid, (const i64*)k0, (const i64*)k1,
           (const i64*)sid, (const i64*)bgn, (const i64*)end,
           (const i64*)ori};
  Planes pl{(i64*)pk0, (i64*)pk1, (int*)psid, (int*)pbgnori, (int*)pend,
            (int*)prow};
  fill_rows_kernel<<<(unsigned)((nb + kWarps - 1) / kWarps), kThreads, 0,
                     st>>>(count, nb, n, bits, sh, pl, count + nb);
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

// K17.  Query keys qk0, qk1 (int64, Q of them, element strides s0 and
// s1; INT64_MAX = padded slot) and, unless qvalid is null, their valid
// flags (int64, stride sv; 0 = not a valid pair); the key planes of K14
// (2^bits rows of 128, entries before fills in each row, 16-byte
// aligned).  Writes found (Q,) bool: found in its row and valid.
extern "C" int pgrtk_shard_probe_found(const void* qk0, long long s0,
                                       const void* qk1, long long s1,
                                       const void* qvalid, long long sv,
                                       long long Q, int bits, const void* pk0,
                                       const void* pk1, void* found,
                                       void* stream) {
  if (Q < 0 || bits < 1 || bits > 31) return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const i64 keys = kThreads / kGroup;  // a block's
  const i64 grid = (Q + keys - 1) / keys;
  shard_probe_found_kernel<<<(unsigned)grid, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const i64*)qk0, s0, (const i64*)qk1, s1, (const i64*)qvalid, sv, Q,
      bits, (const i64*)pk0, (const i64*)pk1, (bool*)found);
  return (int)cudaGetLastError();
}
