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
// (inside sharded_query_v2_e2e_step): for each received key, the first
// postings_cap (Pp) slots of its postings run in its bucket row, with
// each slot's occurrence rank m in its same-sid run and the run's size
// mult in the single-chip meta word keyovf(1) | mult(7) | m(4) | sid(20),
// beside the bgnori and end words: (Q, 3*Pp) int32.  keyovf is count > Pp
// or a valid m > 15.  Padded route slots (INT64_MAX keys) never hit.  The
// TPU form compared the whole row, compacted the run by a 7-step lane
// roll and propagated run bounds by log shifts.  What bounds it on this
// card: device memory, and most of its bytes are the output (at 10c's
// Pp = 32, 384 bytes a key); the rows it reads hold ~64 entries of 128
// and stay in L2, so a whole row (2 KB of k0 and k1) a key is mostly
// fills, and a key's run needs only its lower bound and the slots after
// it.  So a group of 8 lanes takes a key: it finds
// the lower bound of the key in its sorted row in two rounds of loads
// (the 8 chunk ends, then the 16 slots of one chunk), reads the postings
// of the run's first <= Pp slots only, takes the same-sid runs from
// ballots, and the warp's 4 rows, contiguous in the output, are written
// from shared memory in 16-byte stores.  The precondition is K14's
// layout, as for K17: each row key-sorted, entries before fills (the
// plain version compares the whole row).
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

__device__ __forceinline__ i64 row_of(i64 k0, int bits) {
  return (i64)(((u64)k0 & 0xFFFFFFFFull) >> (32 - bits)) * kW;
}

// K15's layout: lanes a key (kWarpKeys keys a warp), and the chunks its
// first round cuts a row into
constexpr int kOwnerGroup = 8;
constexpr int kChunk = kW / kOwnerGroup;  // 16 slots
constexpr int kWarpKeys = 32 / kOwnerGroup;
constexpr unsigned kOwnerMine = (1u << kOwnerGroup) - 1u;

__device__ __forceinline__ bool key_below(i64 a0, i64 a1, i64 b0, i64 b1) {
  return a0 < b0 || (a0 == b0 && a1 < b1);
}

// The highest set bit at or below j (0 when there is none) and the lowest
// above j (`none` when there is none) of a 128-bit mask in four words
// (constant indices only, so the words stay in registers).
__device__ __forceinline__ int set_at_or_below(const unsigned (&b)[4],
                                               int j) {
  int r = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int d = j - 32 * w;  // bits 0..d of word w
    const unsigned x =
        d < 0 ? 0u : (d >= 31 ? b[w] : b[w] & ((2u << d) - 1u));
    if (x) r = 32 * w + 31 - __clz(x);
  }
  return r;
}

__device__ __forceinline__ int set_above(const unsigned (&b)[4], int j,
                                         int none) {
  int r = none;
#pragma unroll
  for (int w = 3; w >= 0; --w) {
    const int d = j - 32 * w;  // bits d + 1..31 of word w
    const unsigned x = d < 0 ? b[w] : (d >= 31 ? 0u : b[w] & ~((2u << d) - 1u));
    if (x) r = 32 * w + __ffs(x) - 1;
  }
  return r;
}

// One group of kOwnerGroup lanes a received key.  Its row is key-sorted,
// entries before INT64_MAX fills (K14's layout), so the key's postings
// are the run [lb, lb + count) at its lower bound lb.  Round 1: lane l
// reads the last slot of chunk l (16 slots), and the ballot's count c of
// those below the key gives the chunk holding lb; round 2: the lanes read
// that chunk's 16 slots (2 a lane) and count the slots below the key
// (lb) and equal to it; while a chunk's last slot holds the key, the run
// goes on into the next chunk.  Then the run's first nv = min(count, Pp)
// slots' sid, bgnori and end are read (nothing for a miss or a padded
// route slot), a slot starts a same-sid run when its sid differs from
// the slot before (a shuffle, and the group's last lane's sid carried to
// the next 8 slots), the starts' ballots make a 128-bit mask, and each
// slot's m and mult are its distance from the start at or below it and
// the length from that start to the next (or nv).  The warp's 4 rows,
// contiguous in the (Q, 3Pp) output, are staged in shared memory and
// written in 16-byte stores.
__global__ void __launch_bounds__(kThreads)
    owner_postings_kernel(const i64* __restrict__ qk0,
                          const i64* __restrict__ qk1, i64 Q, int bits,
                          const i64* __restrict__ pk0,
                          const i64* __restrict__ pk1,
                          const int* __restrict__ psid,
                          const int* __restrict__ pbgnori,
                          const int* __restrict__ pend, int Pp,
                          int* __restrict__ out) {
  extern __shared__ int stage[];  // a warp's kWarpKeys rows of 3 Pp
  constexpr int G = kOwnerGroup;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int sub = lane & (G - 1);
  const int gshift = lane & ~(G - 1);
  const int R = 3 * Pp;
  const i64 q0 = ((i64)blockIdx.x * kWarps + w) * kWarpKeys;
  if (q0 >= Q) return;  // whole warps leave together
  const i64 q = q0 + lane / G;
  int* st = stage + (w * kWarpKeys + lane / G) * R;  // this key's row
  i64 k0 = kKeyFill, k1 = kKeyFill;
  if (q < Q) {
    k0 = qk0[q];
    k1 = qk1[q];
  }
  const bool live = k0 != kKeyFill;  // a padded route slot reads nothing
  const i64 row = live ? row_of(k0, bits) : 0;
  bool lt = false;
  if (live) {
    const i64 p = row + kChunk * sub + kChunk - 1;
    lt = key_below(pk0[p], pk1[p], k0, k1);
  }
  const int c = __popc((__ballot_sync(full, lt) >> gshift) & kOwnerMine);
  int lb = kW, count = 0, chunk = c;
  bool more = live && c < G, first = true;
  while (__any_sync(full, more)) {
    int nb = 0, ne = 0;
    bool last = false;  // the chunk's last slot holds the key
    if (more) {
#pragma unroll
      for (int u = 0; u < kChunk / G; ++u) {
        const int s = chunk * kChunk + sub + G * u;
        const i64 a0 = pk0[row + s], a1 = pk1[row + s];
        const bool e = a0 == k0 && a1 == k1;
        nb += key_below(a0, a1, k0, k1);
        ne += e;
        last |= e && sub + G * u == kChunk - 1;
      }
    }
#pragma unroll
    for (int d = G / 2; d > 0; d >>= 1) {
      nb += __shfl_xor_sync(full, nb, d);
      ne += __shfl_xor_sync(full, ne, d);
    }
    last = ((__ballot_sync(full, last) >> gshift) & kOwnerMine) != 0u;
    if (more) {
      if (first) lb = chunk * kChunk + nb;
      count += ne;
      more = last && ++chunk < G;
    }
    first = false;
  }
  const int nv = min(count, Pp);
  const int T = (__reduce_max_sync(full, nv) + G - 1) / G;
  unsigned starts[4] = {0u, 0u, 0u, 0u};
  unsigned carry = 0u;  // the sid of the slot before this step's first
#pragma unroll
  for (int t = 0; t < kW / G; ++t) {
    if (t >= T) break;  // uniform across the warp
    const int j = sub + G * t;
    unsigned s = 0u;
    if (j < nv) {
      const i64 p = row + lb + j;
      s = (unsigned)psid[p];
      st[j] = (int)s;  // the sid, until the meta word takes its place
      st[Pp + j] = pbgnori[p];
      st[2 * Pp + j] = pend[p];
    }
    unsigned before = __shfl_up_sync(full, s, 1, G);
    if (sub == 0) before = carry;
    carry = __shfl_sync(full, s, G - 1, G);
    const bool start = j < nv && (j == 0 || s != before);
    starts[(G * t) >> 5] |= ((__ballot_sync(full, start) >> gshift) &
                             kOwnerMine) << ((G * t) & 31);
  }
  // keyovf: more than Pp postings, or a valid m above 15
  bool m_ovf = false;
  for (int j = sub; j < nv; j += G)
    m_ovf |= j - set_at_or_below(starts, j) > 15;
  // every lane votes: a vote behind `count > Pp ||` hangs the warp
  const unsigned m_any =
      (__ballot_sync(full, m_ovf) >> gshift) & kOwnerMine;
  const bool keyovf = count > Pp || m_any != 0u;
  for (int j = sub; j < Pp; j += G) {
    if (j < nv) {
      const int a = set_at_or_below(starts, j);
      const unsigned m = (unsigned)(j - a);
      const unsigned mult = (unsigned)(set_above(starts, j, nv) - a);
      const unsigned meta = (min(mult, 127u) << 24) | (min(m, 15u) << 20) |
                            (unsigned)st[j];
      st[j] = (int)(keyovf ? meta | 0x80000000u : meta);
    } else {
      st[j] = (int)kMetaEmpty;
      st[Pp + j] = 0;
      st[2 * Pp + j] = 0;
    }
  }
  __syncwarp();
  // the warp's rows, 16 R bytes from a 16-byte boundary (out is 16-byte
  // aligned): 16-byte stores, and single words after the last (the last
  // warp's rows at an odd R)
  const int n_int = (int)min((i64)kWarpKeys, Q - q0) * R;
  int* dst = out + q0 * R;
  const int* src = stage + w * kWarpKeys * R;
  const int body = n_int >> 2;
  for (int v = lane; v < body; v += 32) {
    const int* s = src + 4 * v;
    *(int4*)(dst + 4 * v) = make_int4(s[0], s[1], s[2], s[3]);
  }
  for (int i = 4 * body + lane; i < n_int; i += 32) dst[i] = src[i];
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
// slot), the probe planes of K14 (2^bits rows of 128, each row key-sorted,
// entries before fills), Pp in [1, 127].
// Writes out (Q, 3*Pp) int32, 16-byte aligned: meta | bgnori | end.
extern "C" int pgrtk_owner_postings(const void* qk0, const void* qk1,
                                    long long Q, int bits, const void* pk0,
                                    const void* pk1, const void* psid,
                                    const void* pbgnori, const void* pend,
                                    int Pp, void* out, void* stream) {
  if (Q < 0 || bits < 1 || bits > 31 || Pp < 1 || Pp > 127 ||
      (unsigned long long)out % 16)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const i64 keys = kWarps * kWarpKeys;  // a block's
  const i64 grid = (Q + keys - 1) / keys;
  const size_t smem = (size_t)keys * 3 * Pp * sizeof(int);  // <= 48,768
  owner_postings_kernel<<<(unsigned)grid, kThreads, smem,
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
