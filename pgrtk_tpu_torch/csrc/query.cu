// K6 dup_pair_counts and K7 expand_postings: the per-query count filters
// and the chain-lane placement of the end-to-end query step.
//
// K6 replaces pgrtk_tpu/ops/query_e2e.py:365 dup_pair_counts, and with
// its step entry the count filter of the JAX step (:623-627); K7
// replaces pgrtk_tpu/ops/query_e2e.py:430 expand_postings.
//
// K6.  What bounds it on this card: compares, and at the query step's
// size its launch.  A row of Pc pair slots costs Pc^2 16-byte key
// compares (Pc = 192 at the bench step, a few thousand for long rows with
// blocked pair compaction), all from shared memory.  The JAX function
// sorted each row by key with lax.sort, found run lengths with log-shift
// segment propagation and sorted back; here a block takes one row (or a
// chunk of a long row) with a thread a slot, blockDim the row's width
// rounded up to a warp (192 threads at Pc = 192, none idle), up to 512.
// The row's masked keys are staged in shared memory once (in tiles of
// 1,024 for longer rows) as 16-byte words that every thread reads in the
// same order, so each read is one broadcast, and each thread counts the
// keys equal to its own.  No sort, no second pass; Pc is not capped.
// Invalid slots carry the all-ones key, so they count the row's invalid
// slots, as the JAX all-ones segment does.  The step entry also applies
// the in-query count filter: base_hit = valid & found & (run_len <= c),
// and the filtered count takes one atomic a block (__syncthreads_count)
// onto the counter K5's step entry zeroed, so the step has no glue
// launches around it.
//
// K7.  What bounds it on this card: device memory, and the launches around
// it. Its output is the (B*C, Pc*M) chain lanes, most of them empty (N =
// Pc*M = 576 lanes for each of the 1,024 (query, target) groups at the bench
// step, ~27% of them hit), and K8 reads them as (G, N, 6) int64 anchors:
// 28.3 MB written against at most 9.4 MB of postings read.  The JAX function
// built a (B, Pc, P, C*M) one-hot and summed over P, and the JAX step then
// broadcast the query fields over the lanes and stacked the anchors, writing
// every lane again; a scatter of the hits into zero-filled planes would
// still need that pass.  Here one gather core writes every lane exactly
// once, 0 where it has no hit, behind two outputs: the JAX-shaped planes
// (t_bgnori, t_end, hv), and K8's anchors (q_bgn, q_end, q_ori, t_bgn,
// t_end, t_ori) with their valid mask.  Each takes its postings in index
// form, slot (b, p) reading row[b, p] of the table p_rows (the query step's:
// K5 writes only the row index, so no (B, Pc, 3P) buffer is written and read
// back), or a fetched (B, Pc, 3P) buffer, the index form with the identity
// index.  A slot's row is read only where base_hit is set.  A block takes
// one query row and a chunk of targets c; for each tile of pair slots it
// reads their postings rows once, decodes sid, m and mult, applies the count
// filter and adds each hit into a shared-memory accumulator of the chunk's
// lanes (u32 wrap-around adds: colliding (sid, m) hits sum as the JAX
// one-hot sum does), then writes, target by target, the run of lanes
// contiguous over (p, m), consecutive threads on consecutive 16-byte words,
// so stores cover whole lines.  A row owns its flags: row_ovf and grp_ovf
// are written once, and the filtered-hit count takes one atomic a block.  No
// zero-fill but that one counter.
#include "common.cuh"

namespace {

constexpr int kStage = 1024;       // keys of a row staged at a time
constexpr int kDupMaxThreads = 512;

// One row b (or one chunk of a long row) a block, a thread a slot.
// kFilter: the step entry, which also writes base_hit and counts the
// filtered slots.
template <bool kFilter>
__global__ void dup_pair_kernel(const long long* __restrict__ k0,
                                const long long* __restrict__ k1,
                                const bool* __restrict__ valid, int Pc,
                                int chunks, const bool* __restrict__ found,
                                long long max_count, int* __restrict__ out,
                                bool* __restrict__ base_hit,
                                unsigned long long* __restrict__ n_filtered) {
  __shared__ longlong2 s_key[kStage];
  const long long rb = (long long)(blockIdx.x / chunks) * Pc;
  const int p = (int)(blockIdx.x % chunks) * blockDim.x + threadIdx.x;
  bool v = false;
  long long m0 = -1, m1 = -1;
  if (p < Pc && valid[rb + p]) {
    v = true;
    m0 = k0[rb + p];
    m1 = k1[rb + p];
  }
  int cnt = 0;
  for (int t = 0; t < Pc; t += kStage) {
    const int n = min(kStage, Pc - t);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      longlong2 w;
      w.x = w.y = -1;
      if (valid[rb + t + i]) {
        w.x = k0[rb + t + i];
        w.y = k1[rb + t + i];
      }
      s_key[i] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const longlong2 w = s_key[i];  // the same word for every thread
      cnt += (w.x == m0) & (w.y == m1);
    }
    __syncthreads();
  }
  if (p < Pc) out[rb + p] = cnt;
  if (kFilter) {
    bool drop = false;
    if (p < Pc) {
      const bool live = v && found[rb + p];
      const bool ok = cnt <= max_count;
      base_hit[rb + p] = live && ok;
      drop = live && !ok;
    }
    const int n_drop = __syncthreads_count(drop);
    if (threadIdx.x == 0 && n_drop)
      atomicAdd(n_filtered, (unsigned long long)n_drop);
  }
}

template <bool kFilter>
int dup_pair_launch(const void* k0, const void* k1, const void* valid,
                    int B, int Pc, const void* found, long long max_count,
                    void* out, void* base_hit, void* n_filtered,
                    cudaStream_t st) {
  if (B < 0 || Pc < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Pc == 0) return (int)cudaSuccess;
  const int warps = (Pc + 31) / 32;
  const int threads = warps * 32 < kDupMaxThreads ? warps * 32
                                                  : kDupMaxThreads;
  const int chunks = (Pc + threads - 1) / threads;
  const long long blocks = (long long)B * chunks;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  dup_pair_kernel<kFilter><<<(unsigned)blocks, threads, 0, st>>>(
      (const long long*)k0, (const long long*)k1, (const bool*)valid, Pc,
      chunks, (const bool*)found, max_count, (int*)out, (bool*)base_hit,
      (unsigned long long*)n_filtered);
  return (int)cudaGetLastError();
}

constexpr unsigned kMetaEmpty = 0xffffffffu;
constexpr int kExpandThreads = 512;
constexpr int kExpandLanes = 3072;  // accumulator lanes a block holds
constexpr int kExpandSlots = 256;   // pair slots a tile at most
constexpr int kLaneM = 16;          // m is 4 bits: lanes m >= 16 stay empty
constexpr int kBatch = 8;           // postings slots a thread loads at once

struct Expand {
  const unsigned* rows;  // (n_rows, 3P) [meta | bgnori | end]
  long long n_rows;
  const int* row_idx;    // (B, Pc) row of each slot, or null: slot b*Pc + p
  const bool* base_hit;  // (B, Pc)
  const int* run_len;    // (B, Pc)
  int Pc, P, C, M;
  int Me;      // accumulated lanes a slot: min(M, 16)
  int TP;      // pair slots a tile
  int Cc;      // targets a chunk
  int chunks;  // chunks a row
  unsigned max_count_target;
  bool* row_ovf;                        // (B,)
  bool* grp_ovf;                        // (B, C)
  unsigned long long* n_t_filtered;     // one counter, zeroed
  unsigned* t_bgnori;                   // (B, C, Pc, M), JAX entry
  unsigned* t_end;
  bool* hv;
  const long long* q_bgn;               // (B, Pc), anchors entry
  const long long* q_end;
  const long long* q_ori;
  long long* anchors;                   // (B*C, Pc*M, 6)
  bool* gvalid;                         // (B*C, Pc*M)
};

// One query row b and one chunk of targets a block.  kAnchors selects the
// entry: K8's anchors, or the JAX-shaped planes.
template <bool kAnchors>
__global__ void __launch_bounds__(kExpandThreads) expand_kernel(Expand a) {
  __shared__ unsigned s_bgnori[kExpandLanes], s_end[kExpandLanes];
  __shared__ unsigned char s_hit[kExpandLanes], s_grp[kExpandLanes];
  __shared__ long long s_q[3][kAnchors ? kExpandSlots : 1];
  __shared__ unsigned long long s_filtered;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x / a.chunks;
  const int c0 = (int)(blockIdx.x % a.chunks) * a.Cc;
  const int cn = min(a.Cc, a.C - c0);
  const int P = a.P, M = a.M, Me = a.Me, TP = a.TP;
  const long long N = (long long)a.Pc * M;
  const long long bp0 = b * a.Pc;
  // slot p's row of the postings; the index is read with base_hit, in
  // parallel, and the row only where base_hit is set.  An index outside
  // [0, n_rows) reads the last (not-found sentinel) row.
  auto row_at = [&](int p) {
    if (!a.row_idx) return bp0 + p;
    const long long r = a.row_idx[bp0 + p];
    return r >= 0 && r < a.n_rows ? r : a.n_rows - 1;
  };

  if (c0 == 0) {  // slot 0 carries keyovf; one block a row writes it
    int ovf = 0;
    for (int p = tid; p < a.Pc; p += kExpandThreads) {
      const bool hit = a.base_hit[bp0 + p];
      const long long r = row_at(p);
      if (!hit) continue;
      const unsigned meta = a.rows[r * 3 * P];
      ovf |= meta != kMetaEmpty && (meta >> 31);
    }
    ovf = __syncthreads_or(ovf);
    if (tid == 0) a.row_ovf[b] = ovf;
  }
  for (int c = tid; c < cn; c += kExpandThreads) s_grp[c] = 0;
  if (tid == 0) s_filtered = 0;
  unsigned filtered = 0;

  for (int p0 = 0; p0 < a.Pc; p0 += TP) {
    const int tn = min(TP, a.Pc - p0);
    for (int i = tid; i < cn * TP * Me; i += kExpandThreads) {
      s_bgnori[i] = 0;
      s_end[i] = 0;
      s_hit[i] = 0;
    }
    if (kAnchors) {
      for (int p = tid; p < tn; p += kExpandThreads) {
        s_q[0][p] = a.q_bgn[bp0 + p0 + p];
        s_q[1][p] = a.q_end[bp0 + p0 + p];
        s_q[2][p] = a.q_ori[bp0 + p0 + p];
      }
    }
    __syncthreads();
    // each postings slot (p, j) of the tile once, in address order; a
    // thread loads kBatch slots whole before it decodes any, so their
    // loads are in flight together: first every slot's base_hit, row
    // index and run length, then the postings words of the hit slots
    for (int i0 = 0; i0 < tn * P; i0 += kExpandThreads * kBatch) {
      unsigned meta[kBatch], bgnori[kBatch], end[kBatch], run[kBatch];
      int slot[kBatch];
      bool hit[kBatch];
      long long r[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int i = i0 + q * kExpandThreads + tid;
        slot[q] = i < tn * P ? i / P : 0;
        hit[q] = i < tn * P && a.base_hit[bp0 + p0 + slot[q]];
        r[q] = i < tn * P ? row_at(p0 + slot[q]) : 0;
        run[q] = i < tn * P ? (unsigned)a.run_len[bp0 + p0 + slot[q]] : 0;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int j = i0 + q * kExpandThreads + tid - slot[q] * P;
        meta[q] = kMetaEmpty;
        bgnori[q] = end[q] = 0;
        if (hit[q]) {
          const unsigned* row = a.rows + r[q] * 3 * P + j;
          meta[q] = row[0];
          bgnori[q] = row[P];
          end[q] = row[2 * P];
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (meta[q] == kMetaEmpty) continue;
        const int sid = (int)(meta[q] & 0xfffffu);
        if (sid < c0 || sid >= c0 + cn) continue;  // another chunk, or >= C
        const unsigned m = (meta[q] >> 20) & 0xfu;
        const unsigned mult = (meta[q] >> 24) & 0x7fu;
        if (run[q] * mult > a.max_count_target) {
          ++filtered;
          continue;
        }
        if (m >= (unsigned)M) {
          s_grp[sid - c0] = 1;
          continue;
        }
        const int k = ((sid - c0) * TP + slot[q]) * Me + (int)m;
        atomicAdd(&s_bgnori[k], bgnori[q]);
        atomicAdd(&s_end[k], end[q]);
        s_hit[k] = 1;
      }
    }
    __syncthreads();
    // the tile's lanes, one target at a time: lanes (g, p*M + m) for the
    // tile's p are contiguous
    const int run = tn * M;
    for (int c = 0; c < cn; ++c) {
      const long long lane0 = (b * a.C + c0 + c) * N + (long long)p0 * M;
      const int k0 = c * TP * Me;
      if (kAnchors) {
        // three 16-byte words a lane: (q_bgn, q_end), (q_ori, t_bgn),
        // (t_end, t_ori)
        longlong2* out = reinterpret_cast<longlong2*>(a.anchors + lane0 * 6);
        for (int u = tid; u < 3 * run; u += kExpandThreads) {
          const int l = u / 3, part = u - 3 * l;
          const int p = l / M, m = l - p * M;
          unsigned s = 0, e = 0;
          if (m < Me) {
            s = s_bgnori[k0 + p * Me + m];
            e = s_end[k0 + p * Me + m];
          }
          longlong2 w;
          if (part == 0) {
            w.x = s_q[0][p];
            w.y = s_q[1][p];
          } else if (part == 1) {
            w.x = s_q[2][p];
            w.y = s & 0x7fffffffu;
          } else {
            w.x = e;
            w.y = s >> 31;
          }
          out[u] = w;
        }
        for (int l = tid; l < run; l += kExpandThreads) {
          const int p = l / M, m = l - p * M;
          a.gvalid[lane0 + l] = m < Me && s_hit[k0 + p * Me + m];
        }
      } else {
        for (int l = tid; l < run; l += kExpandThreads) {
          const int p = l / M, m = l - p * M;
          const bool h = m < Me;
          const int k = k0 + p * Me + (h ? m : 0);
          a.t_bgnori[lane0 + l] = h ? s_bgnori[k] : 0u;
          a.t_end[lane0 + l] = h ? s_end[k] : 0u;
          a.hv[lane0 + l] = h && s_hit[k];
        }
      }
    }
    __syncthreads();  // the accumulators are cleared for the next tile
  }
  for (int c = tid; c < cn; c += kExpandThreads)
    a.grp_ovf[b * a.C + c0 + c] = s_grp[c];
  // hits the count filter dropped: one atomic a block
  filtered = __reduce_add_sync(0xffffffffu, filtered);
  if ((tid & 31) == 0 && filtered) atomicAdd(&s_filtered, filtered);
  __syncthreads();
  if (tid == 0 && s_filtered) atomicAdd(a.n_t_filtered, s_filtered);
}

// The launch shape of a (B, Pc, P) row set over C targets and M lanes a
// slot: tiles of pair slots and as few chunks of targets as the block's
// accumulators allow (each chunk's block reads the row's postings again).
int expand_launch(Expand& a, int B, int Pc, int P, int C, int M,
                  unsigned max_count_target, cudaStream_t st, bool anchors) {
  if (B < 0 || Pc < 0 || P < 1 || C < 0 || M < 1 ||
      3ll * Pc * M >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  a.Pc = Pc;
  a.P = P;
  a.C = C;
  a.M = M;
  a.Me = M < kLaneM ? M : kLaneM;
  a.max_count_target = max_count_target;
  int tp = Pc < kExpandSlots ? Pc : kExpandSlots;
  if (tp * a.Me > kExpandLanes) tp = kExpandLanes / a.Me;
  a.TP = tp > 0 ? tp : 1;
  const int cc_max = kExpandLanes / (a.TP * a.Me);
  const int chunks = (C + cc_max - 1) / cc_max;
  a.Cc = chunks > 0 ? (C + chunks - 1) / chunks : 1;  // balanced chunks
  a.chunks = C > 0 ? (C + a.Cc - 1) / a.Cc : 1;
  const long long blocks = (long long)B * a.chunks;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (anchors)
    expand_kernel<true><<<(unsigned)blocks, kExpandThreads, 0, st>>>(a);
  else
    expand_kernel<false><<<(unsigned)blocks, kExpandThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// k0/k1 (B, Pc) int64, valid (B, Pc) bool -> out (B, Pc) int32.
extern "C" int pgrtk_dup_pair_counts(const void* k0, const void* k1,
                                     const void* valid, int B, int Pc,
                                     void* out, void* stream) {
  return dup_pair_launch<false>(k0, k1, valid, B, Pc, nullptr, 0, out,
                                nullptr, nullptr, (cudaStream_t)stream);
}

// The query step's entry: as dup_pair_counts into run_len, and with
// found (B, Pc) bool (K5's) and the count limit c, base_hit (B, Pc) bool
// = valid & found & (run_len <= c); the number of slots with valid &
// found & (run_len > c) is added to *n_filtered (one uint64).
extern "C" int pgrtk_dup_pair_filter(const void* k0, const void* k1,
                                     const void* valid, const void* found,
                                     int B, int Pc, long long max_count,
                                     void* run_len, void* base_hit,
                                     void* n_filtered, void* stream) {
  return dup_pair_launch<true>(k0, k1, valid, B, Pc, found, max_count,
                               run_len, base_hit, n_filtered,
                               (cudaStream_t)stream);
}

// The index form: p_rows (n_rows, 3P) int32 [meta | bgnori | end], row
// (B, Pc) int32, the p_rows row of each slot, read only where base_hit
// (B, Pc) bool is set (a row outside [0, n_rows) reads the last row, the
// not-found sentinel); run_len (B, Pc) int32.  Outputs: t_bgnori and t_end
// (B, C, Pc, M) int32, hv (B, C, Pc, M) bool, row_ovf (B,) bool, grp_ovf
// (B, C) bool, each written whole; n_t_filtered one uint64, zeroed by the
// caller.
extern "C" int pgrtk_expand_postings_indexed(
    const void* p_rows, long long n_rows, const void* row,
    const void* base_hit, const void* run_len, int B, int Pc, int P, int C,
    int M, unsigned max_count_target, void* t_bgnori, void* t_end, void* hv,
    void* row_ovf, void* grp_ovf, void* n_t_filtered, void* stream) {
  if (n_rows < 1) return (int)cudaErrorInvalidValue;
  Expand a = {};
  a.rows = (const unsigned*)p_rows;
  a.n_rows = n_rows;
  a.row_idx = (const int*)row;
  a.base_hit = (const bool*)base_hit;
  a.run_len = (const int*)run_len;
  a.t_bgnori = (unsigned*)t_bgnori;
  a.t_end = (unsigned*)t_end;
  a.hv = (bool*)hv;
  a.row_ovf = (bool*)row_ovf;
  a.grp_ovf = (bool*)grp_ovf;
  a.n_t_filtered = (unsigned long long*)n_t_filtered;
  return expand_launch(a, B, Pc, P, C, M, max_count_target,
                       (cudaStream_t)stream, false);
}

// The JAX-shaped form: rows (B, Pc, 3P) int32 fetched, the index form
// with the identity index.
extern "C" int pgrtk_expand_postings(
    const void* rows, const void* base_hit, const void* run_len, int B,
    int Pc, int P, int C, int M, unsigned max_count_target, void* t_bgnori,
    void* t_end, void* hv, void* row_ovf, void* grp_ovf, void* n_t_filtered,
    void* stream) {
  return pgrtk_expand_postings_indexed(
      rows, (long long)B * Pc, nullptr, base_hit, run_len, B, Pc, P, C, M,
      max_count_target, t_bgnori, t_end, hv, row_ovf, grp_ovf, n_t_filtered,
      stream);
}

// The same postings, straight into K8's input, in index form: p_rows, row,
// base_hit, run_len as above; q_bgn, q_end, q_ori (B, Pc) int64; anchors
// (B*C, Pc*M, 6) int64 (16-byte aligned), gvalid (B*C, Pc*M) bool,
// row_ovf (B,) bool, grp_ovf (B*C,) bool, each written whole;
// n_t_filtered one uint64, zeroed by the caller.
extern "C" int pgrtk_expand_postings_anchors_indexed(
    const void* p_rows, long long n_rows, const void* row,
    const void* base_hit, const void* run_len, const void* q_bgn,
    const void* q_end, const void* q_ori, int B, int Pc, int P, int C, int M,
    unsigned max_count_target, void* anchors, void* gvalid, void* row_ovf,
    void* grp_ovf, void* n_t_filtered, void* stream) {
  if (((uintptr_t)anchors & 15) || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  Expand a = {};
  a.rows = (const unsigned*)p_rows;
  a.n_rows = n_rows;
  a.row_idx = (const int*)row;
  a.base_hit = (const bool*)base_hit;
  a.run_len = (const int*)run_len;
  a.q_bgn = (const long long*)q_bgn;
  a.q_end = (const long long*)q_end;
  a.q_ori = (const long long*)q_ori;
  a.anchors = (long long*)anchors;
  a.gvalid = (bool*)gvalid;
  a.row_ovf = (bool*)row_ovf;
  a.grp_ovf = (bool*)grp_ovf;
  a.n_t_filtered = (unsigned long long*)n_t_filtered;
  return expand_launch(a, B, Pc, P, C, M, max_count_target,
                       (cudaStream_t)stream, true);
}

// The anchors entry on fetched rows (B, Pc, 3P): the identity index.
extern "C" int pgrtk_expand_postings_anchors(
    const void* rows, const void* base_hit, const void* run_len,
    const void* q_bgn, const void* q_end, const void* q_ori, int B, int Pc,
    int P, int C, int M, unsigned max_count_target, void* anchors,
    void* gvalid, void* row_ovf, void* grp_ovf, void* n_t_filtered,
    void* stream) {
  return pgrtk_expand_postings_anchors_indexed(
      rows, (long long)B * Pc, nullptr, base_hit, run_len, q_bgn, q_end,
      q_ori, B, Pc, P, C, M, max_count_target, anchors, gvalid, row_ovf,
      grp_ovf, n_t_filtered, stream);
}
