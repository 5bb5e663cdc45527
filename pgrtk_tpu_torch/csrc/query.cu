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
// K7.  What bounds it on this card: the lane stores.  Its output is the
// (B*C, Pc*M) chain lanes, most of them empty, and K8 reads them as (G, N,
// 6) int64 anchors with a bool mask: at the query cell's shape (B 1,024,
// Pc 256, C 94, M 3, so G = 96,256 lanes of N = 768) 3.55 GB of anchors and
// 74 MB of mask a step, ~1.1 ms at 3.35 TB/s, against ~0.4 GB of postings
// rows behind the hit slots.  The JAX function built a (B, Pc, P, C*M)
// one-hot and summed over P, and the JAX step then broadcast the query
// fields over the lanes and stacked the anchors, writing every lane again;
// a scatter of the hits into zero-filled planes would still need that
// pass.  Here one gather core writes every lane exactly once, 0 where it
// has no hit, behind two outputs: the JAX-shaped planes (t_bgnori, t_end,
// hv), and K8's anchors (q_bgn, q_end, q_ori, t_bgn, t_end, t_ori) with
// their valid mask.  Each takes its postings in index form, slot (b, p)
// reading row[b, p] of the table p_rows (the query step's: K5 writes only
// the row index, so no (B, Pc, 3P) buffer is written and read back), or a
// fetched (B, Pc, 3P) buffer, the index form with the identity index.
//
// A block takes one query row and all C targets, so each hit slot's
// postings row is read and decoded once.  Its shared memory holds the
// accumulators of a tile of TP pair slots over every target (TP x C x
// min(M, 16) lanes, within a lane budget); only where one slot's lanes
// exceed the budget (thousands of targets) are the targets chunked, a
// block a chunk, and each chunk's block reads the row's postings again.
// The shape, (TP, targets a block), is computed from (Pc, C, M) by the
// caller (ops/query_e2e.py::expand_shape).  For each tile the block lists
// the base-hit slots (a ballot and one shared atomic a warp), then a warp
// takes a listed slot and reads its row as coalesced 32-slot runs of the
// meta, bgnori and end words, decodes sid, m and mult, applies the count
// filter and adds each hit into its lane (u32 wrap-around adds: colliding
// (sid, m) hits sum as the JAX one-hot sum does).  Then the tile's lanes go
// out, a warp a run of 32 lanes of one target (contiguous over (p, m)),
// the anchors staged in shared memory so that consecutive threads store
// consecutive 16-byte words and stores cover whole lines.  A row owns its
// flags: row_ovf and grp_ovf are written once, and the filtered-hit count
// takes one atomic a block.  No zero-fill but that one counter.
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
constexpr int kExpandWarps = kExpandThreads / 32;
constexpr int kLaneM = 16;  // m is 4 bits: lanes m >= 16 stay empty
constexpr int kBatch = 9;   // 32-slot runs of a postings row in flight at once

struct Expand {
  const unsigned* rows;  // (n_rows, 3P) [meta | bgnori | end]
  long long n_rows;
  const int* row_idx;    // (B, Pc) row of each slot, or null: slot b*Pc + p
  const bool* base_hit;  // (B, Pc)
  const int* run_len;    // (B, Pc)
  int Pc, P, C, M;
  int Me;      // accumulated lanes a slot: min(M, 16)
  int TP;      // pair slots a tile
  int Cc;      // targets a block
  int chunks;  // blocks a row
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

// Byte offsets of a block's dynamic shared memory, from its shape:
// the accumulators of its Cc x TP x Me lanes (bgnori and end sums, hit
// flags), two buffers (by tile parity) of the tile's hit-slot list and
// query fields, a warp's 96-word staging run, and the chunk's grp flags.
struct ExpandSmem {
  long long end, q, stage, list_r, list_p, list_run, hit, grp, bytes;
};

__host__ __device__ inline long long align16(long long x) {
  return (x + 15) & ~15ll;
}

__host__ __device__ inline ExpandSmem expand_smem(int TP, int Cc, int Me,
                                                  bool anchors) {
  const long long lanes = (long long)TP * Cc * Me;
  ExpandSmem s;
  s.end = align16(4 * lanes);
  s.q = s.end + align16(4 * lanes);
  s.stage = s.q + (anchors ? 2 * 3 * 8ll * TP : 0);
  s.list_r = s.stage + (anchors ? 16ll * 96 * kExpandWarps : 0);
  s.list_p = s.list_r + 2 * 8ll * TP;
  s.list_run = s.list_p + align16(2 * 4ll * TP);
  s.hit = s.list_run + align16(2 * 4ll * TP);
  s.grp = s.hit + align16(lanes);
  s.bytes = s.grp + align16(Cc);
  return s;
}

// One query row b and one chunk of Cc targets a block (all C targets
// unless one slot's C x Me lanes exceed the lane budget).  kAnchors
// selects the entry: K8's anchors, or the JAX-shaped planes.
template <bool kAnchors>
__global__ void __launch_bounds__(kExpandThreads) expand_kernel(Expand a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = a.P, M = a.M, Me = a.Me, TP = a.TP;
  const ExpandSmem L = expand_smem(TP, a.Cc, Me, kAnchors);
  unsigned* acc_bo = reinterpret_cast<unsigned*>(smem);
  unsigned* acc_end = reinterpret_cast<unsigned*>(smem + L.end);
  unsigned char* acc_hit = smem + L.hit;
  unsigned char* s_grp = smem + L.grp;
  long long* s_q = reinterpret_cast<long long*>(smem + L.q);  // [2][3][TP]
  longlong2* s_stage = reinterpret_cast<longlong2*>(smem + L.stage);
  long long* list_r = reinterpret_cast<long long*>(smem + L.list_r);
  int* list_p = reinterpret_cast<int*>(smem + L.list_p);
  unsigned* list_run = reinterpret_cast<unsigned*>(smem + L.list_run);
  __shared__ int s_nhit[2];
  __shared__ unsigned long long s_filtered;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x / a.chunks;
  const int c0 = (int)(blockIdx.x % a.chunks) * a.Cc;
  const int cn = max(0, min(a.Cc, a.C - c0));
  const long long N = (long long)a.Pc * M;
  const long long bp0 = b * a.Pc;
  // slot p's row of the postings; an index outside [0, n_rows) reads
  // the last (not-found sentinel) row
  auto row_at = [&](int p) {
    if (!a.row_idx) return bp0 + p;
    const long long r = a.row_idx[bp0 + p];
    return r >= 0 && r < a.n_rows ? r : a.n_rows - 1;
  };

  // cleared once: the write of each tile clears the lanes it reads
  for (int i = tid; i < cn * TP * Me; i += kExpandThreads) {
    acc_bo[i] = 0;
    acc_end[i] = 0;
    acc_hit[i] = 0;
  }
  for (int c = tid; c < cn; c += kExpandThreads) s_grp[c] = 0;
  if (tid == 0) {
    s_nhit[0] = s_nhit[1] = 0;
    s_filtered = 0;
  }
  __syncthreads();
  unsigned filtered = 0;
  int ovf = 0;  // keyovf on slot 0 of a base hit's row

  for (int p0 = 0, t = 0; p0 < a.Pc; p0 += TP, ++t) {
    const int tn = min(TP, a.Pc - p0), buf = t & 1;
    long long* lr = list_r + buf * TP;
    int* lp = list_p + buf * TP;
    unsigned* lrun = list_run + buf * TP;
    long long* q = s_q + buf * 3 * TP;
    // the tile's base-hit slots as a list, in any order: every sum
    // below is order-free
    for (int p = tid; p - lane < tn; p += kExpandThreads) {
      const bool hit = p < tn && a.base_hit[bp0 + p0 + p];
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      int at = 0;
      if (lane == 0 && mask) at = atomicAdd(&s_nhit[buf], __popc(mask));
      at = __shfl_sync(0xffffffffu, at, 0) +
           __popc(mask & ((1u << lane) - 1));
      if (hit) {
        lp[at] = p;
        lr[at] = row_at(p0 + p);
        lrun[at] = (unsigned)a.run_len[bp0 + p0 + p];
      }
      if (kAnchors && p < tn) {
        q[p] = a.q_bgn[bp0 + p0 + p];
        q[TP + p] = a.q_end[bp0 + p0 + p];
        q[2 * TP + p] = a.q_ori[bp0 + p0 + p];
      }
    }
    __syncthreads();
    // a warp a hit slot: its postings row read once, as coalesced runs of
    // 32 slots of each of the three words, kBatch runs in flight at once;
    // each posting of the chunk's targets adds into its lane (u32
    // wrap-around adds: colliding (sid, m) hits sum as the JAX one-hot
    // sum does)
    const int nh = s_nhit[buf];
    for (int h = warp; h < nh; h += kExpandWarps) {
      const int p = lp[h];
      const unsigned run = lrun[h];
      const unsigned* row = a.rows + lr[h] * 3 * P;
      for (int j0 = 0; j0 < P; j0 += 32 * kBatch) {
        unsigned meta[kBatch], bgnori[kBatch], end[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = j0 + 32 * u + lane;
          meta[u] = kMetaEmpty;
          bgnori[u] = end[u] = 0;
          if (j < P) {
            meta[u] = row[j];
            bgnori[u] = row[P + j];
            end[u] = row[2 * P + j];
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (meta[u] == kMetaEmpty) continue;
          if (j0 + 32 * u + lane == 0) ovf |= meta[u] >> 31;
          const int sid = (int)(meta[u] & 0xfffffu);
          if (sid < c0 || sid >= c0 + cn) continue;  // another chunk, or >= C
          const unsigned m = (meta[u] >> 20) & 0xfu;
          const unsigned mult = (meta[u] >> 24) & 0x7fu;
          if (run * mult > a.max_count_target) {
            ++filtered;
            continue;
          }
          if (m >= (unsigned)M) {
            s_grp[sid - c0] = 1;
            continue;
          }
          const int k = ((sid - c0) * TP + p) * Me + (int)m;
          atomicAdd(&acc_bo[k], bgnori[u]);
          atomicAdd(&acc_end[k], end[u]);
          acc_hit[k] = 1;
        }
      }
    }
    if (tid == 0) s_nhit[buf ^ 1] = 0;  // the next tile's list
    __syncthreads();
    // the tile's lanes (g, p*M + m), contiguous over the tile's p for each
    // target: a warp a span of 32 lanes of one target, each lane read from
    // the accumulators (and cleared) by one thread
    const int run = tn * M;
    const int spans = (run + 31) >> 5;
    for (int it = warp; it < cn * spans; it += kExpandWarps) {
      const int c = it / spans;
      const int l0 = (it - c * spans) * 32, l = l0 + lane;
      const int nl = min(32, run - l0);
      const long long lane0 = (b * a.C + c0 + c) * N + (long long)p0 * M + l0;
      unsigned s = 0, e = 0;
      bool h = false;
      int p = 0;
      if (lane < nl) {
        p = l / M;
        const int m = l - p * M;
        if (m < Me) {
          const int k = (c * TP + p) * Me + m;
          s = acc_bo[k];
          e = acc_end[k];
          h = acc_hit[k];
          acc_bo[k] = 0;
          acc_end[k] = 0;
          acc_hit[k] = 0;
        }
      }
      if (kAnchors) {
        // three 16-byte words a lane, (q_bgn, q_end), (q_ori, t_bgn),
        // (t_end, t_ori), staged so that consecutive threads store
        // consecutive words
        longlong2* st = s_stage + warp * 96;
        if (lane < nl) {
          st[3 * lane] = make_longlong2(q[p], q[TP + p]);
          st[3 * lane + 1] = make_longlong2(q[2 * TP + p], s & 0x7fffffffu);
          st[3 * lane + 2] = make_longlong2(e, s >> 31);
        }
        __syncwarp();
        longlong2* out = reinterpret_cast<longlong2*>(a.anchors + lane0 * 6);
#pragma unroll
        for (int u = 0; u < 3; ++u)
          if (32 * u + lane < 3 * nl)
            __stcs(out + 32 * u + lane, st[32 * u + lane]);
        __syncwarp();
        if (lane < nl) a.gvalid[lane0 + lane] = h;
      } else if (lane < nl) {
        a.t_bgnori[lane0 + lane] = s;
        a.t_end[lane0 + lane] = e;
        a.hv[lane0 + lane] = h;
      }
    }
  }
  for (int c = tid; c < cn; c += kExpandThreads)
    a.grp_ovf[b * a.C + c0 + c] = s_grp[c];
  ovf = __syncthreads_or(ovf);
  if (tid == 0 && c0 == 0) a.row_ovf[b] = ovf;  // one block a row writes it
  // hits the count filter dropped: one atomic a block
  filtered = __reduce_add_sync(0xffffffffu, filtered);
  if (lane == 0 && filtered) atomicAdd(&s_filtered, filtered);
  __syncthreads();
  if (tid == 0 && s_filtered) atomicAdd(a.n_t_filtered, s_filtered);
}

// The launch over a (B, Pc, P) row set of C targets and M lanes a slot,
// in the shape the caller computed (ops/query_e2e.py::expand_shape): TP
// pair slots a tile and Cc targets a block, so B x ceil(C / Cc) blocks.
int expand_launch(Expand& a, int B, int Pc, int P, int C, int M, int TP,
                  int Cc, unsigned max_count_target, cudaStream_t st,
                  bool anchors) {
  if (B < 0 || Pc < 0 || P < 1 || C < 0 || M < 1 || TP < 1 || Cc < 1 ||
      3ll * Pc * M >= (1ll << 31) || (long long)TP * Cc > (1 << 22))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  a.Pc = Pc;
  a.P = P;
  a.C = C;
  a.M = M;
  a.Me = M < kLaneM ? M : kLaneM;
  a.TP = TP;
  a.Cc = Cc;
  a.max_count_target = max_count_target;
  a.chunks = C > 0 ? (C + Cc - 1) / Cc : 1;
  const long long blocks = (long long)B * a.chunks;
  const long long smem = expand_smem(TP, Cc, a.Me, anchors).bytes;
  if (blocks >= (1ll << 31) || smem >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      anchors ? pgrtk::allow_smem<1>(expand_kernel<true>, (int)smem)
              : pgrtk::allow_smem<0>(expand_kernel<false>, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (anchors)
    expand_kernel<true><<<(unsigned)blocks, kExpandThreads, smem, st>>>(a);
  else
    expand_kernel<false><<<(unsigned)blocks, kExpandThreads, smem, st>>>(a);
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
// caller.  TP and Cc are the launch shape, ops/query_e2e.py::expand_shape:
// pair slots a tile and targets a block.
extern "C" int pgrtk_expand_postings_indexed(
    const void* p_rows, long long n_rows, const void* row,
    const void* base_hit, const void* run_len, int B, int Pc, int P, int C,
    int M, int TP, int Cc, unsigned max_count_target, void* t_bgnori,
    void* t_end, void* hv, void* row_ovf, void* grp_ovf, void* n_t_filtered,
    void* stream) {
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
  return expand_launch(a, B, Pc, P, C, M, TP, Cc, max_count_target,
                       (cudaStream_t)stream, false);
}

// The JAX-shaped form: rows (B, Pc, 3P) int32 fetched, the index form
// with the identity index.
extern "C" int pgrtk_expand_postings(
    const void* rows, const void* base_hit, const void* run_len, int B,
    int Pc, int P, int C, int M, int TP, int Cc, unsigned max_count_target,
    void* t_bgnori, void* t_end, void* hv, void* row_ovf, void* grp_ovf,
    void* n_t_filtered, void* stream) {
  return pgrtk_expand_postings_indexed(
      rows, (long long)B * Pc, nullptr, base_hit, run_len, B, Pc, P, C, M,
      TP, Cc, max_count_target, t_bgnori, t_end, hv, row_ovf, grp_ovf,
      n_t_filtered, stream);
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
    int TP, int Cc, unsigned max_count_target, void* anchors, void* gvalid,
    void* row_ovf, void* grp_ovf, void* n_t_filtered, void* stream) {
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
  return expand_launch(a, B, Pc, P, C, M, TP, Cc, max_count_target,
                       (cudaStream_t)stream, true);
}

// The anchors entry on fetched rows (B, Pc, 3P): the identity index.
extern "C" int pgrtk_expand_postings_anchors(
    const void* rows, const void* base_hit, const void* run_len,
    const void* q_bgn, const void* q_end, const void* q_ori, int B, int Pc,
    int P, int C, int M, int TP, int Cc, unsigned max_count_target,
    void* anchors, void* gvalid, void* row_ovf, void* grp_ovf,
    void* n_t_filtered, void* stream) {
  return pgrtk_expand_postings_anchors_indexed(
      rows, (long long)B * Pc, nullptr, base_hit, run_len, q_bgn, q_end,
      q_ori, B, Pc, P, C, M, TP, Cc, max_count_target, anchors, gvalid,
      row_ovf, grp_ovf, n_t_filtered, stream);
}
