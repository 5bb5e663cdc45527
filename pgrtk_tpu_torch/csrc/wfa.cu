// K13 wfa_forward: the gap-affine wavefront alignment (WFA) forward pass
// of a batch of segment pairs, with the arbiter's adaptive trim.
//
// Replaces pgrtk_tpu/ops/wfa.py:103 wfa_forward_batch (and the planes it
// builds first, :44 _shifted_query_planes and :80 _run_length_planes).
// The recurrences, the bounds check, the completion test before the
// trim and the trim itself are those of the arbiter
// (pgrtk_tpu_torch/native/wfa.cc:64-157) as the JAX function vectorises
// them (ops/wfa.py:257-371); the scores advance in rounds of 8 from s = 1
// and a round starts only at s <= S_max (ops/wfa.py:220-229, 253-255,
// 373-382), so the last score computed is S_last = 8 * ceil(S_max / 8).
//
// The TPU function could not compare bases inside its loop: it built a
// (G, 2L, L) run-length plane of every diagonal before the first step
// and read each extension out of it with a one-hot masked reduction,
// which capped L at 512.  Here a block of eight warps takes one segment
// and compares t[i] with q[i - k] along each diagonal as it goes.
//
// What bounds it on this card: neither bytes nor operations (t and q are
// read once, a segment's rows are written once) but the dependent chain
// of score steps, each a pass over the window that ends in one block
// barrier, and the load latency of the extensions inside a step.  On the
// SV path most segments complete at s = 0 on one long run of matches
// (up to 3,297 bases), and the few that never complete run all S_last =
// 256 steps over windows of up to 513 diagonals: those set the launch's
// time.  The design shortens both chains:
//  - t and q are staged in shared memory: a step's compares depend on
//    the step before, so each waits a full load latency, and read from
//    global memory (through L1) they cost more than the rest of a step.
//  - 8 bases a compare: two aligned 8-byte words joined by a shift give
//    the unaligned window of t and of q; the XOR's lowest set byte
//    (__ffsll) is the first mismatch.  Bytes compare exactly, so N,
//    lowercase and the padding mismatch as the arbiter's byte loop has
//    them mismatch.
//  - A thread extends its diagonal by two such compares, their loads
//    issued together.  The runs still open after 16 bases go to the
//    warp together (a ballot of the open lanes): p open runs split the
//    warp into p groups of 32 / p lanes, each lane comparing 16 bases a
//    round, and a ballot masked to each group finds its first lane that
//    stopped.  A round costs one load latency however many runs are
//    open, and a lone run takes 512 bases a round; the origin's run at
//    s = 0, which can span the whole segment, is one.
//  - Diagonals are dealt to the warps in 32-wide strips, so a 513-wide
//    window is two strips a warp and a warp with no diagonal in the
//    window skips the step's body; the window is 2s+1 wide until the
//    trim, so small scores keep one warp busy.
//  - One barrier a step, __syncthreads_or, which also reduces the
//    completion flag.  Only a step whose window is wider than
//    max_wf_length, and that does not complete, needs the best progress
//    2M - k and the lowest k among ties: each warp reduces its own
//    (__reduce_max_sync, then __reduce_min_sync) and, after a second
//    barrier, every thread combines the warps' and computes the trimmed
//    window itself, so no further barrier hands it over.
//  - The compares and the ring reads are branch-free (out-of-range
//    offsets read inside the stage and count nothing), so a thread's
//    loads issue together.
// What is left: a step is a chain of dependent shared-memory reads, ALU
// work and one barrier, about a microsecond and a half on the card
// whatever the window's width, so the segments that never complete (~1%
// on the SV path, 256 steps each) set a launch's time
// (kernels/timing.py wfa times them alone).
//  - The ring of the last max(x, o+e)+1 M, I and D wavefronts is int16
//    (_check in ops/wfa.py keeps every offset below 2^15, and -1 is "no
//    entry", since offsets are >= 0): 15,390 bytes at the SV sizes, and
//    31,806 with t and q, so seven segments fit on an SM.  It stays
//    band-wide (indexed by k - kb_lo): a window-wide ring would save
//    a third of that, one more segment an SM.
// The wavefronts live in a band of diagonals [kb_lo, kb_lo + DB), every
// diagonal a score <= S_last can reach (|k| <= s), clipped to the JAX
// plane's [-L, L).  A read checks the source's [lo, hi] window, as the
// arbiter's WF::get does; the trim only narrows a window.
//
// Two entries write the rows of each score up to a segment's completion
// (or S_last): M, I and D offsets of the post-trim window inside the
// band as int16 (-1 = no entry), the window's lo and hi, and final_s
// (the completing score, -1 when none by S_last).
//  - pgrtk_wfa_forward: band rows (G, S_last+1, DB), the JAX layout of
//    ops/wfa.py::wfa_forward_batch; the caller fills the planes, and rows
//    after a completion keep the fill.
//  - pgrtk_wfa_forward_rows (the SV path's entry): each segment's rows,
//    one after another at their windows' widths, in its `cap` entries;
//    nothing outside them is written, rows after the completion are not
//    written at all.  So the caller needs no fill, and the host copies
//    only the entries the backtrace reads.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRing = 16;
constexpr int kEmptyLo = 1 << 30;  // window of no source (lo > hi)
constexpr unsigned kFull = 0xffffffffu;

// The 8 bytes of a staged sequence from offset i on, little-endian: two
// aligned words joined by a shift (the stage holds 16 bytes past the
// sequence, so both words lie inside it).
__device__ __forceinline__ unsigned long long load8(const uint8_t* seq,
                                                    int i) {
  const unsigned long long* w =
      reinterpret_cast<const unsigned long long*>(seq) + (i >> 3);
  const int sh = (i & 7) * 8;
  return sh ? (w[0] >> sh) | (w[1] << (64 - sh)) : w[0];
}

// Matching bases of the staged t[xx..] and q[yy..]: at most 8, and at
// most the bases left on either side.  Branch-free, so that a thread's
// compares issue their loads together: an offset past a sequence reads
// inside the stage (clamped to `top`) and counts no base.
__device__ __forceinline__ int match8(const uint8_t* t, const uint8_t* q,
                                      int n, int m, int xx, int yy,
                                      int top) {
  const int lim = min(8, min(n - xx, m - yy));
  const unsigned long long d = load8(t, min(max(xx, 0), top)) ^
                               load8(q, min(max(yy, 0), top));
  return max(0, d ? min((__ffsll((long long)d) - 1) >> 3, lim) : lim);
}

// The runs of matches still open on a warp's lanes, extended together.
// The p lanes with `open` set split the warp into p groups of 32 / p
// lanes; each group takes one open lane's diagonal k from its offset xx,
// 16 bases a lane a round (512 a round for a lone run), and a ballot
// masked to the group finds its first lane that stopped.  Every lane
// calls it; an open lane gets its run's end, the others their xx.
// `scratch` is the warp's 64 ints of shared memory.
__device__ int warp_runs(const uint8_t* t, const uint8_t* q, int n, int m,
                         int top, int k, int xx, bool open, int lane,
                         int* scratch) {
  const unsigned pend = __ballot_sync(kFull, open);
  if (!pend) return xx;
  const int rank = __popc(pend & ((1u << lane) - 1));  // among open lanes
  if (open) {
    scratch[rank] = k;
    scratch[32 + rank] = xx;
  }
  __syncwarp();
  const int p = __popc(pend), w = 32 / p;
  const int g = lane / w, c = lane - g * w;  // group and chunk
  const unsigned gmask = w == 32 ? kFull : ((1u << w) - 1) << (g * w);
  bool done = g >= p;  // lanes past the last group idle
  const int gk = done ? 0 : scratch[g];
  int gx = done ? 0 : scratch[32 + g];
  __syncwarp();
  for (;;) {
    int r = 0;
    if (!done) {
      const int xs = gx + 16 * c;
      const int r1 = match8(t, q, n, m, xs, xs - gk, top);
      const int r2 = match8(t, q, n, m, xs + 8, xs + 8 - gk, top);
      r = r1 < 8 ? r1 : 8 + r2;
    }
    const unsigned stop = __ballot_sync(kFull, !done && r < 16) & gmask;
    const int f = stop ? __ffs(stop) - 1 : lane;
    const int rf = __shfl_sync(kFull, r, f);
    if (!done) {
      gx += stop ? 16 * (f - g * w) + rf : 16 * w;
      done = stop != 0;
    }
    if (__all_sync(kFull, done)) break;
  }
  if (g < p && c == 0) scratch[32 + g] = gx;
  __syncwarp();
  const int end = open ? scratch[32 + rank] : xx;
  __syncwarp();
  return end;
}

// The value of ring plane `plane` at slot src and diagonal k: -1 outside
// the slot's window [wl, wh] (already clipped to the band) or for no
// slot.  Branch-free: the load reads entry 0 when it does not count.
__device__ __forceinline__ int at(const short* plane, int src, int wl, int wh,
                                  int k, int kb_lo, int DB) {
  const bool ok = src >= 0 && k >= wl && k <= wh;
  const int v = plane[ok ? src * DB + k - kb_lo : 0];
  return ok ? v : -1;
}

template <bool kRows>
__global__ void __launch_bounds__(kThreads) wfa_forward_kernel(
    const uint8_t* __restrict__ t_all, const uint8_t* __restrict__ q_all,
    const int* __restrict__ n_all, const int* __restrict__ m_all, int L,
    int S_last, int max_wf, int x, int o, int e, int ring, int kb_lo, int DB,
    long long cap, int* __restrict__ final_s, short* __restrict__ out_m,
    short* __restrict__ out_i, short* __restrict__ out_d,
    short* __restrict__ lo_hist, short* __restrict__ hi_hist) {
  extern __shared__ int4 smem4[];
  // t and q staged at stride `span` (L + 16 rounded up to 16 bytes), then
  // the M, I and D rings
  const int span = (L + 31) & ~15;
  const int top = span - 16;  // the last offset load8 may read from
  uint8_t* t = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* q = t + span;
  short* Mr = reinterpret_cast<short*>(q + span);
  short* Ir = Mr + ring * DB;
  short* Dr = Ir + ring * DB;
  // each warp's copy of the ring slots' windows
  __shared__ int wlo[kWarps][kMaxRing], whi[kWarps][kMaxRing];
  // per warp, on a step that trims: best progress, its lowest k
  __shared__ int part_p[kWarps], part_k[kWarps];
  __shared__ int runs[kWarps][64];  // warp_runs' scratch
  __shared__ int origin;

  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = n_all[g], m = m_all[g];
  for (int i = tid; i < n; i += kThreads) t[i] = t_all[(long long)g * L + i];
  for (int i = tid; i < m; i += kThreads) q[i] = q_all[(long long)g * L + i];
  const int kb_hi = kb_lo + DB - 1;
  const int k_end = n - m;
  const long long row0 = (long long)g * (S_last + 1);
  // band rows: row s of the segment at (row0 + s) * DB; compact rows:
  // the next row at `next`, one entry per diagonal of its window
  long long next = (long long)g * cap;

  if (lane < ring) {  // slot 0 holds s = 0's window [0, 0]; the rest none
    wlo[warp][lane] = lane ? 1 : 0;
    whi[warp][lane] = 0;
  }
  __syncthreads();
  if (warp == 0) {  // s = 0: diagonal 0 extended from the origin
    const int m0 =
        warp_runs(t, q, n, m, top, 0, 0, lane == 0, lane, runs[0]);
    if (lane == 0) {
      Mr[-kb_lo] = (short)m0;
      Ir[-kb_lo] = -1;
      Dr[-kb_lo] = -1;
      const long long at0 = kRows ? next : row0 * DB - kb_lo;
      out_m[at0] = (short)m0;
      if (kRows) {
        out_i[at0] = -1;
        out_d[at0] = -1;
      }
      lo_hist[row0] = 0;
      hi_hist[row0] = 0;
      final_s[g] = k_end == 0 && m0 >= n ? 0 : -1;
      origin = m0;
    }
  }
  __syncthreads();
  if (k_end == 0 && origin >= n) return;
  ++next;

  const int half = max_wf / 2;
  int slot = 0;  // s % ring
  for (int s = 1; s <= S_last; ++s) {
    slot = slot + 1 == ring ? 0 : slot + 1;
    // the ring slot of score s - d (d < ring), -1 before score 0
    auto back = [&](int d) {
      return s < d ? -1 : slot >= d ? slot - d : slot - d + ring;
    };
    const int sx = back(x), so = back(o + e), se = back(e);
    const int lx = sx >= 0 ? wlo[warp][sx] : 1, hx = sx >= 0 ? whi[warp][sx] : 0;
    const int lo_o = so >= 0 ? wlo[warp][so] : 1;
    const int hi_o = so >= 0 ? whi[warp][so] : 0;
    const int lo_e = se >= 0 ? wlo[warp][se] : 1;
    const int hi_e = se >= 0 ? whi[warp][se] : 0;
    // the new window spans the non-empty sources' windows, widened by 1
    int lo = kEmptyLo, hi = -kEmptyLo;
    if (lx <= hx) {
      lo = lx - 1;
      hi = hx + 1;
    }
    if (lo_o <= hi_o) {
      lo = min(lo, lo_o - 1);
      hi = max(hi, hi_o + 1);
    }
    if (lo_e <= hi_e) {
      lo = min(lo, lo_e - 1);
      hi = max(hi, hi_e + 1);
    }
    const bool may_trim = lo <= hi && hi - lo + 1 > max_wf;
    // the sources' windows clipped to the band, for `at`
    const int cx_lo = max(lx, kb_lo), cx_hi = min(hx, kb_hi);
    const int co_lo = max(lo_o, kb_lo), co_hi = min(hi_o, kb_hi);
    const int ce_lo = max(lo_e, kb_lo), ce_hi = min(hi_e, kb_hi);
    short* Ms = Mr + slot * DB;
    short* Is = Ir + slot * DB;
    short* Ds = Dr + slot * DB;
    int done = 0, bp = INT_MIN, bk = INT_MAX;
    const int kh = min(hi, kb_hi);
    for (int k0 = max(lo, kb_lo) + 32 * warp; k0 <= kh; k0 += kThreads) {
      const int k = k0 + lane;
      const bool active = k <= kh;
      int ins = -1, del = -1, xx = -1;
      bool open = false;
      if (active) {
        ins = max(at(Mr, so, co_lo, co_hi, k - 1, kb_lo, DB),
                  at(Ir, se, ce_lo, ce_hi, k - 1, kb_lo, DB));
        ins = ins >= 0 ? ins + 1 : -1;
        del = max(at(Mr, so, co_lo, co_hi, k + 1, kb_lo, DB),
                  at(Dr, se, ce_lo, ce_hi, k + 1, kb_lo, DB));
        int mm = at(Mr, sx, cx_lo, cx_hi, k, kb_lo, DB);
        mm = max(mm >= 0 ? mm + 1 : -1, max(ins, del));
        // both compares' loads issue together, whether or not they count
        const int r1 = match8(t, q, n, m, mm, mm - k, top);
        const int r2 = match8(t, q, n, m, mm + 8, mm + 8 - k, top);
        const bool ok = mm >= 0 && mm <= n && mm - k >= 0 && mm - k <= m;
        xx = ok ? mm + (r1 < 8 ? r1 : 8 + r2) : -1;
        open = ok && r1 == 8 && r2 == 8;
      }
      // runs still open go to the warp, all of them at once
      xx = warp_runs(t, q, n, m, top, k, xx, open, lane, runs[warp]);
      if (active) {
        const int j = k - kb_lo;
        Ms[j] = (short)xx;
        Is[j] = (short)ins;
        Ds[j] = (short)del;
        if (xx >= 0) {
          if (k == k_end && xx >= n && xx - k >= m) done = 1;
          const int p = 2 * xx - k;
          if (p > bp) {  // k rises, so ties keep the lowest k
            bp = p;
            bk = k;
          }
        }
      }
    }
    // the step's one barrier, which also makes its ring entries visible
    const int all_done = __syncthreads_or(done);
    // adaptive trim around the best-progress diagonal, lowest k among
    // ties, skipped on the step that completes (wfa.cc:127-156)
    int lo_f = lo, hi_f = hi;
    if (lo > hi) {
      lo_f = 1;
      hi_f = 0;
    } else if (may_trim && !all_done) {
      // a second barrier, on the steps that trim: each warp's best, then
      // the block's
      const int wp = __reduce_max_sync(kFull, bp);
      bk = __reduce_min_sync(kFull, bp == wp ? bk : INT_MAX);
      if (lane == 0) {
        part_p[warp] = wp;
        part_k[warp] = bk;
      }
      __syncthreads();
      int best_p = INT_MIN, best_k = INT_MAX;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int p = part_p[w], kk = part_k[w];
        if (p > best_p || (p == best_p && kk < best_k)) {
          best_p = p;
          best_k = kk;
        }
      }
      const int c = best_p > INT_MIN ? best_k : lo;
      lo_f = max(c - half, lo);
      hi_f = min(c + half, hi);
    }
    if (lane == 0) {
      wlo[warp][slot] = lo_f;
      whi[warp][slot] = hi_f;
    }
    __syncwarp();
    if (tid == 0) {
      lo_hist[row0 + s] = (short)lo_f;
      hi_hist[row0 + s] = (short)hi_f;
      if (all_done) final_s[g] = s;
    }
    // row s: the post-trim window inside the band
    const int wl = max(lo_f, kb_lo), wh = min(hi_f, kb_hi);
    const long long row = kRows ? next - wl : (row0 + s) * DB - kb_lo;
    for (int k = wl + tid; k <= wh; k += kThreads) {
      const int j = slot * DB + k - kb_lo;
      out_m[row + k] = Mr[j];
      out_i[row + k] = Ir[j];
      out_d[row + k] = Dr[j];
    }
    if (kRows) next += max(0, wh - wl + 1);
    if (all_done) return;
  }
}

template <bool kRows>
int launch(const void* t, const void* q, const void* n, const void* m, int G,
           int L, int S_last, int max_wf, int x, int o, int e, int kb_lo,
           int DB, long long cap, void* final_s, void* out_m, void* out_i,
           void* out_d, void* lo_hist, void* hi_hist, void* stream) {
  const int ring = (x > o + e ? x : o + e) + 1;
  if (G < 0 || L < 1 || S_last < 0 || x < 1 || o < 0 || e < 1 || DB < 1 ||
      ring > kMaxRing || L + S_last >= (1 << 15))
    return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  const size_t smem =
      2 * (size_t)((L + 31) & ~15) + (size_t)3 * ring * DB * sizeof(short);
  cudaError_t err = cudaFuncSetAttribute(
      wfa_forward_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wfa_forward_kernel<kRows>
      <<<(unsigned)G, kThreads, smem, (cudaStream_t)stream>>>(
          (const uint8_t*)t, (const uint8_t*)q, (const int*)n, (const int*)m,
          L, S_last, max_wf, x, o, e, ring, kb_lo, DB, cap, (int*)final_s,
          (short*)out_m, (short*)out_i, (short*)out_d, (short*)lo_hist,
          (short*)hi_hist);
  return (int)cudaGetLastError();
}

}  // namespace

// t, q (G, L) uint8; n, m (G,) int32 (<= L).  Outputs: final_s (G,)
// int32; hist_m, hist_i, hist_d (G, S_last+1, DB) int16 and lo_hist,
// hi_hist (G, S_last+1) int16, filled by the caller with -1, -1, -1, 0,
// -1.  The wrapper checks that the shared memory fits.
extern "C" int pgrtk_wfa_forward(const void* t, const void* q, const void* n,
                                 const void* m, int G, int L, int S_last,
                                 int max_wf, int x, int o, int e, int kb_lo,
                                 int DB, void* final_s, void* hist_m,
                                 void* hist_i, void* hist_d, void* lo_hist,
                                 void* hi_hist, void* stream) {
  return launch<false>(t, q, n, m, G, L, S_last, max_wf, x, o, e, kb_lo, DB,
                       0, final_s, hist_m, hist_i, hist_d, lo_hist, hi_hist,
                       stream);
}

// The SV path's entry: as pgrtk_wfa_forward, but rows_m, rows_i, rows_d
// are (G, cap) int16, segment g's rows 0..last (last = final_s, or S_last
// without a completion) one after another at their windows' widths
// inside the band; lo_hist and hi_hist rows 0..last.  Nothing else is
// written, so the caller fills nothing.  cap >= the sum over s <= S_last
// of min(2s + 1, DB), the widest rows can be.
extern "C" int pgrtk_wfa_forward_rows(const void* t, const void* q,
                                      const void* n, const void* m, int G,
                                      int L, int S_last, int max_wf, int x,
                                      int o, int e, int kb_lo, int DB,
                                      long long cap, void* final_s,
                                      void* rows_m, void* rows_i,
                                      void* rows_d, void* lo_hist,
                                      void* hi_hist, void* stream) {
  return launch<true>(t, q, n, m, G, L, S_last, max_wf, x, o, e, kb_lo, DB,
                      cap, final_s, rows_m, rows_i, rows_d, lo_hist, hi_hist,
                      stream);
}
