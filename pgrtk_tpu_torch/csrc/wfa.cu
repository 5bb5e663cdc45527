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
// which capped L at 512.  Here one block of 128 threads takes one
// segment; t and q (at most L bytes each) sit in shared memory, and each
// thread extends its diagonals by comparing t[i] with q[i - k] there.
// The wavefronts live in a band of diagonals [kb_lo, kb_lo + DB), every
// diagonal a score <= S_last can reach (|k| <= s), clipped to the JAX
// plane's [-L, L); the ring of the last max(x, o+e)+1 M, I and D
// wavefronts (5 at the SV penalties) is band-wide in shared memory, so
// no window the recurrences allow can outgrow it.  A read checks the
// source's [lo, hi] window, as the arbiter's WF::get does; the trim only
// narrows a window.  Per score step: the recurrences and extension of
// the window's diagonals, the completion test on k_end, a warp-shuffle
// and shared-atomic max of (progress 2M - k, lowest k), two barriers.
//
// Outputs, every score row of a segment up to its completion (rows
// after it keep the caller's fill): the M, I and D offsets of the
// post-trim window in band coordinates as int16 (-1 = no entry, as the
// JAX history), the window's lo and hi, and final_s (the completing
// score, -1 when none by S_last).  Writing I and D spares the host the
// JAX package's _rebuild_ids.
//
// What bounds it on this card: not the bytes (t and q are read once,
// history rows are written once at the window's width) but the
// dependent chain of score steps, each a barrier-separated pass over the
// window whose extension loops diverge within a warp.  A later version
// would compare 4 or 16 bases at a time and split long extensions.
#include "common.cuh"

namespace {

constexpr int kNull = -(1 << 20);  // "no entry" (ops/wfa.py KNULL)
constexpr int kThreads = 128;
constexpr int kMaxRing = 16;
constexpr long long kBias = 1 << 20;  // makes progress and -k positive
constexpr int kEmptyLo = 1 << 30;     // window of no source (lo > hi)

__device__ __forceinline__ int extend(const uint8_t* t, const uint8_t* q,
                                      int n, int m, int k, int off) {
  int xx = off, yy = off - k;
  while (xx < n && yy < m && t[xx] == q[yy]) {
    ++xx;
    ++yy;
  }
  return xx;
}

__global__ void __launch_bounds__(kThreads) wfa_forward_kernel(
    const uint8_t* __restrict__ t_all, const uint8_t* __restrict__ q_all,
    const int* __restrict__ n_all, const int* __restrict__ m_all, int L,
    int S_last, int max_wf, int x, int o, int e, int ring, int kb_lo, int DB,
    int* __restrict__ final_s, short* __restrict__ hist_m,
    short* __restrict__ hist_i, short* __restrict__ hist_d,
    short* __restrict__ lo_hist, short* __restrict__ hi_hist) {
  extern __shared__ int4 smem4[];
  int* Mr = reinterpret_cast<int*>(smem4);
  int* Ir = Mr + ring * DB;
  int* Dr = Ir + ring * DB;
  uint8_t* ts = reinterpret_cast<uint8_t*>(Dr + ring * DB);
  uint8_t* qs = ts + L;
  __shared__ int rlo[kMaxRing], rhi[kMaxRing];
  __shared__ unsigned long long best;
  __shared__ int done, stop;

  const int g = blockIdx.x;
  const int n = n_all[g], m = m_all[g];
  const int kb_hi = kb_lo + DB - 1;
  const int k_end = n - m;
  const long long row0 = (long long)g * (S_last + 1);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    ts[i] = t_all[(long long)g * L + i];
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    qs[i] = q_all[(long long)g * L + i];
  if (threadIdx.x < ring) {  // empty windows
    rlo[threadIdx.x] = 1;
    rhi[threadIdx.x] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // s = 0: diagonal 0 extended from the origin
    const int m0 = extend(ts, qs, n, m, 0, 0);
    Mr[-kb_lo] = m0;
    Ir[-kb_lo] = kNull;
    Dr[-kb_lo] = kNull;
    rlo[0] = 0;
    rhi[0] = 0;
    hist_m[row0 * DB - kb_lo] = (short)m0;
    lo_hist[row0] = 0;
    hi_hist[row0] = 0;
    best = 0;
    done = 0;
    stop = k_end == 0 && m0 >= n;
    final_s[g] = stop ? 0 : -1;
  }
  __syncthreads();
  if (stop) return;

  // the value of a ring slot at diagonal k: null outside its window
  auto at = [&](const int* plane, int src, int k) -> int {
    if (src < 0 || k < rlo[src] || k > rhi[src] || k < kb_lo || k > kb_hi)
      return kNull;
    return plane[src * DB + k - kb_lo];
  };
  const int half = max_wf / 2;
  const unsigned full = 0xffffffffu;
  for (int s = 1; s <= S_last; ++s) {
    const int sx = s >= x ? (s - x) % ring : -1;
    const int so = s >= o + e ? (s - o - e) % ring : -1;
    const int se = s >= e ? (s - e) % ring : -1;
    // the new window spans the non-empty sources' windows, widened by 1
    int lo = kEmptyLo, hi = -kEmptyLo;
    const int srcs[3] = {sx, so, se};
    for (int i = 0; i < 3; ++i) {
      const int src = srcs[i];
      if (src >= 0 && rlo[src] <= rhi[src]) {
        lo = min(lo, rlo[src] - 1);
        hi = max(hi, rhi[src] + 1);
      }
    }
    const int slot = s % ring;
    int* Ms = Mr + slot * DB;
    int* Is = Ir + slot * DB;
    int* Ds = Dr + slot * DB;
    unsigned long long mine = 0;
    for (int k = max(lo, kb_lo) + (int)threadIdx.x; k <= min(hi, kb_hi);
         k += blockDim.x) {
      int ins = max(at(Mr, so, k - 1), at(Ir, se, k - 1));
      ins = ins > kNull ? ins + 1 : kNull;
      const int del = max(at(Mr, so, k + 1), at(Dr, se, k + 1));
      int mm = at(Mr, sx, k);
      mm = mm > kNull ? mm + 1 : kNull;
      mm = max(mm, max(ins, del));
      int v = kNull;
      if (mm > kNull && mm >= 0 && mm <= n && mm - k >= 0 && mm - k <= m)
        v = extend(ts, qs, n, m, k, mm);
      const int j = k - kb_lo;
      Ms[j] = v;
      Is[j] = ins;
      Ds[j] = del;
      if (v > kNull) {
        if (k == k_end && v >= n && v - k >= m) done = 1;
        const unsigned long long key =
            ((unsigned long long)(2LL * v - k + kBias) << 32) |
            (unsigned long long)(kBias - k);
        mine = key > mine ? key : mine;
      }
    }
    for (int d = 16; d; d >>= 1) {
      const unsigned long long other = __shfl_xor_sync(full, mine, d);
      mine = other > mine ? other : mine;
    }
    if ((threadIdx.x & 31) == 0 && mine) atomicMax(&best, mine);
    __syncthreads();
    if (threadIdx.x == 0) {
      // adaptive trim around the best-progress diagonal, lowest k among
      // ties, skipped on the step that completes (wfa.cc:127-156)
      int lo_f = lo, hi_f = hi;
      if (lo > hi) {
        lo_f = 1;
        hi_f = 0;
      } else if (hi - lo + 1 > max_wf && !done) {
        const int bk = best ? (int)(kBias - (long long)(best & 0xffffffffu))
                            : lo;
        lo_f = max(bk - half, lo);
        hi_f = min(bk + half, hi);
      }
      rlo[slot] = lo_f;
      rhi[slot] = hi_f;
      lo_hist[row0 + s] = (short)lo_f;
      hi_hist[row0 + s] = (short)hi_f;
      stop = done;
      if (done) final_s[g] = s;
      best = 0;
      done = 0;
    }
    __syncthreads();
    const long long row = (row0 + s) * DB;
    for (int k = max(rlo[slot], kb_lo) + (int)threadIdx.x;
         k <= min(rhi[slot], kb_hi); k += blockDim.x) {
      const int j = k - kb_lo;
      hist_m[row + j] = (short)(Ms[j] > kNull ? Ms[j] : -1);
      hist_i[row + j] = (short)(Is[j] > kNull ? Is[j] : -1);
      hist_d[row + j] = (short)(Ds[j] > kNull ? Ds[j] : -1);
    }
    if (stop) return;
  }
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
  const int ring = (x > o + e ? x : o + e) + 1;
  if (G < 0 || L < 1 || S_last < 0 || x < 1 || o < 0 || e < 1 || DB < 1 ||
      ring > kMaxRing)
    return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)3 * ring * DB * sizeof(int) + 2 * (size_t)L;
  cudaError_t err = cudaFuncSetAttribute(
      wfa_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wfa_forward_kernel<<<(unsigned)G, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)t, (const uint8_t*)q, (const int*)n, (const int*)m, L,
      S_last, max_wf, x, o, e, ring, kb_lo, DB, (int*)final_s,
      (short*)hist_m, (short*)hist_i, (short*)hist_d, (short*)lo_hist,
      (short*)hi_hist);
  return (int)cudaGetLastError();
}
