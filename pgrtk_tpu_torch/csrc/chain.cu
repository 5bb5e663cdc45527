// K8 chain_scores_fast: sparse anchor-chain DP over many groups.  K10
// chain_scores_dense, the variant exact under duplicate anchors, is at
// the end of the file.
//
// Replaces pgrtk_tpu/ops/chain.py:252 chain_scores_fast (the reference's
// serial DP, aln.rs:12-142, with a W-anchor recency window).
//
// What bounds it on this card: the sequential dependence along a group.
// Anchor i's score needs anchor i-1's, so a group is N dependent steps of
// a few dozen instructions each (N = 576 at the bench step); the data
// (48 bytes per anchor in, 8 out) is small.  The card gets parallelism
// only across groups (G = 1024 at the bench step), so the kernel is
// latency bound.
//
// Design: one warp per group, window slot d in lane d (W <= 32), the
// window recency-ordered as the JAX scan keeps it.  Per step every lane
// reads the current anchor (the next one is loaded a step ahead), tests
// its slot against the reference's filters, and ballots replace the JAX
// scans: the distinct-left count is a popcount of the run-start mask
// below the lane, the segmented OR-scan (oriented / max_gap) a mask of
// the unfiltered slots between the lane's run start and the lane, the
// best score a shuffle max and the nearest-wins tie a shuffle max of the
// slot's anchor index.  Invalid anchors do not enter the window; the push
// is a __shfl_up_sync gated on validity.  Arithmetic is in the
// reference's f32 op order with explicit round-to-nearest intrinsics, so
// nvcc's default -fmad=true cannot contract `s1 - penalty*gap` into an
// FMA (the JAX code blocks that with abs(), ops/chain.py:181-186);
// coordinates are converted to f32 before any subtraction.  Equality
// tests use the 32-bit patterns, as the JAX int32 casts do.
#include "common.cuh"

namespace {

constexpr float kNeg = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

struct Anchor {
  unsigned qb, qe, qo, tb, te, to;
  bool valid;
};

__device__ __forceinline__ Anchor load_anchor(const long long* a,
                                              const bool* v, int i) {
  Anchor x;
  x.qb = (unsigned)a[i * 6 + 0];
  x.qe = (unsigned)a[i * 6 + 1];
  x.qo = (unsigned)a[i * 6 + 2];
  x.tb = (unsigned)a[i * 6 + 3];
  x.te = (unsigned)a[i * 6 + 4];
  x.to = (unsigned)a[i * 6 + 5];
  x.valid = v[i];
  return x;
}

__global__ void chain_fast_kernel(const long long* __restrict__ anchors,
                                  const bool* __restrict__ valid, int G,
                                  int N, float penalty, int pen_neg,
                                  float max_gap, int use_max_gap,
                                  int oriented, int W, int max_span,
                                  float* __restrict__ scores,
                                  int* __restrict__ prev,
                                  bool* __restrict__ dup_out,
                                  bool* __restrict__ inexact_out) {
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= G) return;  // uniform across the warp
  const bool in_win = lane < W;
  const unsigned win = W == 32 ? kFull : ((1u << W) - 1u);
  const unsigned below = (1u << lane) - 1u;  // lanes nearer than this one
  const long long* a = anchors + (long long)g * N * 6;
  const bool* v = valid + (long long)g * N;
  float* out_s = scores + (long long)g * N;
  int* out_p = prev + (long long)g * N;

  // window slot `lane` (slot 0 = most recent valid anchor)
  int w_idx = -1;
  float f_qe = 0.f, f_tb = 0.f, f_te = 0.f, w_score = kNeg;
  unsigned i_qb = kFull, i_qe = kFull, i_qo = kFull;
  int w_rel = 0;
  int nv = 0;
  bool dup = false, inexact = false;

  Anchor nxt = N > 0 ? load_anchor(a, v, 0) : Anchor{};
  for (int i = 0; i < N; ++i) {
    const Anchor x = nxt;
    if (i + 1 < N) nxt = load_anchor(a, v, i + 1);
    const float fqb = __uint2float_rn(x.qb), fqe = __uint2float_rn(x.qe);
    const float ftb = __uint2float_rn(x.tb), fte = __uint2float_rn(x.te);
    const float self_score = __fsub_rn(fqe, fqb);
    const int rel = (int)(x.qo ^ x.to);
    const bool so = x.qo == x.to;

    const bool occ = in_win && w_idx >= 0;
    const float gap_q = fabsf(__fsub_rn(fqb, f_qe));
    const float gap_t = so ? fabsf(__fsub_rn(ftb, f_te))
                           : fabsf(__fsub_rn(fte, f_tb));
    bool unf = occ;
    if (oriented) unf = unf && w_rel == rel;
    if (use_max_gap) unf = unf && gap_q <= max_gap && gap_t <= max_gap;
    const bool same_left = i_qb == x.qb && i_qe == x.qe && i_qo == x.qo;
    unf = unf && !same_left;

    // run starts: the slot's left differs from the nearer slot's
    const unsigned p_qb = __shfl_up_sync(kFull, i_qb, 1);
    const unsigned p_qe = __shfl_up_sync(kFull, i_qe, 1);
    const unsigned p_qo = __shfl_up_sync(kFull, i_qo, 1);
    const bool diff_prev =
        lane == 0 || p_qb != i_qb || p_qe != i_qe || p_qo != i_qo;
    const unsigned unf_m = __ballot_sync(kFull, unf) & win;
    bool is_new;
    if (oriented || use_max_gap) {
      // new iff no nearer slot of the same run is unfiltered
      const unsigned starts = __ballot_sync(kFull, diff_prev) & win;
      const unsigned upto = lane == 31 ? kFull : ((2u << lane) - 1u);
      const int rs = 31 - __clz(starts & upto);  // bit 0 is always set
      const unsigned run = below & ~((1u << rs) - 1u);
      is_new = unf && !(unf_m & run);
    } else {
      is_new = unf && diff_prev;
    }
    const unsigned new_m = __ballot_sync(kFull, is_new) & win;
    const bool scored = unf && __popc(new_m & below) < max_span;
    if (x.valid && nv > W && __popc(new_m) < max_span) inexact = true;

    // a same-left slot after a slot that is not: the run is broken
    const bool slc = same_left && occ;
    const unsigned slc_m = __ballot_sync(kFull, slc) & win;
    const bool nonconsec = (slc_m & (slc_m + 1u)) != 0u;
    const bool fulldup = __any_sync(
        kFull, slc && f_tb == ftb && f_te == fte && w_rel == rel);
    if (x.valid && (nonconsec || fulldup)) dup = true;

    // score in the reference's f32 op order, no contraction
    const float s1 = __fadd_rn(w_score, self_score);
    float gp = fabsf(__fmul_rn(penalty, __fadd_rn(gap_q, gap_t)));
    if (pen_neg) gp = -gp;
    const float cand = scored ? __fsub_rn(s1, gp) : kNeg;
    float best = cand;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      best = fmaxf(best, __shfl_xor_sync(kFull, best, d));
    int best_prev = scored && cand == best ? w_idx : -1;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      best_prev = max(best_prev, __shfl_xor_sync(kFull, best_prev, d));
    const bool use_prev = best > 0.f;
    float score_i = use_prev ? best : self_score;
    if (!x.valid) score_i = kNeg;
    if (lane == 0) {
      out_s[i] = score_i;
      out_p[i] = use_prev ? best_prev : -1;
    }

    if (x.valid) {  // push: slot d takes slot d-1, slot 0 the anchor
      const int s_idx = __shfl_up_sync(kFull, w_idx, 1);
      const float s_qe = __shfl_up_sync(kFull, f_qe, 1);
      const float s_tb = __shfl_up_sync(kFull, f_tb, 1);
      const float s_te = __shfl_up_sync(kFull, f_te, 1);
      const float s_sc = __shfl_up_sync(kFull, w_score, 1);
      const int s_rel = __shfl_up_sync(kFull, w_rel, 1);
      const bool first = lane == 0;
      w_idx = first ? i : s_idx;
      f_qe = first ? fqe : s_qe;
      f_tb = first ? ftb : s_tb;
      f_te = first ? fte : s_te;
      w_score = first ? score_i : s_sc;
      w_rel = first ? rel : s_rel;
      i_qb = first ? x.qb : p_qb;
      i_qe = first ? x.qe : p_qe;
      i_qo = first ? x.qo : p_qo;
      ++nv;
    }
  }
  if (lane == 0) {
    dup_out[g] = dup;
    inexact_out[g] = inexact;
  }
}

}  // namespace

// anchors (G, N, 6) int64 holding u32 values; valid (G, N) bool; outputs
// scores (G, N) float32, prev (G, N) int32, dup and inexact (G,) bool.
// max_gap is read only when use_max_gap; 1 <= W <= 32.
extern "C" int pgrtk_chain_scores_fast(const void* anchors, const void* valid,
                                       int G, int N, float penalty,
                                       float max_gap, int use_max_gap,
                                       int oriented, int W, int max_span,
                                       void* scores, void* prev, void* dup,
                                       void* inexact, void* stream) {
  if (G < 0 || N < 0 || W < 1 || W > 32) return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  const int threads = 128;  // 4 groups per block
  chain_fast_kernel<<<(unsigned)((G + 3) / 4), threads, 0,
                      (cudaStream_t)stream>>>(
      (const long long*)anchors, (const bool*)valid, G, N, penalty,
      penalty < 0.f ? 1 : 0, max_gap, use_max_gap, oriented, W, max_span,
      (float*)scores, (int*)prev, (bool*)dup, (bool*)inexact);
  return (int)cudaGetLastError();
}

// K10 chain_scores_dense: the chain DP exact under any duplicate anchors.
//
// Replaces pgrtk_tpu/ops/chain.py:63 chain_scores_dense, the rerun of the
// groups K8 flags `dup` (chain.py:738-756) and, with kernel="dense", the
// DP of every group.
//
// What bounds it on this card: the sequential dependence along a group,
// as K8, with O(W) warp shuffles per step for the pairwise distinct-left
// masks.
//
// Design: one warp per group, ring slot d in lane d (W <= 32).  It
// differs from K8 where the JAX scan differs:
//  - the window is a ring: anchor i goes to slot i % W, valid or not; an
//    invalid anchor occupies its slot with index -1 (never occupied,
//    never nearer than a slot that is);
//  - "nearer" is a comparison of the slots' anchor indices, and a slot is
//    new if no nearer unfiltered slot shares its left coordinate: each
//    lane builds, over the W lanes by shuffles, the masks of the lanes
//    nearer than it and of the lanes sharing its left; a ballot of the
//    new slots then gives each lane its count of nearer new slots;
//  - `inexact` tests the scan step (i > W), not the count of valid
//    anchors pushed;
//  - a full duplicate of the current anchor (all six coordinates equal,
//    occupied slot) takes the new score too (the reference's
//    value-keyed score map), besides slot i % W.
// Nearest wins score ties (largest anchor index among the best); f32 ops
// in the reference's order with round-to-nearest intrinsics, so nvcc
// cannot contract to an FMA; coordinates are converted to f32 before any
// subtraction; equality tests use the 32-bit patterns.
namespace {

__global__ void chain_dense_kernel(const long long* __restrict__ anchors,
                                   const bool* __restrict__ valid, int G,
                                   int N, float penalty, int pen_neg,
                                   float max_gap, int use_max_gap,
                                   int oriented, int W, int max_span,
                                   float* __restrict__ scores,
                                   int* __restrict__ prev,
                                   bool* __restrict__ inexact_out) {
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= G) return;  // uniform across the warp
  const bool in_win = lane < W;
  const unsigned win = W == 32 ? kFull : ((1u << W) - 1u);
  const long long* a = anchors + (long long)g * N * 6;
  const bool* v = valid + (long long)g * N;
  float* out_s = scores + (long long)g * N;
  int* out_p = prev + (long long)g * N;

  // ring slot `lane`
  int w_idx = -1;
  float f_qe = 0.f, f_tb = 0.f, f_te = 0.f, w_score = kNeg;
  unsigned i_qb = kFull, i_qe = kFull, i_qo = kFull;
  unsigned i_tb = kFull, i_te = kFull, i_to = kFull;
  int w_rel = 0;
  bool inexact = false;

  Anchor nxt = N > 0 ? load_anchor(a, v, 0) : Anchor{};
  for (int i = 0; i < N; ++i) {
    const Anchor x = nxt;
    if (i + 1 < N) nxt = load_anchor(a, v, i + 1);
    const float fqb = __uint2float_rn(x.qb), fqe = __uint2float_rn(x.qe);
    const float ftb = __uint2float_rn(x.tb), fte = __uint2float_rn(x.te);
    const float self_score = __fsub_rn(fqe, fqb);
    const int rel = (int)(x.qo ^ x.to);
    const bool so = x.qo == x.to;

    const bool occ = in_win && w_idx >= 0;
    const float gap_q = fabsf(__fsub_rn(fqb, f_qe));
    const float gap_t = so ? fabsf(__fsub_rn(ftb, f_te))
                           : fabsf(__fsub_rn(fte, f_tb));
    bool unf = occ;
    if (oriented) unf = unf && w_rel == rel;
    if (use_max_gap) unf = unf && gap_q <= max_gap && gap_t <= max_gap;
    const bool same_left = i_qb == x.qb && i_qe == x.qe && i_qo == x.qo;
    unf = unf && !same_left;
    const unsigned unf_m = __ballot_sync(kFull, unf) & win;

    // lanes nearer than this one, and lanes sharing this one's left
    unsigned nearer_m = 0u, left_m = 0u;
    for (int d = 0; d < W; ++d) {
      const int o_idx = __shfl_sync(kFull, w_idx, d);
      const unsigned o_qb = __shfl_sync(kFull, i_qb, d);
      const unsigned o_qe = __shfl_sync(kFull, i_qe, d);
      const unsigned o_qo = __shfl_sync(kFull, i_qo, d);
      if (o_idx > w_idx) nearer_m |= 1u << d;
      if (o_qb == i_qb && o_qe == i_qe && o_qo == i_qo) left_m |= 1u << d;
    }
    const bool is_new = unf && !(left_m & nearer_m & unf_m);
    const unsigned new_m = __ballot_sync(kFull, is_new) & win;
    const bool scored = unf && __popc(new_m & nearer_m) < max_span;
    if (x.valid && i > W && __popc(new_m) < max_span) inexact = true;

    // score in the reference's f32 op order, no contraction
    const float s1 = __fadd_rn(w_score, self_score);
    float gp = fabsf(__fmul_rn(penalty, __fadd_rn(gap_q, gap_t)));
    if (pen_neg) gp = -gp;
    const float cand = scored ? __fsub_rn(s1, gp) : kNeg;
    float best = cand;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      best = fmaxf(best, __shfl_xor_sync(kFull, best, d));
    int best_prev = scored && cand == best ? w_idx : -1;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      best_prev = max(best_prev, __shfl_xor_sync(kFull, best_prev, d));
    const bool use_prev = best > 0.f;
    float score_i = use_prev ? best : self_score;
    if (!x.valid) score_i = kNeg;
    if (lane == 0) {
      out_s[i] = score_i;
      out_p[i] = use_prev ? best_prev : -1;
    }

    // ring insertion; full duplicates take the new score too
    const bool dup = occ && x.valid && same_left && i_tb == x.tb &&
                     i_te == x.te && i_to == x.to;
    if (lane == i % W) {
      w_idx = x.valid ? i : -1;
      f_qe = fqe;
      f_tb = ftb;
      f_te = fte;
      i_qb = x.qb;
      i_qe = x.qe;
      i_qo = x.qo;
      i_tb = x.tb;
      i_te = x.te;
      i_to = x.to;
      w_rel = rel;
      w_score = score_i;
    } else if (dup) {
      w_score = score_i;
    }
  }
  if (lane == 0) inexact_out[g] = inexact;
}

}  // namespace

// anchors (G, N, 6) int64 holding u32 values; valid (G, N) bool; outputs
// scores (G, N) float32, prev (G, N) int32, inexact (G,) bool.  max_gap
// is read only when use_max_gap; 1 <= W <= 32.
extern "C" int pgrtk_chain_scores_dense(const void* anchors,
                                        const void* valid, int G, int N,
                                        float penalty, float max_gap,
                                        int use_max_gap, int oriented, int W,
                                        int max_span, void* scores,
                                        void* prev, void* inexact,
                                        void* stream) {
  if (G < 0 || N < 0 || W < 1 || W > 32) return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  const int threads = 128;  // 4 groups per block
  chain_dense_kernel<<<(unsigned)((G + 3) / 4), threads, 0,
                       (cudaStream_t)stream>>>(
      (const long long*)anchors, (const bool*)valid, G, N, penalty,
      penalty < 0.f ? 1 : 0, max_gap, use_max_gap, oriented, W, max_span,
      (float*)scores, (int*)prev, (bool*)inexact);
  return (int)cudaGetLastError();
}
