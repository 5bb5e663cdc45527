// K8 chain_scores_fast: sparse anchor-chain DP over many groups.  K10
// chain_scores_dense, the variant exact under duplicate anchors, is at
// the end of the file.
//
// Replaces pgrtk_tpu/ops/chain.py:252 chain_scores_fast (the reference's
// serial DP, aln.rs:12-142, with a W-anchor recency window).
//
// What bounds it on this card: the latency of each step's dependent chain.
// Anchor i's score needs anchor i-1's, so a group is N dependent steps
// (N = 576 at the bench step); the data (48 bytes per anchor in, 8 out) is
// small.  The card gets parallelism only across groups (G = 1024 at the
// bench step: one warp each, two warps per scheduler), so a step costs the
// latency of its chain of votes, popcounts and reductions, not the issue
// of its instructions.  The first design spent ~880 cycles a step: a
// global load one step ahead, two five-level shuffle trees, two scalar
// stores and the window's nine-register shift, every step.
//
// Design: one warp per group, one window slot per lane (W <= 32).
//  - Staging: each group's anchors come in 32 at a time, one anchor a lane
//    (three 16-byte loads), a chunk ahead of the walk.  Each lane converts
//    its anchor once (u32 -> f32, self score, relative orientation) into
//    shared memory; a step reads its anchor there (two broadcast 16-byte
//    loads), so no global load sits on the chain.
//  - A ring window: the k-th valid anchor goes to lane (-k) mod 32 and no
//    other lane moves; lane l holds recency d = (l - h) mod 32, h the lane
//    of the newest anchor.  The JAX scan's recency order lives in masks:
//    a ballot in lane order is rotated by h where order matters.  The run
//    starts (a slot whose left coordinates differ from the nearer slot's)
//    are one warp-uniform mask in recency order that a push shifts; what a
//    lane derives from them (nearer slots, its run, its start bit) is
//    recomputed only on a push.  Invalid anchors leave the window as it
//    is, so their steps push nothing.
//  - The best score is one __reduce_max_sync (redux.sync) on an order-
//    preserving int32 image of the f32 candidate (the bits, negative ones
//    with the magnitude flipped): -3e38 stays below every score and the
//    image is positive exactly when the float is > +0, so `best > 0` and
//    the best value itself come from the image; +0 and -0 differ there but
//    never reach an output (a best of zero takes the self score and prev
//    -1).  Nearest wins the ties: the winners' largest anchor index is a
//    second redux.
//  - A two-stage software pipeline: a step's best is settled in the next
//    step, after that step's filters (its score enters the pushed slot,
//    its prev's reduction is issued), and its prev is read a step later
//    still.  The filters need only the window's coordinates, so each
//    reduction's latency overlaps the next step's filters, and an invalid
//    step adds nothing to the score chain.
//  - Outputs: lane j keeps step j's score and prev of the chunk; the warp
//    stores 32 of each at once.
// Every warp vote is executed by all 32 lanes (no short circuit around
// one), and the candidate is computed on every lane and selected: a branch
// around it costs each step a convergence barrier.
//
// Arithmetic is in the reference's f32 op order with explicit
// round-to-nearest intrinsics, so nvcc's default -fmad=true cannot
// contract `s1 - penalty*gap` into an FMA (the JAX code blocks that with
// abs(), ops/chain.py:181-186); coordinates are converted to f32 before
// any subtraction.  Equality tests use the 32-bit patterns, as the JAX
// int32 casts do.
#include "common.cuh"

namespace {

constexpr float kNeg = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 32;       // anchors staged at a time, one a lane
constexpr int kWarpsPerBlock = 4;

// One staged anchor, in the three 16-byte rows a step reads.
struct __align__(16) StepHead {  // every step
  float fqb, ta, self;  // ta: t_bgn if the orientations agree, else t_end
  int rel;              // q_ori ^ t_ori (0: same orientation)
};
struct __align__(16) StepLeft {  // every step: the distinct-left test
  unsigned qb, qe, qo, pad;
};
struct __align__(16) StepPush {  // valid steps: the pushed slot
  float fqe, ftb, fte, pad;
};
struct Chunk {
  StepHead head[kChunk];
  StepLeft left[kChunk];
  StepPush push[kChunk];
};

// Order-preserving int32 image of a (non-NaN) float: signed compares of
// the images order the floats, and image > 0 iff the float is > +0.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ unsigned rotl(unsigned x, int s) {
  return __funnelshift_l(x, x, s);
}

__device__ __forceinline__ unsigned rotr(unsigned x, int s) {
  return __funnelshift_r(x, x, s);
}

// The six u32 coordinates of one anchor (int64 (6,) row) and its flag.
struct Raw {
  longlong2 a, b, c;
  bool valid;
};

__device__ __forceinline__ void fetch(const longlong2* __restrict__ rows,
                                      const bool* __restrict__ v, int i,
                                      int N, Raw& r) {
  if (i < N) {
    r.a = __ldg(rows + i * 3);
    r.b = __ldg(rows + i * 3 + 1);
    r.c = __ldg(rows + i * 3 + 2);
    r.valid = v[i];
  } else {
    r.a = r.b = r.c = make_longlong2(0, 0);
    r.valid = false;
  }
}

// Stage lane's anchor into the chunk; returns the chunk's valid mask.
__device__ __forceinline__ unsigned stage(const Raw& r, Chunk& ck,
                                          int lane) {
  const unsigned qb = (unsigned)r.a.x, qe = (unsigned)r.a.y;
  const unsigned qo = (unsigned)r.b.x, tb = (unsigned)r.b.y;
  const unsigned te = (unsigned)r.c.x, to = (unsigned)r.c.y;
  const float fqb = __uint2float_rn(qb), fqe = __uint2float_rn(qe);
  const float ftb = __uint2float_rn(tb), fte = __uint2float_rn(te);
  const int rel = (int)(qo ^ to);
  ck.head[lane] = StepHead{fqb, rel == 0 ? ftb : fte, __fsub_rn(fqe, fqb),
                           rel};
  ck.left[lane] = StepLeft{qb, qe, qo, 0u};
  ck.push[lane] = StepPush{fqe, ftb, fte, 0.f};
  return __ballot_sync(kFull, r.valid);
}

template <bool kOriented, bool kMaxGap>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    chain_fast_kernel(const long long* __restrict__ anchors,
                      const bool* __restrict__ valid, int G, int N,
                      float penalty, int pen_neg, float max_gap, int W,
                      int max_span, float* __restrict__ scores,
                      int* __restrict__ prev, bool* __restrict__ dup_out,
                      bool* __restrict__ inexact_out) {
  __shared__ Chunk chunks[kWarpsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x * kWarpsPerBlock + warp;
  const int lane = threadIdx.x & 31;
  if (g >= G) return;  // uniform across the warp
  Chunk& ck = chunks[warp];
  const longlong2* rows =
      reinterpret_cast<const longlong2*>(anchors + (long long)g * N * 6);
  const bool* v = valid + (long long)g * N;
  float* out_s = scores + (long long)g * N;
  int* out_p = prev + (long long)g * N;

  // this lane's ring slot
  int w_idx = -1;
  float f_qe = 0.f, f_tb = 0.f, f_te = 0.f, w_score = kNeg;
  unsigned i_qb = kFull, i_qe = kFull, i_qo = kFull;
  int w_rel = 0;
  // what the lane derives from the window on a push
  bool occ = false, is_start = false;
  unsigned nearer = 0u, run = 0u;  // lane-order masks
  // warp-uniform window state
  int h = 0, nv = 0;
  unsigned starts = 1u;  // recency order; slot 0 always starts a run
  unsigned s0_qb = kFull, s0_qe = kFull, s0_qo = kFull;  // newest left
  bool dup = false, inexact = false;

  Raw raw;
  fetch(rows, v, lane, N, raw);
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    __syncwarp();
    const unsigned vmask = stage(raw, ck, lane);
    __syncwarp();
    fetch(rows, v, c0 + kChunk + lane, N, raw);  // in flight meanwhile
    const int n = min(kChunk, N - c0);
    float my_s = kNeg;  // lane j: step j's outputs
    int my_p = -1;
    // A step's best is settled one step later (its score, the push's
    // slot score, its prev's reduction) and its prev one step after
    // that, so each reduction's latency overlaps the next step's filters.
    // p_*: the pending step; q_*: the prev reduction in flight.
    bool pend = false, q_pend = false, p_valid = false, q_use = false;
    int p_j = 0, p_h = 0, p_best = 0, p_key = 0, p_widx = -1;
    int q_j = 0, q_bp = -1;
    float p_self = 0.f;
    StepHead hd = ck.head[0];
    StepLeft lf = ck.left[0];
    for (int j = 0; j < n; ++j) {
      const bool x_valid = (vmask >> j) & 1u;
      // filters: the window's coordinates and the anchor only
      const float gap_q = fabsf(__fsub_rn(hd.fqb, f_qe));
      const float gap_t = fabsf(__fsub_rn(hd.ta, hd.rel == 0 ? f_te : f_tb));
      bool unf = occ;
      if (kOriented) unf = unf && w_rel == hd.rel;
      if (kMaxGap) unf = unf && gap_q <= max_gap && gap_t <= max_gap;
      const bool same_left = i_qb == lf.qb && i_qe == lf.qe && i_qo == lf.qo;
      unf = unf && !same_left;
      bool is_new;
      if (kOriented || kMaxGap) {
        // new iff no nearer slot of the same run is unfiltered (every
        // lane ballots: no short circuit around the vote)
        const unsigned unf_m = __ballot_sync(kFull, unf);
        is_new = unf && !(unf_m & run);
      } else {
        is_new = unf && is_start;
      }
      const unsigned new_m = __ballot_sync(kFull, is_new);
      const bool scored = unf && __popc(new_m & nearer) < max_span;
      float gp = fabsf(__fmul_rn(penalty, __fadd_rn(gap_q, gap_t)));
      if (pen_neg) gp = -gp;

      if (q_pend && lane == q_j) my_p = q_use ? q_bp : -1;
      q_pend = pend;
      if (pend) {  // settle the pending step
        const bool use = p_best > 0;
        const float sc = use ? __int_as_float(p_best) : p_self;
        if (p_valid && lane == p_h) w_score = sc;
        if (lane == p_j) my_s = p_valid ? sc : kNeg;
        // nearest wins: the largest anchor index among the best
        q_bp = __reduce_max_sync(kFull, p_key == p_best ? p_widx : -1);
        q_use = use;
        q_j = p_j;
      }

      // this step's candidates in the reference's f32 op order, no
      // contraction, and their best
      const float s1 = __fadd_rn(w_score, hd.self);
      // computed on every lane and selected: a branch around it costs the
      // step a convergence barrier
      const float s1_gp = __fsub_rn(s1, gp);
      const float cand = scored ? s1_gp : kNeg;
      p_key = order_key(cand);
      p_best = __reduce_max_sync(kFull, p_key);
      p_widx = w_idx;
      p_j = j;
      p_valid = x_valid;
      p_self = hd.self;
      pend = true;

      if (x_valid) {  // uniform: the anchor enters the window
        if (nv > W && __popc(new_m) < max_span) inexact = true;
        // a same-left slot after a slot that is not: the run is broken
        const bool slc = same_left && occ;
        const unsigned slc_r = rotr(__ballot_sync(kFull, slc), h);
        const StepPush ps = ck.push[j];
        const bool fulldup = __any_sync(
            kFull, slc && f_tb == ps.ftb && f_te == ps.fte && w_rel == hd.rel);
        if ((slc_r & (slc_r + 1u)) != 0u || fulldup) dup = true;

        const bool differs = lf.qb != s0_qb || lf.qe != s0_qe || lf.qo != s0_qo;
        starts = ((starts << 1) & ~3u) | (differs ? 3u : 1u);
        s0_qb = lf.qb;
        s0_qe = lf.qe;
        s0_qo = lf.qo;
        h = (h + 31) & 31;
        p_h = h;
        if (lane == h) {  // its score follows when the step settles
          w_idx = c0 + j;
          f_qe = ps.fqe;
          f_tb = ps.ftb;
          f_te = ps.fte;
          i_qb = lf.qb;
          i_qe = lf.qe;
          i_qo = lf.qo;
          w_rel = hd.rel;
        }
        ++nv;
        const int d = (lane - h) & 31;
        occ = d < W && d < nv;
        const unsigned nearer_r = (1u << d) - 1u;
        nearer = rotl(nearer_r, h);
        if (kOriented || kMaxGap) {
          const int rs = 31 - __clz(starts & ((2u << d) - 1u));
          run = rotl(nearer_r & ~((1u << rs) - 1u), h);
        } else {
          is_start = (starts >> d) & 1u;
        }
      }
      hd = ck.head[(j + 1) & (kChunk - 1)];  // the next step's anchor
      lf = ck.left[(j + 1) & (kChunk - 1)];
    }
    // drain: the chunk's last steps
    if (q_pend && lane == q_j) my_p = q_use ? q_bp : -1;
    if (pend) {
      const bool use = p_best > 0;
      const float sc = use ? __int_as_float(p_best) : p_self;
      if (p_valid && lane == p_h) w_score = sc;
      const int bp = __reduce_max_sync(kFull, p_key == p_best ? p_widx : -1);
      if (lane == p_j) {
        my_s = p_valid ? sc : kNeg;
        my_p = use ? bp : -1;
      }
    }
    if (lane < n) {
      out_s[c0 + lane] = my_s;
      out_p[c0 + lane] = my_p;
    }
  }
  if (lane == 0) {
    dup_out[g] = dup;
    inexact_out[g] = inexact;
  }
}

template <bool kOriented, bool kMaxGap>
void launch_fast(const void* anchors, const void* valid, int G, int N,
                 float penalty, float max_gap, int W, int max_span,
                 void* scores, void* prev, void* dup, void* inexact,
                 cudaStream_t stream) {
  chain_fast_kernel<kOriented, kMaxGap>
      <<<(unsigned)((G + kWarpsPerBlock - 1) / kWarpsPerBlock),
         kWarpsPerBlock * 32, 0, stream>>>(
          (const long long*)anchors, (const bool*)valid, G, N, penalty,
          penalty < 0.f ? 1 : 0, max_gap, W, max_span, (float*)scores,
          (int*)prev, (bool*)dup, (bool*)inexact);
}

}  // namespace

// anchors (G, N, 6) int64 holding u32 values, 16-byte aligned; valid
// (G, N) bool; outputs scores (G, N) float32, prev (G, N) int32, dup and
// inexact (G,) bool.  max_gap is read only when use_max_gap; 1 <= W <= 32.
extern "C" int pgrtk_chain_scores_fast(const void* anchors, const void* valid,
                                       int G, int N, float penalty,
                                       float max_gap, int use_max_gap,
                                       int oriented, int W, int max_span,
                                       void* scores, void* prev, void* dup,
                                       void* inexact, void* stream) {
  if (G < 0 || N < 0 || W < 1 || W > 32 || ((uintptr_t)anchors & 15))
    return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (oriented && use_max_gap)
    launch_fast<true, true>(anchors, valid, G, N, penalty, max_gap, W,
                            max_span, scores, prev, dup, inexact, st);
  else if (oriented)
    launch_fast<true, false>(anchors, valid, G, N, penalty, max_gap, W,
                             max_span, scores, prev, dup, inexact, st);
  else if (use_max_gap)
    launch_fast<false, true>(anchors, valid, G, N, penalty, max_gap, W,
                             max_span, scores, prev, dup, inexact, st);
  else
    launch_fast<false, false>(anchors, valid, G, N, penalty, max_gap, W,
                              max_span, scores, prev, dup, inexact, st);
  return (int)cudaGetLastError();
}

// K10 chain_scores_dense: the chain DP exact under any duplicate anchors.
//
// Replaces pgrtk_tpu/ops/chain.py:63 chain_scores_dense, the rerun of the
// groups K8 flags `dup` (chain.py:738-756) and, with kernel="dense", the
// DP of every group.
//
// What bounds it on this card: as K8, the latency of each step's
// dependent chain.  The work (filters and a candidate for each of W
// slots, 48 bytes in and 8 out an anchor) is small, and the card gets
// parallelism only across groups (G = 64 on the batch path): a step
// costs the latency of its votes, reductions and stores, not their issue.
// A step costs ~180 cycles (0.28 ms for 64 groups of 3,125 anchors, W =
// 32, on an H100 SXM at 1,980 MHz): three ballots, two redux.sync and the
// filters, with no loop over the slots and no global load on its chain.
//
// Design: one warp per group, ring slot s in lane s (W <= 32), one warp a
// block (at G = 64, 64 SMs each run one warp, which shares nothing; four
// warps a block would put four groups on one SM's schedulers, and the
// kernel's time is its slowest group's chain either way).  It keeps the
// JAX scan's semantics (ops/chain.py:89-243):
//  - the ring: anchor i goes to slot i % W, valid or not; an invalid
//    anchor occupies its slot with index -1, never nearer than a slot
//    that holds a valid one;
//  - masks kept across steps, not rebuilt: each lane holds the W-bit
//    masks of the slots nearer than it (larger anchor index) and of the
//    slots sharing its left coordinates.  Both change only where an
//    anchor enters slot e: every other lane sets its nearer bit e if the
//    anchor is valid and clears it if not, and sets its same-left bit e to
//    the step's same-left test; lane e's nearer mask becomes 0 (valid) or
//    the occupied mask (invalid), its same-left mask the step's ballot of
//    the test plus its own bit.  The empty start (left (-1, -1, -1) in
//    every slot) is all W bits, so a real left of 0xFFFFFFFF matches the
//    empty slots, as in the JAX init.  A slot is then new iff it is
//    unfiltered and no nearer unfiltered slot shares its left (a ballot
//    and two ANDs), and its count of nearer new slots is a popcount;
//  - staging as K8: each group's anchors come in 32 at a time, one a
//    lane, a chunk ahead, converted once (u32 -> f32, self score,
//    relative orientation) into shared memory, so no global load sits on
//    a step's chain;
//  - the best score is one __reduce_max_sync on K8's order-preserving
//    int32 image of the f32 candidate, its predecessor a second one (the
//    largest winning anchor index: the nearest wins ties), in K8's
//    two-stage pipeline: a step's best is settled in the next step, after
//    that step's filters, and its prev a step later still;
//  - a full duplicate (all six coordinates equal, occupied slot) takes the
//    new score when the step settles, as slot i % W does;
//  - `inexact` tests the scan step (i > W);
//  - outputs: lane j keeps step j's score and prev of the chunk; the warp
//    stores 32 of each at once.
// f32 ops in the reference's order with round-to-nearest intrinsics, so
// nvcc cannot contract to an FMA; coordinates are converted to f32 before
// any subtraction; equality tests use the 32-bit patterns.
namespace {

struct __align__(16) StepRight {  // the full-duplicate test
  unsigned tb, te, to, pad;
};
struct DenseChunk {
  Chunk c;
  StepRight right[kChunk];
};

template <bool kOriented, bool kMaxGap>
__global__ void __launch_bounds__(32)
    chain_dense_kernel(const long long* __restrict__ anchors,
                       const bool* __restrict__ valid, int N, float penalty,
                       int pen_neg, float max_gap, int W, int max_span,
                       float* __restrict__ scores, int* __restrict__ prev,
                       bool* __restrict__ inexact_out) {
  __shared__ DenseChunk ck;
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned win = W == 32 ? kFull : ((1u << W) - 1u);
  const longlong2* rows =
      reinterpret_cast<const longlong2*>(anchors + (long long)g * N * 6);
  const bool* v = valid + (long long)g * N;
  float* out_s = scores + (long long)g * N;
  int* out_p = prev + (long long)g * N;

  // ring slot `lane`; lanes >= W stay empty
  int w_idx = -1;
  float f_qe = 0.f, f_tb = 0.f, f_te = 0.f, w_score = kNeg;
  unsigned i_qb = kFull, i_qe = kFull, i_qo = kFull;
  unsigned i_tb = kFull, i_te = kFull, i_to = kFull;
  int w_rel = 0;
  unsigned nearer = 0u;  // slots whose anchor index is larger than this one's
  unsigned sleft = win;  // slots whose left coordinates equal this one's
  // warp-uniform: the slots holding a valid anchor, the next anchor's slot
  unsigned occ_m = 0u;
  int e = 0;
  bool inexact = false;

  Raw raw;
  fetch(rows, v, lane, N, raw);
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    __syncwarp();
    const unsigned vmask = stage(raw, ck.c, lane);
    ck.right[lane] = StepRight{(unsigned)raw.b.y, (unsigned)raw.c.x,
                               (unsigned)raw.c.y, 0u};
    __syncwarp();
    fetch(rows, v, c0 + kChunk + lane, N, raw);  // in flight meanwhile
    const int n = min(kChunk, N - c0);
    float my_s = kNeg;  // lane j: step j's outputs
    int my_p = -1;
    // p_*: the pending step; q_*: the prev reduction in flight
    bool pend = false, q_pend = false, p_valid = false, p_dup = false;
    bool q_use = false;
    int p_j = 0, p_e = 0, p_best = 0, p_key = 0, p_widx = -1;
    int q_j = 0, q_bp = -1;
    float p_self = 0.f;
    StepHead hd = ck.c.head[0];
    StepLeft lf = ck.c.left[0];
    for (int j = 0; j < n; ++j) {
      const bool x_valid = (vmask >> j) & 1u;
      // filters: the window's coordinates and masks and the anchor only
      const bool occ = w_idx >= 0;
      const float gap_q = fabsf(__fsub_rn(hd.fqb, f_qe));
      const float gap_t = fabsf(__fsub_rn(hd.ta, hd.rel == 0 ? f_te : f_tb));
      bool unf = occ;
      if (kOriented) unf = unf && w_rel == hd.rel;
      if (kMaxGap) unf = unf && gap_q <= max_gap && gap_t <= max_gap;
      const bool same_left = i_qb == lf.qb && i_qe == lf.qe && i_qo == lf.qo;
      unf = unf && !same_left;
      // every lane votes: no short circuit around a ballot
      const unsigned unf_m = __ballot_sync(kFull, unf);
      const bool is_new = unf && !(sleft & nearer & unf_m);
      const unsigned new_m = __ballot_sync(kFull, is_new);
      const bool scored = unf && __popc(new_m & nearer) < max_span;
      if (x_valid && c0 + j > W && __popc(new_m) < max_span) inexact = true;
      float gp = fabsf(__fmul_rn(penalty, __fadd_rn(gap_q, gap_t)));
      if (pen_neg) gp = -gp;
      const StepRight rt = ck.right[j];
      const bool dup = occ && x_valid && same_left && i_tb == rt.tb &&
                       i_te == rt.te && i_to == rt.to;
      const unsigned sl_m = __ballot_sync(kFull, same_left);

      if (q_pend && lane == q_j) my_p = q_use ? q_bp : -1;
      q_pend = pend;
      if (pend) {  // settle the pending step: its slot and its duplicates
        const bool use = p_best > 0;
        const float sc =
            p_valid ? (use ? __int_as_float(p_best) : p_self) : kNeg;
        if (lane == p_e || p_dup) w_score = sc;
        if (lane == p_j) my_s = sc;
        // nearest wins: the largest anchor index among the best
        q_bp = __reduce_max_sync(kFull, p_key == p_best ? p_widx : -1);
        q_use = use;
        q_j = p_j;
      }

      // this step's candidates in the reference's f32 op order, no
      // contraction, computed on every lane and selected, and their best
      const float s1 = __fadd_rn(w_score, hd.self);
      const float s1_gp = __fsub_rn(s1, gp);
      const float cand = scored ? s1_gp : kNeg;
      p_key = order_key(cand);
      p_best = __reduce_max_sync(kFull, p_key);
      p_widx = w_idx;
      p_j = j;
      p_e = e;
      p_valid = x_valid;
      p_dup = dup;
      p_self = hd.self;
      pend = true;

      // the anchor enters slot e, valid or not (its score follows when
      // the step settles), and the masks follow it
      const unsigned bit = 1u << e;
      occ_m = x_valid ? occ_m | bit : occ_m & ~bit;
      if (lane == e) {
        const StepPush ps = ck.c.push[j];
        w_idx = x_valid ? c0 + j : -1;
        f_qe = ps.fqe;
        f_tb = ps.ftb;
        f_te = ps.fte;
        i_qb = lf.qb;
        i_qe = lf.qe;
        i_qo = lf.qo;
        i_tb = rt.tb;
        i_te = rt.te;
        i_to = rt.to;
        w_rel = hd.rel;
        nearer = x_valid ? 0u : occ_m;
        sleft = (sl_m & win) | bit;
      } else {
        nearer = x_valid ? nearer | bit : nearer & ~bit;
        sleft = same_left ? sleft | bit : sleft & ~bit;
      }
      e = e + 1 == W ? 0 : e + 1;
      hd = ck.c.head[(j + 1) & (kChunk - 1)];  // the next step's anchor
      lf = ck.c.left[(j + 1) & (kChunk - 1)];
    }
    // drain: the chunk's last steps
    if (q_pend && lane == q_j) my_p = q_use ? q_bp : -1;
    if (pend) {
      const bool use = p_best > 0;
      const float sc = p_valid ? (use ? __int_as_float(p_best) : p_self) : kNeg;
      if (lane == p_e || p_dup) w_score = sc;
      const int bp = __reduce_max_sync(kFull, p_key == p_best ? p_widx : -1);
      if (lane == p_j) {
        my_s = sc;
        my_p = use ? bp : -1;
      }
    }
    if (lane < n) {
      out_s[c0 + lane] = my_s;
      out_p[c0 + lane] = my_p;
    }
  }
  if (lane == 0) inexact_out[g] = inexact;
}

template <bool kOriented, bool kMaxGap>
void launch_dense(const void* anchors, const void* valid, int G, int N,
                  float penalty, float max_gap, int W, int max_span,
                  void* scores, void* prev, void* inexact,
                  cudaStream_t stream) {
  chain_dense_kernel<kOriented, kMaxGap><<<(unsigned)G, 32, 0, stream>>>(
      (const long long*)anchors, (const bool*)valid, N, penalty,
      penalty < 0.f ? 1 : 0, max_gap, W, max_span, (float*)scores,
      (int*)prev, (bool*)inexact);
}

}  // namespace

// anchors (G, N, 6) int64 holding u32 values, 16-byte aligned; valid
// (G, N) bool; outputs scores (G, N) float32, prev (G, N) int32, inexact
// (G,) bool.  max_gap is read only when use_max_gap; 1 <= W <= 32.
extern "C" int pgrtk_chain_scores_dense(const void* anchors,
                                        const void* valid, int G, int N,
                                        float penalty, float max_gap,
                                        int use_max_gap, int oriented, int W,
                                        int max_span, void* scores,
                                        void* prev, void* inexact,
                                        void* stream) {
  if (G < 0 || N < 0 || W < 1 || W > 32 || ((uintptr_t)anchors & 15))
    return (int)cudaErrorInvalidValue;
  if (G == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (oriented && use_max_gap)
    launch_dense<true, true>(anchors, valid, G, N, penalty, max_gap, W,
                             max_span, scores, prev, inexact, st);
  else if (oriented)
    launch_dense<true, false>(anchors, valid, G, N, penalty, max_gap, W,
                              max_span, scores, prev, inexact, st);
  else if (use_max_gap)
    launch_dense<false, true>(anchors, valid, G, N, penalty, max_gap, W,
                              max_span, scores, prev, inexact, st);
  else
    launch_dense<false, false>(anchors, valid, G, N, penalty, max_gap, W,
                               max_span, scores, prev, inexact, st);
  return (int)cudaGetLastError();
}
