// K9 sketch_mode1: mode-1 (windowed-minimizer) SHIMMER emission planes.
//
// Replaces pgrtk_tpu/ops/sketch1.py:124 sketch_mode1_dense (with the
// exact register walk ops/sketch.py:169 _register_walk it calls); the
// compaction that follows (:215 _mode1_compacted) is K2 at block 512.
//
// What bounds it on this card: integer ALU in the walk (two 64-bit Wang
// hashes per base, as K1), then shared-memory traffic in the emission
// pass: this first version takes each window minimum and maximum by a
// loop over the window, about 2w 64-bit compares per base (w = 80 at the
// CLI default).  Device memory moves 1 byte in and 17 bytes out per base.
//
// Design, three steps in one entry point:
//  1. the exact warm-up of walk.cuh (chunk tails + row ranks), so every
//     512-base chunk lane knows its registers at its start;
//  2. mode1_walk_kernel: one thread per (row, chunk) lane walks its
//     chunk and writes x = hash << 8 | k and y = pos << 1 | strand for
//     every position (padding included, as the JAX walk does), a
//     per-position "have" byte (in the row, past k, not palindromic) and
//     the row's palindrome flag;
//  3. mode1_emit_kernel: one block per (row, 1024-position tile) loads
//     the masked keys hv (x where have, else all ones) of the tile with a
//     halo of w positions on each side into shared memory, computes for
//     the tile and the w-1 positions after it the trailing (w-1)-window
//     minimum W2, the A events and m = A ? min(W2, x) : 0, then for each
//     tile position the leading w-window maximum of m and the A/B
//     emission rule.  Keys compare as unsigned 64-bit (a signed compare
//     is wrong above 2^63); W2 is a minimum so ties need no position, the
//     expiry test is strict (<) and the B test is <=, as the reference's
//     rightmost-tie argmin reduces to.
#include "walk.cuh"

namespace pgrtk {
namespace {

constexpr int kTileP = 1024;   // positions per emission block
constexpr int kThreadsE = 256;
constexpr int kMaxW = 128;
constexpr uint64_t kInf = ~0ull;

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ uint64_t umax64(uint64_t a, uint64_t b) {
  return a < b ? b : a;
}

__global__ void mode1_walk_kernel(const uint8_t* __restrict__ seqs,
                                  const int64_t* __restrict__ lengths,
                                  long long n_lanes, long long L, int nc,
                                  int k, int chunk, ExactScratch ex,
                                  int64_t* __restrict__ out_x,
                                  int64_t* __restrict__ out_y,
                                  uint8_t* __restrict__ have,
                                  int* __restrict__ pal_flag) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const long long b = lane / nc;
  const long long start = (lane % nc) * (long long)chunk;
  const long long len = lengths[b];
  const uint8_t* row = seqs + b * L;
  const uint64_t mask = (1ull << k) - 1;
  const int top = k - 1;
  Regs s = exact_start(ex, lane, b * nc, k);
  bool pal_seen = false;
  for (long long p = start; p < start + chunk; ++p) {
    push(s, base_code(row[p]), mask, top);
    const bool pal = s.f0 == s.r0 && s.f1 == s.r1;
    const bool rev = s.r0 < s.f0;
    const uint64_t h = wang(rev ? s.r0 : s.f0) ^
                       wang((rev ? s.r1 : s.f1) ^ 0xAD12CF59ull);
    const long long o = b * L + p;
    out_x[o] = (int64_t)((h << 8) | (uint64_t)k);
    out_y[o] = (int64_t)((p << 1) | (long long)rev);
    const bool live = p < len && p >= k;
    have[o] = live && !pal;
    pal_seen |= live && pal;
  }
  if (pal_seen) atomicOr(&pal_flag[b], 1);
}

__global__ void __launch_bounds__(kThreadsE) mode1_emit_kernel(
    const int64_t* __restrict__ x, const uint8_t* __restrict__ have,
    const int64_t* __restrict__ lengths, long long L, int row0, int k,
    int w, bool* __restrict__ emitted) {
  // hv of positions [p0 - w, p0 + T + w); m, W2 and A of [p0, p0 + T + w - 1)
  __shared__ uint64_t hv[kTileP + 2 * kMaxW];
  __shared__ uint64_t mval[kTileP + kMaxW];
  __shared__ uint64_t w2s[kTileP];
  __shared__ bool as[kTileP];
  const long long b = (long long)row0 + blockIdx.y;
  const long long p0 = (long long)blockIdx.x * kTileP;
  const long long len = lengths[b];
  const long long t0 = min(len - w + k - 1, len - 1);
  const long long first_a = (long long)k + w - 1;
  const int64_t* xr = x + b * L;
  const uint8_t* hr = have + b * L;
  const int n_hv = kTileP + 2 * w;
  for (int s = threadIdx.x; s < n_hv; s += blockDim.x) {
    const long long p = p0 - w + s;
    hv[s] = (p >= 0 && p < L && hr[p]) ? (uint64_t)xr[p] : kInf;
  }
  __syncthreads();
  // hv of position p sits at hv[p - p0 + w]
  const int n_m = kTileP + w - 1;
  for (int i = threadIdx.x; i < n_m; i += blockDim.x) {
    const long long q = p0 + i;
    uint64_t w2 = kInf;  // min over [q-w+1, q-1]; +inf for q < w-1
    if (q >= w - 1)
      for (int d = 1; d < w; ++d) w2 = umin64(w2, hv[i + w - d]);
    const uint64_t hq = hv[i + w];
    const bool expire =
        q >= (long long)k + w && q <= t0 && hv[i] < w2;  // hv[i] = hv(q-w)
    const bool a = q < len &&
                   ((q == first_a && q <= max(t0, first_a)) || expire);
    mval[i] = a ? umin64(w2, hq) : 0ull;
    if (i < kTileP) {
      w2s[i] = w2;
      as[i] = a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileP; i += blockDim.x) {
    const long long p = p0 + i;
    if (p >= L) break;
    const uint64_t hp = hv[i + w];
    bool e = false;
    if (hp != kInf && p <= t0) {  // have(p): x is never all ones
      uint64_t m = 0;
      for (int d = 0; d < w; ++d) m = umax64(m, mval[i + d]);
      const bool a_emit = m != 0ull && m >= hp;
      const bool b_emit = hp <= w2s[i] && p >= (long long)w + k && !as[i];
      e = a_emit || b_emit;
    }
    emitted[b * L + p] = e;
  }
}

}  // namespace
}  // namespace pgrtk

// seqs (B, L) uint8 16-byte aligned, chunk % 16 == 0, L % chunk == 0;
// lengths (B,) int64; scratch of
// pgrtk_sketch_scratch_bytes(B, L, chunk, 1) + B*L bytes; outputs x, y
// (B, L) int64, emitted (B, L) bool, pal (B,) int32 zeroed by the caller.
// 2 <= w <= 128, 0 < k <= 56.
extern "C" int pgrtk_sketch_mode1(const void* seqs, const void* lengths,
                                  int B, long long L, int k, int w,
                                  int chunk, void* scratch, void* out_x,
                                  void* out_y, void* emitted, void* pal,
                                  void* stream) {
  namespace P = pgrtk;
  if (w < 2 || w > P::kMaxW || k < 1 || k > 56 || chunk < 16 ||
      chunk % 16 || L % chunk)
    return (int)cudaErrorInvalidValue;
  const int nc = (int)(L / chunk);
  const long long n_lanes = (long long)B * nc;
  if (n_lanes == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  P::ExactScratch ex = P::carve_exact(scratch, B, nc);
  uint8_t* have = (uint8_t*)scratch + P::exact_scratch_bytes(B, nc);
  P::exact_warmup((const uint8_t*)seqs, B, L, nc, k, chunk, ex, st);
  const int threads = 64;
  P::mode1_walk_kernel<<<(unsigned)((n_lanes + threads - 1) / threads),
                         threads, 0, st>>>(
      (const uint8_t*)seqs, (const int64_t*)lengths, n_lanes, L, nc, k,
      chunk, ex, (int64_t*)out_x, (int64_t*)out_y, have, (int*)pal);
  const unsigned tiles = (unsigned)((L + P::kTileP - 1) / P::kTileP);
  for (int r0 = 0; r0 < B; r0 += P::kMaxGridY) {
    const int rows = B - r0 < P::kMaxGridY ? B - r0 : P::kMaxGridY;
    P::mode1_emit_kernel<<<dim3(tiles, (unsigned)rows), P::kThreadsE, 0,
                           st>>>((const int64_t*)out_x, have,
                                 (const int64_t*)lengths, L, r0, k, w,
                                 (bool*)emitted);
  }
  return (int)cudaGetLastError();
}
