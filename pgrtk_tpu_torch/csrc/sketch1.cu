// K9 sketch_mode1: mode-1 (windowed-minimizer) SHIMMER emission planes.
//
// Replaces pgrtk_tpu/ops/sketch1.py:124 sketch_mode1_dense (with the
// exact register walk ops/sketch.py:169 _register_walk it calls); the
// compaction that follows (:215 _mode1_compacted) is K2 at block 512.
//
// What bounds it on this card: integer ALU.  Each base costs the walk's
// two 64-bit Wang hashes (112 instruction slots a base by the SASS of the
// walk below, its staging to shared memory included; the function needs
// K1's compact walk's 95 and 7 to make x, y and the flag) and two sliding
// windows over 64-bit keys, a minimum and a maximum, whose scans, carries
// and compares issue about as much again (each 64-bit compare and select
// is four 32-bit instructions); device memory moves 1 byte in and 17
// bytes out per base (x and y as int64, the emitted byte), 0.04 ms at
// 8 Mbase, under the 0.06 ms of the operations.  At 8 x 1,048,576 bases, w = 80, the kernel takes 0.23 ms
// and the warm-up 0.02 ms on an H100 SXM (700 W), about half the integer
// issue rate: the blocks' barriers and the warm-up's dependent loads
// leave it idle for the rest.
//
// Design: one launch after the exact warm-up, one block per (row,
// 2,048-position tile), 160 threads.
//  - The exact warm-up of walk.cuh at 16-base lanes, whatever the caller's
//    chunk: every 16-aligned position gets its start registers from the
//    tails of the nearest 16-base chunks before it that hold ACGT bases.
//  - Walk: thread t walks the 16 positions s0 + 16t .. s0 + 16t + 15 of
//    the region [s0, s1) = the tile with a halo of roundup16(w) positions
//    before it and roundup16(w - 1) after it (at most 144 runs), from one
//    16-byte load.  x goes to shared memory (one pad word every 16, so a
//    warp's 16-strided stores hit 16 banks), with a have bit (in the row,
//    past k, not palindromic) and a strand bit per position.  The halo is
//    walked twice, by this block and its neighbour: 1.06-1.13x the walk.
//  - Windows: W2 (minimum over [q-w+1, q-1]) and M (maximum of m = A ?
//    min(W2, x) : 0 over [p, p+w-1]) by van Herk / Gil-Werman: the region
//    is cut into blocks of n (n = w - 1, then w) from s0, each position
//    gets its prefix G and suffix H within its block, and a window of n is
//    min(H[first], G[last]), two shared reads whatever w.  A thread scans
//    its 16 values in registers; the part of a block that lies in other
//    threads' runs comes from a segmented scan of the runs' aggregates
//    across the warp (five shuffle steps each way) and across warps (each
//    warp's 512 positions hold a block boundary, since n <= 128, so a
//    warp's last and first values are whole).  Per position and window:
//    one G and one H store and two loads, no loop over w.
//  - Emission: the A and B rules of the plain version, then one 16-byte
//    store of the run's emitted bytes; x and y of the tile leave in
//    16-byte streaming stores of neighbouring positions (y rebuilt from
//    the position and the strand bit).
// Keys compare as unsigned 64-bit (a signed compare is wrong above
// 2^63); W2 is a minimum and M a maximum of values only, so ties need no
// position; the expiry test is strict (<) and the B test is <=, as the
// reference's rightmost-tie argmin reduces to.
#include "walk.cuh"

namespace pgrtk {
namespace {

constexpr int kRun = 16;       // positions a thread walks: one 16-byte load
constexpr int kTileP = 2048;   // positions a block emits
constexpr int kMaxW = 128;
constexpr int kThreads = 160;  // whole warps, >= (kTileP + 2 kMaxW) / kRun
constexpr int kWarps = kThreads / 32;
constexpr int kPadded = kThreads * (kRun + 1);  // a pad word every run
constexpr uint64_t kInf = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

constexpr int smem_bytes() {
  return 3 * kPadded * 8 + 2 * kWarps * 8 + 2 * kThreads * 4;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

template <bool kMax>
__device__ __forceinline__ uint64_t op(uint64_t a, uint64_t b) {
  return kMax ? (a < b ? b : a) : (a < b ? a : b);
}

// Van Herk's prefix G and suffix H of the region's values within blocks
// of n (n <= kMaxW) cut from offset 0: thread t holds the values of
// offsets 16t .. 16t + 15 in v and writes G and H there.  `carry` is
// 2 * kWarps words of shared memory.  Every thread of the block calls it.
template <bool kMax>
__device__ __forceinline__ void van_herk(const uint64_t (&v)[kRun], int n,
                                         uint64_t* G, uint64_t* H,
                                         uint64_t* carry) {
  const uint64_t id = kMax ? 0ull : kInf;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t bnd = 0;  // block starts among the run's offsets
  int c = (t * kRun) % n;
#pragma unroll
  for (int d = 0; d < kRun; ++d) {
    bnd |= (uint32_t)(c == 0) << d;
    c = c + 1 == n ? 0 : c + 1;
  }
  // tail: the run's part of the block its last offset is in; head: the
  // run's part of the block that began before it (empty if none did)
  uint64_t tail = id, head = id;
#pragma unroll
  for (int d = 0; d < kRun; ++d) {
    tail = (bnd >> d) & 1 ? v[d] : op<kMax>(tail, v[d]);
    if (!(bnd & ((2u << d) - 1u))) head = op<kMax>(head, v[d]);
  }
  // segmented inclusive scans over the warp's runs: tails from the left,
  // heads from the right; a flag: a block starts in the runs covered
  uint64_t fwd = tail, bwd = head;
  int ff = bnd != 0, fb = bnd != 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint64_t pv = __shfl_up_sync(kFull, fwd, off);
    const int pf = __shfl_up_sync(kFull, ff, off);
    const uint64_t nv = __shfl_down_sync(kFull, bwd, off);
    const int nf = __shfl_down_sync(kFull, fb, off);
    if (lane >= off) {
      if (!ff) fwd = op<kMax>(pv, fwd);
      ff |= pf;
    }
    if (lane + off < 32) {
      if (!fb) bwd = op<kMax>(bwd, nv);
      fb |= nf;
    }
  }
  // a warp's 512 offsets hold a block start (n <= 128): its last lane's
  // forward value and its first lane's backward value are whole
  if (lane == 31) carry[warp] = fwd;
  if (lane == 0) carry[kWarps + warp] = bwd;
  __syncthreads();
  uint64_t cin = __shfl_up_sync(kFull, fwd, 1);
  int cinf = __shfl_up_sync(kFull, ff, 1);
  if (lane == 0) {
    cin = id;
    cinf = 0;
  }
  if (!cinf && warp > 0) cin = op<kMax>(carry[warp - 1], cin);
  uint64_t cout = __shfl_down_sync(kFull, bwd, 1);
  int coutf = __shfl_down_sync(kFull, fb, 1);
  if (lane == 31) {
    cout = id;
    coutf = 0;
  }
  if (!coutf && warp + 1 < kWarps)
    cout = op<kMax>(cout, carry[kWarps + warp + 1]);
  uint64_t run = cin;
#pragma unroll
  for (int d = 0; d < kRun; ++d) {
    run = (bnd >> d) & 1 ? v[d] : op<kMax>(run, v[d]);
    G[pad(t * kRun + d)] = run;
  }
  run = cout;
#pragma unroll
  for (int d = kRun - 1; d >= 0; --d) {
    run = op<kMax>(v[d], run);
    H[pad(t * kRun + d)] = run;
    if ((bnd >> d) & 1) run = id;
  }
}

__global__ void __launch_bounds__(kThreads) mode1_kernel(
    const uint8_t* __restrict__ seqs, const int64_t* __restrict__ lengths,
    long long L, int row0, int k, int w, ExactScratch ex,
    int64_t* __restrict__ out_x, int64_t* __restrict__ out_y,
    bool* __restrict__ emitted, int* __restrict__ pal_flag) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* xs = reinterpret_cast<uint64_t*>(smem);
  uint64_t* G = xs + kPadded;
  uint64_t* H = G + kPadded;
  uint64_t* carry = H + kPadded;  // 2 * kWarps
  uint32_t* have16 = reinterpret_cast<uint32_t*>(carry + 2 * kWarps);
  uint32_t* rev16 = have16 + kThreads;

  const int t = threadIdx.x;
  const long long b = (long long)row0 + blockIdx.y;
  const long long p0 = (long long)blockIdx.x * kTileP;
  const int hb = (w + 15) & ~15, ha = (w + 14) & ~15;  // halos
  const long long s0 = p0 - hb;
  const int n_runs = (hb + kTileP + ha) / kRun;
  const long long len = lengths[b];
  const long long t0 = min(len - w + k - 1, len - 1);
  const long long nc = L / kRun;  // 16-base warm-up lanes of a row
  const int i0 = t * kRun;        // this run's first offset
  const long long q0 = s0 + i0;   // and its position
  const bool in_tile = i0 >= hb && i0 < hb + kTileP && q0 < L;

  // walk
  uint64_t v[kRun];
  uint32_t have = 0, rev = 0;
  bool pal_seen = false;
  if (t < n_runs && q0 >= 0 && q0 < L) {
    const uint64_t mask = (1ull << k) - 1;
    const int top = k - 1;
    Regs s = exact_start(ex, b * nc + (q0 >> 4), b * nc, k);
    const uint4 wd = *reinterpret_cast<const uint4*>(seqs + b * L + q0);
    const uint32_t words[4] = {wd.x, wd.y, wd.z, wd.w};
#pragma unroll
    for (int d = 0; d < kRun; ++d) {
      push(s, base_code((words[d >> 2] >> (8 * (d & 3))) & 0xFFu), mask,
           top);
      const bool pal = s.f0 == s.r0 && s.f1 == s.r1;
      const bool r = s.r0 < s.f0;
      const uint64_t h = wang(r ? s.r0 : s.f0) ^
                         wang((r ? s.r1 : s.f1) ^ 0xAD12CF59ull);
      v[d] = (h << 8) | (uint64_t)k;
      const long long p = q0 + d;
      const bool live = p < len && p >= k;
      have |= (uint32_t)(live && !pal) << d;
      rev |= (uint32_t)r << d;
      pal_seen |= live && pal;
    }
  } else {
#pragma unroll
    for (int d = 0; d < kRun; ++d) v[d] = 0;
  }
#pragma unroll
  for (int d = 0; d < kRun; ++d) {
    xs[pad(i0 + d)] = v[d];
    v[d] = (have >> d) & 1 ? v[d] : kInf;  // hv: x where have, else +inf
  }
  have16[t] = have;
  rev16[t] = rev;
  if (__syncthreads_or(in_tile && pal_seen) && t == 0)
    atomicOr(&pal_flag[b], 1);

  // x and y of the tile, two neighbouring positions a thread and store
  const int n_out = (int)min((long long)kTileP, L - p0);
  for (int e = t; e < n_out / 2; e += kThreads) {
    const int i = hb + 2 * e;
    const long long p = p0 + 2 * e;
    const uint32_t r = rev16[i >> 4] >> (i & 15);
    __stcs(reinterpret_cast<longlong2*>(out_x + b * L + p),
           make_longlong2((long long)xs[pad(i)], (long long)xs[pad(i + 1)]));
    __stcs(reinterpret_cast<longlong2*>(out_y + b * L + p),
           make_longlong2((p << 1) | (r & 1), ((p + 1) << 1) | ((r >> 1) & 1)));
  }

  // W2 = min over [q-w+1, q-1] (+inf for q < w-1), the A events and m
  van_herk<false>(v, w - 1, G, H, carry);
  __syncthreads();
  uint64_t m[kRun];
  uint32_t b_emit = 0;
  const long long first_a = (long long)k + w - 1;
#pragma unroll
  for (int d = 0; d < kRun; ++d) {
    const int i = i0 + d;
    const long long q = q0 + d;
    m[d] = 0;
    if (t < n_runs && q >= p0) {
      const uint64_t w2 = q >= w - 1
                              ? op<false>(H[pad(i - w + 1)], G[pad(i - 1)])
                              : kInf;
      const int iw = i - w;  // hv(q - w)
      const uint64_t hw = (have16[iw >> 4] >> (iw & 15)) & 1 ? xs[pad(iw)]
                                                              : kInf;
      const bool expire = q >= (long long)k + w && q <= t0 && hw < w2;
      const bool a = q < len && (q == first_a || expire);
      m[d] = a ? op<false>(w2, v[d]) : 0ull;
      b_emit |= (uint32_t)(v[d] <= w2 && q >= (long long)w + k && !a) << d;
    }
  }

  // M = max of m over [p, p+w-1], and the emission rule
  van_herk<true>(m, w, G, H, carry);
  __syncthreads();
  if (in_tile) {
    uint32_t e_bits = 0;
#pragma unroll
    for (int d = 0; d < kRun; ++d) {
      const int i = i0 + d;
      if (v[d] != kInf && q0 + d <= t0) {  // have(p): x is never all ones
        const uint64_t M = op<true>(H[pad(i)], G[pad(i + w - 1)]);
        const bool a_emit = M != 0ull && M >= v[d];
        e_bits |= (uint32_t)(a_emit || ((b_emit >> d) & 1)) << d;
      }
    }
    uint32_t o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o[c] = (((e_bits >> (4 * c)) & 0xFu) * 0x00204081u) & 0x01010101u;
    *reinterpret_cast<uint4*>(emitted + b * L + q0) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace
}  // namespace pgrtk

// Bytes of scratch pgrtk_sketch_mode1 needs: the exact warm-up at
// 16-base lanes.
extern "C" long long pgrtk_sketch1_scratch_bytes(int B, long long L) {
  return pgrtk::exact_scratch_bytes(B, (int)(L / pgrtk::kRun));
}

// seqs (B, L) uint8 16-byte aligned, L % 16 == 0 (the kernel's lanes are
// 16 bases, whatever chunk the caller pads to); lengths (B,) int64;
// scratch of pgrtk_sketch1_scratch_bytes(B, L) bytes; outputs x, y (B, L)
// int64 16-byte aligned, emitted (B, L) bool, pal (B,) int32
// zeroed by the caller.  2 <= w <= 128, 0 < k <= 56.
extern "C" int pgrtk_sketch_mode1(const void* seqs, const void* lengths,
                                  int B, long long L, int k, int w,
                                  void* scratch, void* out_x,
                                  void* out_y, void* emitted, void* pal,
                                  void* stream) {
  namespace P = pgrtk;
  if (w < 2 || w > P::kMaxW || k < 1 || k > 56 || L % P::kRun ||
      ((uintptr_t)seqs & 15) ||
      ((uintptr_t)out_x & 15) || ((uintptr_t)out_y & 15) ||
      ((uintptr_t)emitted & 15))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * L == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nc = (int)(L / P::kRun);
  P::ExactScratch ex = P::carve_exact(scratch, B, nc);
  P::exact_warmup((const uint8_t*)seqs, B, L, nc, k, P::kRun, ex, st);
  constexpr int smem = P::smem_bytes();
  cudaError_t err = P::allow_smem(P::mode1_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((L + P::kTileP - 1) / P::kTileP);
  for (int r0 = 0; r0 < B; r0 += P::kMaxGridY) {
    const int rows = B - r0 < P::kMaxGridY ? B - r0 : P::kMaxGridY;
    P::mode1_kernel<<<dim3(tiles, (unsigned)rows), P::kThreads, smem, st>>>(
        (const uint8_t*)seqs, (const int64_t*)lengths, L, r0, k, w, ex,
        (int64_t*)out_x, (int64_t*)out_y, (bool*)emitted, (int*)pal);
  }
  return (int)cudaGetLastError();
}
