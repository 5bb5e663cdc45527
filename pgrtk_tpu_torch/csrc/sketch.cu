// K1 sketch_walk_compact: mode-2 SHIMMER sketch with fused level-1
// compaction.
//
// Replaces pgrtk_tpu/ops/sketch.py:253 _register_walk_overlap_compact
// (with encode_bases :60, _step_registers :91, _hash_cols :144 and
// ops/u64.py:148 wang_hash), entered through sketch_compact_mode2 :333.
// With exact=1 it also replaces the exact two-level scan _register_walk
// :169 behind sketch_mode2_dense(exact=True) :369.
//
// What bounds it on this card: integer ALU.  Each base costs two 64-bit
// Wang hashes plus four register shifts, about 60 64-bit operations,
// each two or more 32-bit instructions on Hopper; the input is one byte
// per base, so device memory is far from the limit.
//
// Design: one thread per (row, chunk) lane walks its chunk in order with
// the four k-mer registers as uint64_t in registers, reads its bytes 16
// at a time (uint4), and writes only its first `slots` selected mers.
// The dense per-base hash planes of the JAX scan never exist.  Lanes
// that start past the row's length exit at once.
//
// Warm-up, fast mode (exact=0): like the JAX overlap walk, the
// registers warm up over the `overlap` bases before the chunk; a live,
// non-first lane whose warm-up holds fewer than k ACGT bases raises the
// `inexact` flag (ops/sketch.py:271-278), and its mers may differ from
// the exact walk's.
// Warm-up, exact mode (exact=1): the registers at a lane's start depend
// only on the last k ACGT bases before it, and an N run can push those
// arbitrarily far back.  A lane that walked back base by base would pay
// for the whole run before it, so the work would grow with the square of
// the run.  Instead the lane folds in per-chunk tails found through the
// row ranks of the chunks holding ACGT (walk.cuh, shared with K9): at
// most k lookups, however long the N run.  Exact for any input; no flag.
//
// Dense mode (dense=1) replaces sketch_mode2_dense :369 with the overlap
// walk :210 (or, with exact=1, :169): the same lanes and warm-ups, but
// every lane walks its whole chunk, live or not, and writes every
// position's hash word, position word and selected flag into (B, L)
// planes, as the plain version's (ops/sketch.py::sketch_mode2_dense_plain)
// are.  The least time for that work: the compact walk's hashes and
// selection test at every base (95 instruction slots a base by its SASS)
// and about 7 more to make x, y and the flag, 1.6 ms at 268 Mbase,
// against 12 bytes of values a base (3.25 GB, 1.0 ms).  The kernel's own
// loop issues 117 slots a base with its staging and write-back, and
// writes 17 bytes a base (x and y as int64, a flag byte), 4.6 GB at 268
// Mbase.  A thread's positions are consecutive but its neighbours' lie a
// chunk away: written directly, a warp's store touches 32 lines, each
// partly, and the partly written lines overflow L2.  So the design:
//  - blocks of 64 lanes; each step of 16 positions a lane stages its 16
//    hash words (rows padded to 17 against bank conflicts) and two 16-bit
//    masks, the strands and the selected flags, in shared memory, and the
//    block writes the step back whole: x and y as 16-byte pairs (a warp
//    store covers four lanes' 128-byte runs; y is rebuilt from the
//    position and the strand bit), the flags as one 16-byte word a lane;
//  - the staging is double-buffered, so one barrier a step separates a
//    step's walk from its write-back, and the stores of one step drain
//    while the block walks the next;
//  - streaming stores (__stcs) for x and y: the planes are 90 times the
//    size of L2 and nothing here reads them back;
//  - each lane's first output entry (b * L + its chunk start) is computed
//    once, in shared memory, so the write-back divides nothing.
// So the stores, not the walk, bound it on the card: at every step each
// live lane writes one 128-byte line of x and one of y, 4 KB from its
// neighbours' lines, and HBM takes lines so scattered well below its
// rate (kernels/timing.py's dense part times the walk alone and the
// stores alone).  Wider blocks, a writer warp beside the walkers, longer steps
// or a skew between blocks leave the stores where they land, and so this
// bound in place.
#include "walk.cuh"

namespace pgrtk {
namespace {

// The registers at the start of a lane: the exact warm-up, or the
// `overlap` bases before the chunk, raising flags[1] (inexact) when a
// live, non-first lane's warm-up holds fewer than k ACGT bases.
__device__ __forceinline__ Regs lane_start(const uint8_t* row,
                                           long long start, bool live,
                                           long long lane, long long row0,
                                           int k, int overlap, int exact,
                                           const ExactScratch& ex,
                                           int* flags) {
  if (exact) return exact_start(ex, lane, row0, k);
  const uint64_t mask = (1ull << k) - 1;
  Regs s = {0, 0, 0, 0};
  int seen = 0;
  for (long long p = start > overlap ? start - overlap : 0; p < start; ++p) {
    const int c = base_code(row[p]);
    seen += c < 4;
    push(s, c, mask, k - 1);
  }
  if (live && start > 0 && seen < k) atomicOr(&flags[1], 1);
  return s;
}

constexpr int kDenseLanes = 64;  // lanes (threads) per dense-mode block

// Dense mode: every position of the lane's chunk, 16 at a time through a
// double-buffered stage in shared memory.
__global__ void __launch_bounds__(kDenseLanes) sketch_walk_dense_kernel(
    const uint8_t* __restrict__ seqs, const int64_t* __restrict__ lengths,
    long long n_lanes, long long L, int nc, int k, int r, int chunk,
    int overlap, int exact, ExactScratch ex, int64_t* __restrict__ out_x,
    int64_t* __restrict__ out_y, bool* __restrict__ out_sel,
    int* __restrict__ flags) {
  __shared__ int64_t sx[2][kDenseLanes][17];
  // per lane: strand bits (low 16) and selected bits (high 16)
  __shared__ uint32_t sbits[2][kDenseLanes];
  // per lane: its first output entry and its chunk's start in the row
  __shared__ long long soff[kDenseLanes], sstart[kDenseLanes];
  const int t = threadIdx.x;
  const long long lane0 = (long long)blockIdx.x * kDenseLanes;
  const long long lane = lane0 + t;
  const bool active = lane < n_lanes;  // the rest only help write back
  const int n_active = (int)min((long long)kDenseLanes, n_lanes - lane0);
  const long long b = active ? lane / nc : 0;
  const long long start = active ? (lane % nc) * (long long)chunk : 0;
  const long long len = active ? lengths[b] : 0;
  const uint8_t* row = seqs + b * L;
  soff[t] = b * L + start;
  sstart[t] = start;
  const uint64_t mask = (1ull << k) - 1;
  const uint64_t thr = (~0ull >> 4) >> r;
  const int top = k - 1;
  Regs s = {0, 0, 0, 0};
  if (active)
    s = lane_start(row, start, start < len, lane, b * nc, k, overlap, exact,
                   ex, flags);
  int buf = 0;
  for (int q = 0; q < chunk; q += 16, buf ^= 1) {
    if (active) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + start + q);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      uint32_t bits = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const long long p = start + q + i;
        push(s, base_code((words[i >> 2] >> (8 * (i & 3))) & 0xFFu), mask,
             top);
        const bool rev = s.r0 < s.f0;
        const uint64_t h = wang(rev ? s.r0 : s.f0) ^
                           wang((rev ? s.r1 : s.f1) ^ 0xAD12CF59ull);
        sx[buf][t][i] = (int64_t)((h << 8) | (uint64_t)k);
        const bool sel = p < len && p >= k &&
                         !(s.f0 == s.r0 && s.f1 == s.r1) && h < thr;
        bits |= ((uint32_t)rev << i) | ((uint32_t)sel << (16 + i));
      }
      sbits[buf][t] = bits;
    }
    __syncthreads();
    // x and y: pair e of the block's 64 x 8 is positions 2 (e % 8) and
    // 2 (e % 8) + 1 of lane e / 8
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = t + kDenseLanes * j;
      const int l = e >> 3, i = (e & 7) * 2;
      if (l < n_active) {
        const long long g = soff[l] + q + i;
        const long long p = sstart[l] + q + i;
        const uint32_t bits = sbits[buf][l];
        __stcs(reinterpret_cast<longlong2*>(out_x + g),
               make_longlong2(sx[buf][l][i], sx[buf][l][i + 1]));
        __stcs(reinterpret_cast<longlong2*>(out_y + g),
               make_longlong2((p << 1) | ((bits >> i) & 1),
                              ((p + 1) << 1) | ((bits >> (i + 1)) & 1)));
      }
    }
    // the selected flags: one 16-byte word a lane, each flag's bit spread
    // to the low bit of its byte (nibble * 0x00204081 & 0x01010101); a
    // plain store, since it fills half a 32-byte sector and an evict-first
    // one would leave L2 before the next step's half joins it
    if (t < n_active) {
      const uint32_t sel = sbits[buf][t] >> 16;
      uint32_t v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = (((sel >> (4 * c)) & 0xFu) * 0x00204081u) & 0x01010101u;
      *reinterpret_cast<uint4*>(out_sel + soff[t] + q) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

__global__ void sketch_walk_compact_kernel(
    const uint8_t* __restrict__ seqs, const int64_t* __restrict__ lengths,
    long long n_lanes, long long L, int nc, int k, int r, int chunk,
    int slots, int overlap, int exact, ExactScratch ex,
    int64_t* __restrict__ out_x, int64_t* __restrict__ out_y,
    bool* __restrict__ out_valid, int* __restrict__ flags) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const long long b = lane / nc;
  const long long start = (lane % nc) * (long long)chunk;
  const long long stop = min(start + (long long)chunk, (long long)lengths[b]);
  const uint8_t* row = seqs + b * L;
  int64_t* ox = out_x + lane * slots;
  int64_t* oy = out_y + lane * slots;
  bool* ov = out_valid + lane * slots;
  int cnt = 0;

  if (start < stop) {
    const uint64_t mask = (1ull << k) - 1;
    const uint64_t thr = (~0ull >> 4) >> r;
    const int top = k - 1;
    Regs s = lane_start(row, start, true, lane, b * nc, k, overlap, exact,
                        ex, flags);

    for (long long q = start; q < stop; q += 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + q);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const long long p = q + i;
        push(s, base_code((words[i >> 2] >> (8 * (i & 3))) & 0xFFu), mask,
             top);
        if (p >= stop || p < k) continue;
        if (s.f0 == s.r0 && s.f1 == s.r1) continue;  // palindromic k-mer
        const bool rev = s.r0 < s.f0;
        const uint64_t h = wang(rev ? s.r0 : s.f0) ^
                           wang((rev ? s.r1 : s.f1) ^ 0xAD12CF59ull);
        if (h < thr) {
          if (cnt < slots) {
            ox[cnt] = (int64_t)((h << 8) | (uint64_t)k);
            oy[cnt] = (int64_t)((p << 1) | (long long)rev);
          }
          ++cnt;
        }
      }
    }
  }
  for (int j = 0; j < slots; ++j) {
    const bool v = j < cnt;
    ov[j] = v;
    if (!v) {
      ox[j] = 0;
      oy[j] = 0;
    }
  }
  if (cnt > slots) atomicOr(&flags[0], 1);
}

}  // namespace
}  // namespace pgrtk

// Bytes of scratch pgrtk_sketch_walk_compact needs: 0 for the fast walk.
extern "C" long long pgrtk_sketch_scratch_bytes(int B, long long L,
                                                int chunk, int exact) {
  return exact ? pgrtk::exact_scratch_bytes(B, (int)(L / chunk)) : 0;
}

// seqs (B, L) uint8 16-byte aligned, L % chunk == 0, chunk % 16 == 0;
// lengths (B,) int64; scratch of pgrtk_sketch_scratch_bytes() bytes;
// out_x/out_y (B, L/chunk*slots) int64, out_valid bool; flags int32[2]
// zeroed by the caller: [0] overflow, [1] inexact.  With dense=1 (slots
// unused) out_x/out_y are (B, L) int64 and out_valid the (B, L) selected
// mask; flags[0] stays 0.
extern "C" int pgrtk_sketch_walk_compact(
    const void* seqs, const void* lengths, int B, long long L, int k, int r,
    int chunk, int slots, int overlap, int exact, int dense, void* scratch,
    void* out_x, void* out_y, void* out_valid, void* flags, void* stream) {
  const int nc = (int)(L / chunk);
  const long long n_lanes = (long long)B * nc;
  if (n_lanes == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  constexpr int threads = 64;
  const unsigned blocks = (unsigned)((n_lanes + threads - 1) / threads);
  pgrtk::ExactScratch ex = {};
  if (exact) {
    ex = pgrtk::carve_exact(scratch, B, nc);
    pgrtk::exact_warmup((const uint8_t*)seqs, B, L, nc, k, chunk, ex, st);
  }
  if (dense) {
    constexpr int lanes = pgrtk::kDenseLanes;
    pgrtk::sketch_walk_dense_kernel<<<
        (unsigned)((n_lanes + lanes - 1) / lanes), lanes, 0, st>>>(
        (const uint8_t*)seqs, (const int64_t*)lengths, n_lanes, L, nc, k, r,
        chunk, overlap, exact, ex, (int64_t*)out_x, (int64_t*)out_y,
        (bool*)out_valid, (int*)flags);
    return (int)cudaGetLastError();
  }
  pgrtk::sketch_walk_compact_kernel<<<blocks, threads, 0, st>>>(
      (const uint8_t*)seqs, (const int64_t*)lengths, n_lanes, L, nc, k, r,
      chunk, slots, overlap, exact, ex, (int64_t*)out_x, (int64_t*)out_y,
      (bool*)out_valid, (int*)flags);
  return (int)cudaGetLastError();
}

extern "C" const char* pgrtk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
