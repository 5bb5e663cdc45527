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
#include "walk.cuh"

namespace pgrtk {
namespace {

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
    Regs s = {0, 0, 0, 0};

    if (exact) {
      s = exact_start(ex, lane, b * nc, k);
    } else {
      int seen = 0;
      for (long long p = start > overlap ? start - overlap : 0; p < start;
           ++p) {
        const int c = base_code(row[p]);
        seen += c < 4;
        push(s, c, mask, top);
      }
      if (start > 0 && seen < k) atomicOr(&flags[1], 1);
    }

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
// zeroed by the caller: [0] overflow, [1] inexact.
extern "C" int pgrtk_sketch_walk_compact(
    const void* seqs, const void* lengths, int B, long long L, int k, int r,
    int chunk, int slots, int overlap, int exact, void* scratch, void* out_x,
    void* out_y, void* out_valid, void* flags, void* stream) {
  const int nc = (int)(L / chunk);
  const long long n_lanes = (long long)B * nc;
  if (n_lanes == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = 64;
  const unsigned blocks = (unsigned)((n_lanes + threads - 1) / threads);
  pgrtk::ExactScratch ex = {};
  if (exact) {
    ex = pgrtk::carve_exact(scratch, B, nc);
    pgrtk::exact_warmup((const uint8_t*)seqs, B, L, nc, k, chunk, ex, st);
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
