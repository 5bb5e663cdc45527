// The register walk shared by the sketch kernels: base codes, the
// rolling k-mer registers, the Wang hash, and the exact warm-up of a
// chunk lane (the registers at its start, from the tails of the nearest
// chunks before it that hold ACGT bases).
//
// Used by K1 (sketch.cu, exact=1) and K9 (sketch1.cu), both with
// chunk % 16 == 0 and 16-byte aligned rows.  The warm-up:
// chunk_tail_kernel stores each chunk's last min(k, n) ACGT codes as
// forward registers (walking back from the chunk's end: about k bases
// outside N runs), and the row ranks of the chunks holding any ACGT base
// are taken (rank.cuh).  exact_start() then folds in the tails of the
// nearest such chunks before a lane, newest first, until it holds k
// codes or runs out: at most k lookups, however long an N run.  The
// reverse registers follow from the forward ones (bit i of f is bit
// k-1-i of r, complemented).
#pragma once

#include "rank.cuh"

namespace pgrtk {
// Internal linkage: each translation unit gets its own copy.
namespace {

// Scratch of the exact walk, carved from one byte buffer; (B, nc) each.
struct ExactScratch {
  uint64_t* tail0;  // last min(k, n) ACGT codes of the chunk, bit 0 of
  uint64_t* tail1;  //   the code in tail0, bit 1 in tail1, newest lowest
  int* tail_n;      // min(k, n), n = ACGT bases in the chunk
  bool* has;        // n > 0
  pgrtk::RankScratch rank;  // of `has`
};

ExactScratch carve_exact(void* scratch, int B, int nc) {
  const long long n = (long long)B * nc;
  char* p = (char*)scratch;
  ExactScratch e;
  e.tail0 = (uint64_t*)p;
  e.tail1 = e.tail0 + n;
  e.tail_n = (int*)(e.tail1 + n);
  e.rank = pgrtk::carve_rank(e.tail_n + n, B, nc);
  e.has = (bool*)(e.tail_n + n + pgrtk::rank_scratch_ints(B, nc));
  return e;
}

long long exact_scratch_bytes(int B, int nc) {
  const long long n = (long long)B * nc;
  return 20 * n + 4 * pgrtk::rank_scratch_ints(B, nc) + n;
}

struct Regs {
  uint64_t f0, f1, r0, r1;
};

// 2-bit base code, 4 for anything but ACGT/acgt or a raw code 0-3
// (reference table: shmmrutils.rs:426-436).
__device__ __forceinline__ int base_code(unsigned b) {
  if (b < 4) return (int)b;
  const unsigned u = b & 0xDFu;
  return u == 'A' ? 0 : u == 'C' ? 1 : u == 'G' ? 2 : u == 'T' ? 3 : 4;
}

// One base step of the rolling registers; a code >= 4 leaves them as
// they are (reference: shmmrutils.rs:459-476).
__device__ __forceinline__ void push(Regs& s, int c, uint64_t mask,
                                     int top) {
  if (c < 4) {
    const int rc = 3 ^ c;
    s.f0 = ((s.f0 << 1) | (uint64_t)(c & 1)) & mask;
    s.f1 = ((s.f1 << 1) | (uint64_t)((c >> 1) & 1)) & mask;
    s.r0 = (s.r0 >> 1) | ((uint64_t)(rc & 1) << top);
    s.r1 = (s.r1 >> 1) | ((uint64_t)((rc >> 1) & 1) << top);
  }
}

// Thomas Wang 64-bit hash (reference: shmmrutils.rs:271-280).
__device__ __forceinline__ uint64_t wang(uint64_t key) {
  key = (~key) + (key << 21);
  key = key ^ (key >> 24);
  key = (key + (key << 3)) + (key << 8);
  key = key ^ (key >> 14);
  key = (key + (key << 2)) + (key << 4);
  key = key ^ (key >> 28);
  key = key + (key << 31);
  return key;
}

__global__ void chunk_tail_kernel(const uint8_t* __restrict__ seqs,
                                  long long n_lanes, long long L, int nc,
                                  int k, int chunk, ExactScratch ex) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const long long start = (lane % nc) * (long long)chunk;
  const uint8_t* row = seqs + (lane / nc) * L;
  uint64_t f0 = 0, f1 = 0;
  int n = 0;
  // back from the chunk's end, 16 bases a load (chunk % 16 == 0 and the
  // rows 16-byte aligned): a lane's neighbours lie a chunk away, so a
  // warp's load touches 32 lines whatever its width
  for (long long q = start + chunk - 16; q >= start && n < k; q -= 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(row + q);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 15; i >= 0; --i) {
      const int c = base_code((words[i >> 2] >> (8 * (i & 3))) & 0xFFu);
      if (c < 4 && n < k) {
        f0 |= (uint64_t)(c & 1) << n;
        f1 |= (uint64_t)(c >> 1) << n;
        ++n;
      }
    }
  }
  ex.tail0[lane] = f0;
  ex.tail1[lane] = f1;
  ex.tail_n[lane] = n;
  ex.has[lane] = n > 0;
}

// The registers at the start of chunk lane `lane` of row b (lanes of a
// row are consecutive, row0 = b * nc): the last min(k, n) ACGT codes
// before it.
__device__ __forceinline__ Regs exact_start(const ExactScratch& ex,
                                            long long lane, long long row0,
                                            int k) {
  const uint64_t mask = (1ull << k) - 1;
  int q = ex.rank.rank_excl[lane];  // chunks before this one with ACGT
  int n = 0;
  uint64_t f0 = 0, f1 = 0;
  while (n < k && q > 0) {
    const long long j = row0 + ex.rank.vidx[row0 + --q];
    f0 |= ex.tail0[j] << n;
    f1 |= ex.tail1[j] << n;
    n += ex.tail_n[j];
  }
  const uint64_t nmask = (1ull << min(n, k)) - 1;
  Regs s;
  s.f0 = f0 & mask;
  s.f1 = f1 & mask;
  s.r0 = __brevll(~s.f0 & nmask) >> (64 - k);
  s.r1 = __brevll(~s.f1 & nmask) >> (64 - k);
  return s;
}

// The exact warm-up's scratch filled for a (B, L) batch of nc chunks per
// row: chunk tails, then the row ranks of the chunks with ACGT.
inline void exact_warmup(const uint8_t* seqs, int B, long long L, int nc,
                         int k, int chunk, const ExactScratch& ex,
                         cudaStream_t st) {
  const long long n_lanes = (long long)B * nc;
  const int threads = 64;
  const unsigned blocks = (unsigned)((n_lanes + threads - 1) / threads);
  chunk_tail_kernel<<<blocks, threads, 0, st>>>(seqs, n_lanes, L, nc, k,
                                                chunk, ex);
  row_rank(ex.has, B, nc, ex.rank, st);
}

}  // namespace
}  // namespace pgrtk
