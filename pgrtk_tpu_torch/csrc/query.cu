// K6 dup_pair_counts and K7 expand_postings: the per-query count filters
// and the chain-lane placement of the end-to-end query step.
//
// K6 replaces pgrtk_tpu/ops/query_e2e.py:365 dup_pair_counts; K7
// replaces pgrtk_tpu/ops/query_e2e.py:430 expand_postings.
//
// K6.  What bounds it on this card: compares.  A row of Pc pair slots
// costs Pc^2 16-byte key compares (Pc = 192 at the bench step, a few
// thousand for long rows with blocked pair compaction), all from shared
// memory.  The JAX function sorted each row by key with lax.sort, found
// run lengths with log-shift segment propagation and sorted back; here
// one block of 256 threads takes 256 slots of a row, the row's masked
// keys stream through shared memory in 256-key tiles, and each thread
// counts the keys equal to its own.  No sort, no second pass; Pc is not
// capped.  Invalid slots carry the all-ones key, so they count the row's
// invalid slots, as the JAX all-ones segment does.
//
// K7.  What bounds it on this card: device memory.  Each thread reads
// three words of one postings slot and writes at most three lane
// entries; B*Pc*P threads (786k at the bench step).  The JAX function
// built a (B, Pc, P, C*M) one-hot and summed over P; here each selected
// hit is written straight to its lane (b*C + sid, p*M + m) of zero-filled
// planes.  The writes are atomic adds on the u32 bit patterns, so the
// result is the JAX sum in every case (a (sid, m) pair is unique per key
// row as build_index makes them, and then the add is a store).  The
// filtered-hit count is an integer atomic, the same in any order.
#include "common.cuh"

namespace {

constexpr int kTile = 256;

__global__ void dup_pair_counts_kernel(const long long* __restrict__ k0,
                                       const long long* __restrict__ k1,
                                       const bool* __restrict__ valid,
                                       int Pc, int row0,
                                       int* __restrict__ out) {
  __shared__ long long s0[kTile];
  __shared__ long long s1[kTile];
  const long long rb = ((long long)row0 + blockIdx.y) * Pc;
  const int p = blockIdx.x * kTile + threadIdx.x;
  long long m0 = -1, m1 = -1;
  if (p < Pc && valid[rb + p]) {
    m0 = k0[rb + p];
    m1 = k1[rb + p];
  }
  int cnt = 0;
  for (int t = 0; t < Pc; t += kTile) {
    const int q = t + threadIdx.x;
    long long a0 = -1, a1 = -1;
    if (q < Pc && valid[rb + q]) {
      a0 = k0[rb + q];
      a1 = k1[rb + q];
    }
    s0[threadIdx.x] = a0;
    s1[threadIdx.x] = a1;
    __syncthreads();
    const int n = min(kTile, Pc - t);
    for (int j = 0; j < n; ++j) cnt += (s0[j] == m0) & (s1[j] == m1);
    __syncthreads();
  }
  if (p < Pc) out[rb + p] = cnt;
}

constexpr unsigned kMetaEmpty = 0xffffffffu;

__global__ void expand_postings_kernel(
    const unsigned* __restrict__ rows, const bool* __restrict__ base_hit,
    const int* __restrict__ run_len, long long n, int Pc, int P, int C,
    int M, unsigned max_count_target, unsigned* __restrict__ t_bgnori,
    unsigned* __restrict__ t_end, bool* __restrict__ hv,
    bool* __restrict__ row_ovf, bool* __restrict__ grp_ovf,
    unsigned long long* __restrict__ n_t_filtered) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int j = (int)(i % P);
  const long long bp = i / P;  // b * Pc + p
  const int p = (int)(bp % Pc);
  const long long b = bp / Pc;
  if (!base_hit[bp]) return;
  const unsigned* row = rows + bp * 3 * P;
  const unsigned meta = row[j];
  if (meta == kMetaEmpty) return;
  if (j == 0 && (meta >> 31)) row_ovf[b] = true;
  const unsigned sid = meta & 0xfffffu;
  const unsigned m = (meta >> 20) & 0xfu;
  const unsigned mult = (meta >> 24) & 0x7fu;
  if (sid >= (unsigned)C) return;
  if ((unsigned)run_len[bp] * mult > max_count_target) {
    atomicAdd(n_t_filtered, 1ull);
    return;
  }
  const long long g = b * C + sid;
  if (m >= (unsigned)M) {
    grp_ovf[g] = true;
    return;
  }
  const long long lane = g * ((long long)Pc * M) + (long long)p * M + m;
  atomicAdd(t_bgnori + lane, row[P + j]);
  atomicAdd(t_end + lane, row[2 * P + j]);
  hv[lane] = true;
}

}  // namespace

// k0/k1 (B, Pc) int64, valid (B, Pc) bool -> out (B, Pc) int32.  Any B:
// rows go in tiles of kMaxGridY.
extern "C" int pgrtk_dup_pair_counts(const void* k0, const void* k1,
                                     const void* valid, int B, int Pc,
                                     void* out, void* stream) {
  if (B < 0 || Pc < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Pc == 0) return (int)cudaSuccess;
  for (int r0 = 0; r0 < B; r0 += pgrtk::kMaxGridY) {
    const int rows = B - r0 < pgrtk::kMaxGridY ? B - r0 : pgrtk::kMaxGridY;
    dup_pair_counts_kernel<<<dim3((unsigned)((Pc + kTile - 1) / kTile),
                                  (unsigned)rows),
                             kTile, 0, (cudaStream_t)stream>>>(
        (const long long*)k0, (const long long*)k1, (const bool*)valid, Pc,
        r0, (int*)out);
  }
  return (int)cudaGetLastError();
}

// rows (B, Pc, 3P) int32 [meta | bgnori | end]; base_hit (B, Pc) bool;
// run_len (B, Pc) int32.  Outputs, zeroed by the caller: t_bgnori and
// t_end (B, C, Pc, M) int32, hv (B, C, Pc, M) bool, row_ovf (B,) bool,
// grp_ovf (B, C) bool, n_t_filtered one uint64.
extern "C" int pgrtk_expand_postings(
    const void* rows, const void* base_hit, const void* run_len, int B,
    int Pc, int P, int C, int M, unsigned max_count_target, void* t_bgnori,
    void* t_end, void* hv, void* row_ovf, void* grp_ovf, void* n_t_filtered,
    void* stream) {
  if (B < 0 || Pc < 0 || P < 1 || C < 0 || M < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * Pc * P;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  expand_postings_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                           0, (cudaStream_t)stream>>>(
      (const unsigned*)rows, (const bool*)base_hit, (const int*)run_len, n,
      Pc, P, C, M, max_count_target, (unsigned*)t_bgnori, (unsigned*)t_end,
      (bool*)hv, (bool*)row_ovf, (bool*)grp_ovf,
      (unsigned long long*)n_t_filtered);
  return (int)cudaGetLastError();
}
