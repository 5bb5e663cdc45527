// K2 rank_extract: blockwise order-preserving stream compaction.
//
// Replaces pgrtk_tpu/ops/pairs.py:23 _rank_extract_planes (reached via
// _rank_extract :63, compact_mers_packed :79 and the level-2 step of
// sketch_compact_mode2, ops/sketch.py:360).
//
// What bounds it on this card: device memory.  Each entry is read once
// (its mask byte plus 8 bytes per plane) and the kept entries written
// once, with a block-wide scan in between; there is no arithmetic to
// speak of.
//
// Design: one thread block per (row, `block`-wide segment).  A block of
// up to 1024 threads takes the segment in runs of `per` consecutive
// entries, one run per thread (per = 1 for block <= 1024, so no segment
// width is refused: the query step compacts whole pair rows and lane
// planes of a few thousand entries).  Each thread counts the valid
// entries of its run, a block-wide exclusive scan of those counts gives
// the run's first rank, and the thread scatters its valid entries of
// rank < slots straight to slot `rank` of the segment's slot row, in
// order.  This replaces the TPU's one masked reduction per slot.  Slots
// past the segment's count are zero-filled, as the JAX masked sums leave
// them.  A segment holding more than `slots` entries raises the overflow
// flag.
#include "common.cuh"

namespace {

constexpr int kMaxPlanes = 8;

struct Planes {
  const int64_t* in[kMaxPlanes];
  int64_t* out[kMaxPlanes];
};

__global__ void rank_extract_kernel(Planes pl, int n_planes,
                                    const bool* __restrict__ valid,
                                    long long W, int nb, int block, int per,
                                    int slots, int row0,
                                    bool* __restrict__ valid_out,
                                    int* __restrict__ flag) {
  __shared__ int warp_sums[32];
  const long long b = (long long)row0 + blockIdx.y;
  const int seg = blockIdx.x;
  const long long seg0 = (long long)seg * block;
  const int first = (int)threadIdx.x * per;  // in-segment offset of the run
  // entries of this thread's run that lie inside the segment and the row
  int n = min(per, block - first);
  n = (int)min((long long)n, W - seg0 - first);
  n = max(n, 0);
  const bool* v = valid + b * W + seg0 + first;
  int cnt = 0;
  for (int e = 0; e < n; ++e) cnt += v[e] ? 1 : 0;
  int total;
  int rank = pgrtk::block_exclusive_scan(cnt, &total, warp_sums);
  const long long obase = (b * nb + seg) * (long long)slots;
  const long long src = b * W + seg0 + first;
  for (int e = 0; e < n && cnt > 0 && rank < slots; ++e) {
    if (!v[e]) continue;
    for (int p = 0; p < n_planes; ++p)
      pl.out[p][obase + rank] = pl.in[p][src + e];
    ++rank;
  }
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const bool ok = s < total;
    valid_out[obase + s] = ok;
    if (!ok) {
      for (int p = 0; p < n_planes; ++p) pl.out[p][obase + s] = 0;
    }
  }
  if (threadIdx.x == 0 && total > slots) atomicOr(flag, 1);
}

}  // namespace

// planes_in/planes_out: host arrays of n_planes device pointers to
// (B, W) and (B, ceil(W/block)*slots) int64 planes; valid (B, W) bool;
// valid_out (B, ceil(W/block)*slots) bool; flag one int32 zeroed by the
// caller.  Any block >= 1 and any B (rows go in tiles of kMaxGridY).
extern "C" int pgrtk_rank_extract(const void* const* planes_in,
                                  void* const* planes_out, int n_planes,
                                  const void* valid, int B, long long W,
                                  int block, int slots, void* valid_out,
                                  void* flag, void* stream) {
  if (n_planes < 0 || n_planes > kMaxPlanes || block < 1)
    return (int)cudaErrorInvalidValue;
  const long long nb = (W + block - 1) / block;
  if (B == 0 || nb == 0) return (int)cudaSuccess;
  Planes pl = {};
  for (int p = 0; p < n_planes; ++p) {
    pl.in[p] = (const int64_t*)planes_in[p];
    pl.out[p] = (int64_t*)planes_out[p];
  }
  const int threads = block >= 1024 ? 1024 : (block + 31) / 32 * 32;
  const int per = (block + threads - 1) / threads;
  for (int r0 = 0; r0 < B; r0 += pgrtk::kMaxGridY) {
    const int rows = B - r0 < pgrtk::kMaxGridY ? B - r0 : pgrtk::kMaxGridY;
    rank_extract_kernel<<<dim3((unsigned)nb, (unsigned)rows), threads, 0,
                          (cudaStream_t)stream>>>(
        pl, n_planes, (const bool*)valid, W, (int)nb, block, per, slots, r0,
        (bool*)valid_out, (int*)flag);
  }
  return (int)cudaGetLastError();
}
