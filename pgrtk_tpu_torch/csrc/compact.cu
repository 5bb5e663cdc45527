// K2 rank_extract: blockwise order-preserving stream compaction.
//
// Replaces pgrtk_tpu/ops/pairs.py:23 _rank_extract_planes (reached via
// _rank_extract :63, compact_mers_packed :79 and the level-2 step of
// sketch_compact_mode2, ops/sketch.py:360).
//
// What bounds it on this card: device memory.  Each entry is read once
// (its mask byte plus 8 bytes per plane) and the kept entries written
// once; there is no arithmetic to speak of.  So the design keeps many
// independent loads in flight and no block-wide barrier on the way:
//   - one warp takes one `block`-wide segment at a time (a grid-stride
//     loop over the (row, segment) pairs; the grid is sized to the SMs,
//     a block holds as many warps as its shared memory allows);
//   - the warp walks its segment in windows of 512 entries, 16 a lane:
//     each lane reads its 16 mask bytes as one 16-byte vector (windows
//     are aligned to the mask's 16-byte words; a word that would cross
//     the mask's ends is read byte by byte), the in-segment ranks come
//     from 16 warp ballots (one per byte position) and their popc,
//     added to a running count;
//   - the planes' entries of the window are copied into shared memory
//     with cp.async, double-buffered: the next window's copies (the next
//     segment's once this one ends) are in flight while this one is
//     ranked;
//   - the kept entries' window offsets go into a per-warp slot map, and
//     the lanes then write slots run + 0, 1, 2, ... from shared memory:
//     each slot row, kept entries and zero fill alike, is written as
//     contiguous runs.
// Slots past the segment's count are zero-filled, as the JAX masked sums
// leave them.  A segment holding more than `slots` entries raises the
// overflow flag.  Any block >= 1 works (segments of a few thousand
// entries in the query step), W need not be a multiple of block, and any
// number of rows (the grid is one-dimensional).
#include "common.cuh"

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kWindow = 512;  // entries a warp ranks at once, 16 a lane
constexpr int kMaxWarps = 8;
constexpr int kSmemBudget = 200 * 1024;

struct Planes {
  const int64_t* in[kMaxPlanes];
  int64_t* out[kMaxPlanes];
};

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// bit i = byte i of a word of bools (each 0 or 1)
__device__ __forceinline__ unsigned byte_bits(unsigned w) {
  return (w & 1u) | ((w >> 7) & 2u) | ((w >> 14) & 4u) | ((w >> 21) & 8u);
}

// A warp's place in its work: segment g (flat over rows and segments),
// its entries [S, E) of the flat (B, W) arrays, the window start w0.
struct Cursor {
  long long g, S, E, w0;
};

struct Geometry {
  long long G, W, nb;
  int block;
  int lead;  // the mask pointer's offset in its 16-byte word

  __device__ Cursor at(long long g) const {
    Cursor c;
    c.g = g;
    if (g >= G) return c;
    const long long b = g / nb, seg = g % nb;
    c.S = b * W + seg * block;
    c.E = c.S + min((long long)block, W - seg * block);
    c.w0 = c.S - ((lead + c.S) & 15);
    return c;
  }
};

__global__ void rank_extract_kernel(Planes pl, int n_planes,
                                    const bool* __restrict__ valid,
                                    Geometry geo, int slots,
                                    bool* __restrict__ valid_out,
                                    int* __restrict__ flag) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  // per warp: two windows of the planes, then the slot map
  int64_t* stage =
      (int64_t*)smem + (size_t)warp * 2 * n_planes * kWindow;
  unsigned short* map =
      (unsigned short*)((int64_t*)smem + (size_t)warps * 2 * n_planes *
                                             kWindow) +
      warp * kWindow;
  const long long total_entries = geo.G / geo.nb * geo.W;
  const long long stride = (long long)gridDim.x * warps;

  auto issue = [&](const Cursor& c, int buf) {
    if (c.g >= geo.G) return;
    int64_t* dst = stage + (size_t)buf * n_planes * kWindow;
#pragma unroll 4
    for (int i = 0; i < kWindow / 32; ++i) {
      const int o = 32 * i + lane;
      const long long e = c.w0 + o;
      if (e >= c.S && e < c.E)
        for (int p = 0; p < n_planes; ++p)
          cp_async8(dst + p * kWindow + o, pl.in[p] + e);
    }
  };
  auto advance = [&](const Cursor& c) {
    if (c.w0 + kWindow < c.E) {
      Cursor n = c;
      n.w0 += kWindow;
      return n;
    }
    return geo.at(c.g + stride);
  };

  Cursor cur = geo.at((long long)blockIdx.x * warps + warp);
  issue(cur, 0);
  cp_async_commit();
  int buf = 0;
  int run = 0;  // valid entries of the segment before this window
  while (cur.g < geo.G) {
    const Cursor nxt = advance(cur);
    issue(nxt, buf ^ 1);
    cp_async_commit();

    // this lane's 16 entries [g0, g0 + 16): mask bits inside the segment
    const long long g0 = cur.w0 + 16 * lane;
    const long long lo = max(g0, cur.S), hi = min(g0 + 16, cur.E);
    unsigned bits = 0;
    if (lo < hi) {
      if (g0 >= 0 && g0 + 16 <= total_entries) {
        const uint4 v = *(const uint4*)(valid + g0);
        bits = byte_bits(v.x) | byte_bits(v.y) << 4 | byte_bits(v.z) << 8 |
               byte_bits(v.w) << 12;
      } else {
        for (int i = 0; i < 16; ++i) {
          const long long e = g0 + i;
          if (e >= 0 && e < total_entries && valid[e]) bits |= 1u << i;
        }
      }
      bits &= ((1u << (hi - g0)) - 1u) & ~((1u << (lo - g0)) - 1u);
    }
    // ranks by ballot: bit l of ballot i is entry 16 l + i, so the lower
    // lanes' valid entries are the popc of the ballots below this lane
    const unsigned lower = (1u << lane) - 1u;
    int before = 0, total = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const unsigned b = __ballot_sync(full, (bits >> i) & 1u);
      before += __popc(b & lower);
      total += __popc(b);
    }
    // the kept entries' window offsets, by slot
    int r = run + before;
    for (unsigned b = bits; b && r < slots; b &= b - 1, ++r)
      map[r - run] = (unsigned short)(16 * lane + __ffs(b) - 1);
    cp_async_wait_prior();
    __syncwarp();
    const int kept = max(0, min(total, slots - run));
    const long long obase = cur.g * (long long)slots;
    const int64_t* src = stage + (size_t)buf * n_planes * kWindow;
    for (int j = lane; j < kept; j += 32) {
      const int m = map[j];
      for (int p = 0; p < n_planes; ++p)
        pl.out[p][obase + run + j] = src[p * kWindow + m];
    }
    run += total;
    __syncwarp();  // the map and this window's stage are free again
    if (nxt.g != cur.g) {  // the segment's last window: its slot row
      for (int s = lane; s < slots; s += 32) valid_out[obase + s] = s < run;
      const int z0 = min(run, slots);
      for (int p = 0; p < n_planes; ++p)
        for (int s = z0 + lane; s < slots; s += 32) pl.out[p][obase + s] = 0;
      if (lane == 0 && run > slots) atomicOr(flag, 1);
      run = 0;
    }
    cur = nxt;
    buf ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

}  // namespace

// planes_in/planes_out: host arrays of n_planes device pointers to
// (B, W) and (B, ceil(W/block)*slots) int64 planes; valid (B, W) bool;
// valid_out (B, ceil(W/block)*slots) bool; flag one int32 zeroed by the
// caller.  Any block >= 1 and any B.
extern "C" int pgrtk_rank_extract(const void* const* planes_in,
                                  void* const* planes_out, int n_planes,
                                  const void* valid, int B, long long W,
                                  int block, int slots, void* valid_out,
                                  void* flag, void* stream) {
  if (n_planes < 0 || n_planes > kMaxPlanes || block < 1 || slots < 0)
    return (int)cudaErrorInvalidValue;
  const long long nb = (W + block - 1) / block;
  if (B == 0 || nb == 0) return (int)cudaSuccess;
  Planes pl = {};
  for (int p = 0; p < n_planes; ++p) {
    pl.in[p] = (const int64_t*)planes_in[p];
    pl.out[p] = (int64_t*)planes_out[p];
  }
  const Geometry geo{(long long)B * nb, W, nb, block,
                     (int)((size_t)valid & 15)};
  const int per_warp = 2 * n_planes * kWindow * 8 + kWindow * 2;
  int warps = kSmemBudget / per_warp;
  warps = warps < 1 ? 1 : warps > kMaxWarps ? kMaxWarps : warps;
  const int smem = warps * per_warp;
  const long long need = (geo.G + warps - 1) / warps;
  const int per_sm = 232448 / smem;  // blocks whose shared memory fits
  const long long cap = (long long)pgrtk::sm_count() *
                        (per_sm > 1 ? per_sm : 1);
  const unsigned grid = (unsigned)(need < cap ? need : cap);
  const cudaError_t err = pgrtk::allow_smem(rank_extract_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rank_extract_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      pl, n_planes, (const bool*)valid, geo, slots, (bool*)valid_out,
      (int*)flag);
  return (int)cudaGetLastError();
}
