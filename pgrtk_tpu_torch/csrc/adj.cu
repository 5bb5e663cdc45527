// K12: a stable LSD radix sort of int64 key planes, then one pass that
// gathers the payload planes into sorted order and, for the MAP-graph
// rows, sets the link flag.
//
// K12 replaces pgrtk_tpu/ops/adj.py:20 _device_sort_and_link (a
// lax.sort on 8 u32 keys: sid, bgn, end, the 56-bit hashes h0 and h1 as
// hi/lo words, ori; then a shift-compare for the links) and, as the
// engine of sort_pairs, pgrtk_tpu/ops/pairs.py:349 sort_pairs (a
// lax.sort on 6 u32 keys: k0 and k1 as hi/lo words, sid, bgn).
//
// What bounds it on this card: device memory.  The least work reads
// each input plane once and writes each output once; a radix sort reads
// and writes the (key, index) pair once per 8-bit digit pass.  The design
// cuts the passes instead of the bytes per pass:
//   1. one kernel histograms every digit position of every key plane in
//      a single read of the planes (a global digit histogram does not
//      depend on the order), and flags values wider than the plane's bit
//      width (the port raises instead of truncating);
//   2. the host reads the histograms once, with one stream sync, and
//      skips every pass whose digit falls in a single bucket (the top
//      bytes of sid, bgn and end, the hashes' top byte, a constant ori);
//   3. each pass that remains counts digits per tile of 2,048 entries in
//      shared memory, scans the (digit, tile) counts (one block per
//      digit, the digit's base from the histogram), and scatters stably:
//      within a tile, entries of equal digit keep index order (warp
//      __match_any_sync and the popc of the lower lanes, per-warp counts
//      scanned in warp order, rounds of 256 entries in order).  Atomics
//      would not be stable, and LSD needs every pass stable;
//   4. the pass carries the key value with the index, so a plane's key
//      is gathered once through the permutation, not once per digit;
//   5. one elementwise pass gathers the payload planes and the mask and
//      computes link[i] = sid[i]==sid[i+1] & end[i]==bgn[i+1] & mask[i] &
//      mask[i+1] on the sorted rows.
// Offsets are 64-bit throughout; the tile grid is one-dimensional.
#include "common.cuh"

namespace {

typedef unsigned long long u64;
typedef long long i64;

constexpr int kThreads = 256;          // one thread per digit value
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int kTile = kThreads * kRounds;
constexpr int kMaxKeys = 8;
constexpr int kMaxPlanes = 8;
constexpr int kDigits = 8;             // 8-bit digits of a 64-bit key

struct Keys {
  const u64* key[kMaxKeys];
  int bits[kMaxKeys];
};

struct Planes {
  const i64* in[kMaxPlanes];
  i64* out[kMaxPlanes];
  int n;
};

__global__ void histogram_kernel(Keys ks, i64 n, u64* __restrict__ hist,
                                 u64* __restrict__ wide) {
  __shared__ unsigned h[kDigits * 256];
  const int j = blockIdx.y;
  for (int t = threadIdx.x; t < kDigits * 256; t += blockDim.x) h[t] = 0;
  __syncthreads();
  const u64* key = ks.key[j];
  const int bits = ks.bits[j];
  const int nd = (bits + 7) / 8;
  bool bad = false;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    const u64 v = key[i];
    if (bits < 64 && (v >> bits) != 0) bad = true;
    for (int d = 0; d < nd; ++d) atomicAdd(&h[d * 256 + ((v >> (8 * d)) & 255)], 1u);
  }
  if (bad) atomicOr(wide, 1ull << j);
  __syncthreads();
  for (int t = threadIdx.x; t < nd * 256; t += blockDim.x)
    if (h[t]) atomicAdd(&hist[(u64)j * kDigits * 256 + t], (u64)h[t]);
}

__global__ void gather_key_kernel(const u64* __restrict__ plane,
                                  const i64* __restrict__ perm, i64 n,
                                  u64* __restrict__ out) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = plane[perm[i]];
}

__global__ void count_kernel(const u64* __restrict__ key, i64 n, int shift,
                             i64 n_tiles, int* __restrict__ counts) {
  __shared__ int h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  const i64 tile0 = (i64)blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const i64 i = tile0 + r * kThreads + threadIdx.x;
    if (i < n) atomicAdd(&h[(key[i] >> shift) & 255], 1);
  }
  __syncthreads();
  counts[(i64)threadIdx.x * n_tiles + blockIdx.x] = h[threadIdx.x];
}

// One block per digit value: offs[d][t] = (entries of smaller digits) +
// (entries of digit d in tiles before t).
__global__ void scan_kernel(const int* __restrict__ counts, i64 n_tiles,
                            const u64* __restrict__ digit_hist,
                            i64* __restrict__ offs) {
  __shared__ int warp_sums[32];
  __shared__ i64 base_s;
  const int d = blockIdx.x;
  if (threadIdx.x == 0) {
    i64 b = 0;
    for (int e = 0; e < d; ++e) b += (i64)digit_hist[e];
    base_s = b;
  }
  __syncthreads();
  i64 run = base_s;
  const i64 row = (i64)d * n_tiles;
  for (i64 c = 0; c < n_tiles; c += blockDim.x) {
    const i64 t = c + threadIdx.x;
    const int v = t < n_tiles ? counts[row + t] : 0;
    int total;
    const int ex = pgrtk::block_exclusive_scan(v, &total, warp_sums);
    if (t < n_tiles) offs[row + t] = run + ex;
    run += total;
  }
}

// Stable scatter of (key, index) by the digit at `shift`.  perm == null
// stands for the identity.
__global__ void scatter_kernel(const u64* __restrict__ key,
                               const i64* __restrict__ perm, i64 n, int shift,
                               const i64* __restrict__ offs, i64 n_tiles,
                               u64* __restrict__ key_out,
                               i64* __restrict__ perm_out) {
  __shared__ i64 base[256];
  __shared__ int wcnt[kWarps][256];
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  base[tid] = offs[(i64)tid * n_tiles + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) wcnt[w][tid] = 0;
  __syncthreads();
  const i64 tile0 = (i64)blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const i64 i = tile0 + r * kThreads + tid;
    const bool ok = i < n;
    u64 v = 0;
    i64 p = 0;
    unsigned dig = 256u;  // a group of its own for the ragged tail
    if (ok) {
      v = key[i];
      p = perm ? perm[i] : i;
      dig = (unsigned)((v >> shift) & 255);
    }
    const unsigned peers = __match_any_sync(full, dig);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (ok && lane == __ffs(peers) - 1) wcnt[warp][dig] = __popc(peers);
    __syncthreads();
    // thread tid owns digit tid: exclusive scan of its counts over warps
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w][tid];
      wcnt[w][tid] = run;
      run += c;
    }
    __syncthreads();
    if (ok) {
      const i64 pos = base[dig] + wcnt[warp][dig] + rank;
      key_out[pos] = v;
      perm_out[pos] = p;
    }
    __syncthreads();
    base[tid] += run;
    for (int w = 0; w < kWarps; ++w) wcnt[w][tid] = 0;
    __syncthreads();
  }
}

// out[j][i] = in[j][perm[i]] for every plane, mask_out[i] = mask[perm[i]],
// and (link != null) the link flag of sorted row i to row i + 1 from
// planes 0 (sid), 1 (bgn), 2 (end) and the mask.
__global__ void gather_link_kernel(Planes pl, const i64* __restrict__ perm,
                                   i64 n, const bool* __restrict__ mask,
                                   bool* __restrict__ mask_out,
                                   bool* __restrict__ link) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 p = perm ? perm[i] : i;
  for (int j = 0; j < pl.n; ++j) pl.out[j][i] = pl.in[j][p];
  if (mask_out) mask_out[i] = mask[p];
  if (link && i + 1 < n) {
    const i64 q = perm ? perm[i + 1] : i + 1;
    link[i] = pl.in[0][p] == pl.in[0][q] && pl.in[2][p] == pl.in[1][q] &&
              mask[p] && mask[q];
  }
}

i64 tiles(i64 n) { return (n + kTile - 1) / kTile; }

size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

// Scratch layout: key and index buffers A and B (n each), the (digit,
// tile) counts and offsets, the digit histograms, the wide-value flags.
struct Scratch {
  u64 *ka, *kb;
  i64 *pa, *pb;
  int* counts;
  i64* offs;
  u64* hist;
  u64* wide;
};

size_t scratch_layout(i64 n, char* base, Scratch* s) {
  const i64 t = tiles(n);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  char* ka = take(8 * (size_t)n);
  char* kb = take(8 * (size_t)n);
  char* pa = take(8 * (size_t)n);
  char* pb = take(8 * (size_t)n);
  char* counts = take(4 * 256 * (size_t)t);
  char* offs = take(8 * 256 * (size_t)t);
  char* hist = take(8 * (size_t)kMaxKeys * kDigits * 256);
  char* wide = take(8);
  if (s) {
    s->ka = (u64*)ka;
    s->kb = (u64*)kb;
    s->pa = (i64*)pa;
    s->pb = (i64*)pb;
    s->counts = (int*)counts;
    s->offs = (i64*)offs;
    s->hist = (u64*)hist;
    s->wide = (u64*)wide;
  }
  return off;
}

// The engine.  keys: n_keys int64 planes, most significant first, with
// their bit widths; planes: n_planes payload planes gathered into sorted
// order (outs); mask (bool, may be null) gathered into mask_out and read
// by the link pass when link != null.  host: (2 + kMaxKeys*kDigits*256)
// uint64 of host memory: [0] the planes holding values wider than their
// bit width (bit j for key j; nothing is sorted then), [1] the digit
// passes run, then the digit histograms.
int radix_sort_gather(const void* const* keys, const int* bits, int n_keys,
                      i64 n, const void* const* planes, void* const* outs,
                      int n_planes, const void* mask, void* mask_out,
                      void* link, void* scratch, void* host, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  u64* hh = (u64*)host;
  if (n_keys < 1 || n_keys > kMaxKeys || n_planes < 0 ||
      n_planes > kMaxPlanes || n < 0 || (link && (n_planes < 3 || !mask)))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < n_keys; ++j)
    if (bits[j] < 1 || bits[j] > 64) return (int)cudaErrorInvalidValue;
  for (size_t t = 0; t < 2 + (size_t)kMaxKeys * kDigits * 256; ++t) hh[t] = 0;
  if (n == 0) return (int)cudaSuccess;
  Scratch s;
  scratch_layout(n, (char*)scratch, &s);
  const i64 n_tiles = tiles(n);
  const int ew_blocks = (int)((n + kThreads - 1) / kThreads);

  Keys ks;
  for (int j = 0; j < n_keys; ++j) {
    ks.key[j] = (const u64*)keys[j];
    ks.bits[j] = bits[j];
  }
  cudaMemsetAsync(s.hist, 0, 8 * (size_t)kMaxKeys * kDigits * 256, st);
  cudaMemsetAsync(s.wide, 0, 8, st);
  const i64 hb = (n + kThreads - 1) / kThreads;
  histogram_kernel<<<dim3((unsigned)(hb < 1024 ? hb : 1024), n_keys),
                     kThreads, 0, st>>>(ks, n, s.hist, s.wide);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaMemcpyAsync(hh + 2, s.hist, 8 * (size_t)kMaxKeys * kDigits * 256,
                  cudaMemcpyDeviceToHost, st);
  cudaMemcpyAsync(hh, s.wide, 8, cudaMemcpyDeviceToHost, st);
  err = cudaStreamSynchronize(st);
  if (err != cudaSuccess) return (int)err;
  if (hh[0]) return (int)cudaSuccess;

  // (key, index) of the current order: cur (null index = identity)
  const u64* kcur = nullptr;
  const i64* pcur = nullptr;
  bool in_a = false;  // the current order lives in buffers A
  u64 passes = 0;
  for (int j = n_keys - 1; j >= 0; --j) {
    const u64* h = hh + 2 + (size_t)j * kDigits * 256;
    bool gathered = false;
    for (int d = 0; d < (bits[j] + 7) / 8; ++d) {
      const u64* hd = h + (size_t)d * 256;
      bool single = false;
      for (int b = 0; b < 256; ++b) single |= hd[b] == (u64)n;
      if (single) continue;
      if (!gathered) {
        if (pcur == nullptr) {
          kcur = ks.key[j];
        } else {
          u64* kdst = in_a ? s.ka : s.kb;
          gather_key_kernel<<<ew_blocks, kThreads, 0, st>>>(
              ks.key[j], pcur, n, kdst);
          kcur = kdst;
        }
        gathered = true;
      }
      count_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(
          kcur, n, 8 * d, n_tiles, s.counts);
      scan_kernel<<<256, 1024, 0, st>>>(
          s.counts, n_tiles, s.hist + ((size_t)j * kDigits + d) * 256,
          s.offs);
      u64* kout = in_a ? s.kb : s.ka;
      i64* pout = in_a ? s.pb : s.pa;
      scatter_kernel<<<(unsigned)n_tiles, kThreads, 0, st>>>(
          kcur, pcur, n, 8 * d, s.offs, n_tiles, kout, pout);
      kcur = kout;
      pcur = pout;
      in_a = !in_a;
      ++passes;
    }
  }
  hh[1] = passes;

  Planes pl;
  pl.n = n_planes;
  for (int j = 0; j < n_planes; ++j) {
    pl.in[j] = (const i64*)planes[j];
    pl.out[j] = (i64*)outs[j];
  }
  gather_link_kernel<<<ew_blocks, kThreads, 0, st>>>(
      pl, pcur, n, (const bool*)mask, (bool*)mask_out, (bool*)link);
  return (int)cudaGetLastError();
}

}  // namespace

// The engine for the other kernels' sorts (shard.cu's K14).
int pgrtk::radix_engine(const void* const* keys, const int* bits, int n_keys,
                        long long n, const void* const* planes,
                        void* const* outs, int n_planes, const void* mask,
                        void* mask_out, void* link, void* scratch, void* host,
                        void* stream) {
  return radix_sort_gather(keys, bits, n_keys, n, planes, outs, n_planes,
                           mask, mask_out, link, scratch, host, stream);
}

extern "C" long long pgrtk_radix_scratch_bytes(long long n) {
  return (long long)scratch_layout(n, nullptr, nullptr);
}

// The MAP-graph rows: keys = payload = (sid, bgn, end, h0, h1, ori);
// mask (N,) bool; outs the 6 sorted planes; link (N-1,) bool.
extern "C" int pgrtk_sort_link_rows(const void* const* keys, const int* bits,
                                    int n_keys, long long n,
                                    const void* const* planes,
                                    void* const* outs, int n_planes,
                                    const void* mask, void* mask_out,
                                    void* link, void* scratch, void* host,
                                    void* stream) {
  return radix_sort_gather(keys, bits, n_keys, n, planes, outs, n_planes,
                           mask, mask_out, link, scratch, host, stream);
}

// The pair table: keys (k0, k1, sid, bgn) with invalid entries' keys at
// INT64_MAX; payload the 6 table planes; mask = valid; no link.
extern "C" int pgrtk_sort_pairs(const void* const* keys, const int* bits,
                                int n_keys, long long n,
                                const void* const* planes, void* const* outs,
                                int n_planes, const void* mask,
                                void* mask_out, void* link, void* scratch,
                                void* host, void* stream) {
  return radix_sort_gather(keys, bits, n_keys, n, planes, outs, n_planes,
                           mask, mask_out, link, scratch, host, stream);
}
