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
// What bounds it on this card: the latency of each digit pass more than
// bytes.  The least work reads each input plane once and writes each
// output once; an LSD radix sort moves the (key, index) pair once per
// 8-bit digit pass, 12 bytes an entry each way.  At the index step's
// 1.8M entries a pass moves ~42 MB, ~13 us at the memory rate, but takes
// 20-45 us on the H100: each tile's block runs a chain of dependent
// steps (its plan entry and tile id, the loads, the ranking, the
// look-back wait, the scattered stores), and removing either the
// look-back or the stores cuts a pass by ~40% (measured by ablation).
// So the design cuts launches, host waits and entries per pass:
//   1. one kernel histograms every digit position of every key plane in
//      a single read of the planes (a global digit histogram does not
//      depend on the order; the fill keys' kept entries apart, see 4),
//      and flags values wider than the plane's bit
//      width into the caller's device word (the port raises instead of
//      truncating; the caller reads the flag at a host read it makes
//      anyway);
//   2. the pass plan is made on the card: one block per (key, digit)
//      turns that digit's histogram into its bucket bases and marks it
//      constant when one bucket holds every entry (the top bytes of sid,
//      bgn and end, the hashes' top byte, a constant ori), or when a key
//      is wide; one thread then chains the passes that run through the
//      two (key, index) buffer sets.  The host issues every launch up
//      front and never waits: a constant digit's pass is a launch whose
//      blocks return at once;
//   3. each digit pass is one onesweep kernel (Adinets and Merrill,
//      2022): a block takes its tile of 4,096 entries from an atomic
//      counter, so tiles start in order; each warp stages its 512
//      entries with 16-byte loads through shared memory and reads them
//      back warp-striped, so lane order is entry order; equal digits are
//      ranked stably (__match_any_sync, the popc of the lower lanes, a
//      per-warp digit count kept by each group's leader); the tile's
//      per-digit counts are published by decoupled look-back (flag, pass
//      epoch and count in one 64-bit status word; each thread walks back
//      for its digit, eight predecessors per step); the tile is
//      reordered by digit in shared memory and each digit's run written
//      out contiguously.  Stability within a tile comes from the
//      ranking, across tiles from the in-order tile ids;
//   4. with fill keys (the pair tables' k0 and k1, INT64_MAX on invalid
//      entries, 64% of the index step's), a stable partition pass moves
//      the masked entries behind the kept ones after the other keys'
//      passes, and the fill keys' passes sort the kept prefix alone (the
//      masked tail is then in its final order); the histogram pass checks
//      the fill contract, and the plan takes the full route when it fails;
//   5. a pass carries the key with the index while later digits of the
//      same plane need it; the first pass of a plane gathers the key
//      through the current order itself, the last writes the index only;
//   6. one elementwise pass gathers the payload planes and the mask and
//      computes link[i] = sid[i]==sid[i+1] & end[i]==bgn[i+1] & mask[i] &
//      mask[i+1] on the sorted rows; it reads the order from the plan
//      (the kept head from the last pass's buffer set, the masked tail
//      from the partition's).
// Indices are 32-bit (n < 2^32), offsets 64-bit; the grids are
// one-dimensional.
#include "common.cuh"

namespace {

typedef unsigned long long u64;
typedef long long i64;
typedef unsigned u32;

constexpr int kThreads = 256;          // one thread per digit value
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;             // entries a thread ranks in a pass
constexpr int kWarpRun = 32 * kItems;  // a warp's 512 entries of a tile
constexpr int kTile = kThreads * kItems;
constexpr int kMaxKeys = 8;
constexpr int kMaxPlanes = 8;
constexpr int kDigits = 8;             // 8-bit digits of a 64-bit key
constexpr int kSlots = kMaxKeys * kDigits + 1;  // digit passes + partition
constexpr int kLookahead = 8;          // predecessors a look-back step reads
constexpr int kPassSmem = kTile * (8 + 4) + kWarps * 256 * 4;

// A tile's status word for one digit: [63:56] the pass epoch (slot + 1;
// the words are zeroed once per sort, so an older pass's word reads as
// not ready), [55:54] 1 = the tile's count, 2 = the inclusive prefix,
// [53:0] the value.
constexpr int kEpochShift = 56;
constexpr int kFlagShift = 54;
constexpr u64 kAggregate = 1ull << kFlagShift;
constexpr u64 kInclusive = 2ull << kFlagShift;
constexpr u64 kValueMask = (1ull << kFlagShift) - 1;

// Where a pass reads its (key, index) from.  The partition pass's key is
// the entry's mask bit (0 for a kept entry, 1 for a masked one).
enum Source : int {
  kIdentity = 0,  // the key plane in input order, index = position
  kGather = 1,    // the index from buffer set src, the key from the plane
  kCarried = 2,   // both from buffer set src
};

struct Keys {
  const u64* key[kMaxKeys];
  int bits[kMaxKeys];
};

// The (key, digit) pass slots in issue order: the least significant key
// first, within a key its digits from the lowest; with fill keys, the
// partition slot (key -1) between the other keys and the fill keys.
struct Slots {
  int key[kSlots];
  int digit[kSlots];
  int bits[kMaxKeys];
  int n;
  int fill_keys;
};

struct Pass {
  i64 n;          // entries the pass sorts: the kept prefix, or all
  int active;     // the digit is not constant and no key is wide
  int source;     // Source
  int src;        // buffer set read (kGather, kCarried)
  int dst;        // buffer set written
  int write_key;  // a later pass of the same plane reads the carried key
  i64 base[256];  // first sorted position of each digit value
};

struct Plan {
  Pass pass[kSlots];
  i64 n_head;     // sorted positions [0, n_head) read final_set's order,
  int final_set;  //   [n_head, n) tail_set's; -1 = the input order
  int tail_set;
};

// The partition route's counts: kept entries, the masked entries at
// each fill key's fill, and whether the fill contract fails (a masked
// entry whose fill key is not the width's maximum, or a kept entry whose
// first key is).
struct Route {
  u64 n_kept;
  u64 n_fill[kMaxKeys];
  u32 broken;
};

__host__ __device__ __forceinline__ u64 width_max(int bits) {
  return bits < 64 ? (1ull << bits) - 1 : ~0ull;
}

struct Planes {
  const i64* in[kMaxPlanes];
  i64* out[kMaxPlanes];
  int n;
};

struct Buffers {
  u64* key[2];
  u32* index[2];
};

// The digit histograms of the key planes: over all entries for the
// other keys (hist); for the fill keys, over the kept entries
// (hist_kept) and over the masked entries off the fill (hist, empty
// while the contract holds), the masked entries at the fill only
// counted (their digits are the fill's: no atomics on one hot bin).
// The wide flags; the partition route's counts.
__global__ void histogram_kernel(Keys ks, i64 n, int fill_keys,
                                 const bool* __restrict__ mask,
                                 u64* __restrict__ hist,
                                 u64* __restrict__ hist_kept,
                                 u64* __restrict__ wide,
                                 Route* __restrict__ route) {
  __shared__ unsigned h[kDigits * 256];
  __shared__ unsigned hk[kDigits * 256];
  __shared__ u64 block_counts[2];  // kept, masked at the fill
  const unsigned full = 0xffffffffu;
  const int j = blockIdx.y;
  const bool fill = j < fill_keys;
  for (int t = threadIdx.x; t < kDigits * 256; t += blockDim.x)
    h[t] = hk[t] = 0;
  if (threadIdx.x < 2) block_counts[threadIdx.x] = 0;
  __syncthreads();
  const u64* key = ks.key[j];
  const int bits = ks.bits[j];
  const int nd = (bits + 7) / 8;
  const u64 top = width_max(bits);
  unsigned* counted = fill ? hk : h;
  // a run of equal digits is counted in a register and added when the
  // digit changes: a constant digit's one hot bin takes one shared atomic
  // a thread, not one an entry
  unsigned run_bin[kDigits], run_len[kDigits];
#pragma unroll
  for (int d = 0; d < kDigits; ++d) run_bin[d] = run_len[d] = 0;
  bool bad = false;
  bool broken = false;
  unsigned kept = 0, at_fill = 0;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (i64)gridDim.x * blockDim.x) {
    const u64 v = key[i];
    if (bits < 64 && (v >> bits) != 0) bad = true;
    if (fill) {
      if (mask[i]) {
        broken |= j == 0 && v == top;
        ++kept;
      } else {
        if (v == top) {
          ++at_fill;
        } else {
          broken = true;
          for (int d = 0; d < nd; ++d)
            atomicAdd(&h[d * 256 + ((v >> (8 * d)) & 255)], 1u);
        }
        continue;
      }
    }
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
      if (d >= nd) break;
      const unsigned b = (unsigned)(v >> (8 * d)) & 255u;
      if (b != run_bin[d]) {
        if (run_len[d]) atomicAdd(&counted[d * 256 + run_bin[d]], run_len[d]);
        run_bin[d] = b;
        run_len[d] = 0;
      }
      ++run_len[d];
    }
  }
#pragma unroll
  for (int d = 0; d < kDigits; ++d)
    if (d < nd && run_len[d])
      atomicAdd(&counted[d * 256 + run_bin[d]], run_len[d]);
  if (bad) atomicOr(wide, 1ull << j);
  kept = __reduce_add_sync(full, kept);
  at_fill = __reduce_add_sync(full, at_fill);
  if ((threadIdx.x & 31) == 0) {
    if (kept) atomicAdd(&block_counts[0], (u64)kept);
    if (at_fill) atomicAdd(&block_counts[1], (u64)at_fill);
  }
  if (__syncthreads_or(broken) && threadIdx.x == 0)
    atomicOr(&route->broken, 1u);
  if (threadIdx.x == 0) {
    if (block_counts[1]) atomicAdd(&route->n_fill[j], block_counts[1]);
    if (j == 0 && block_counts[0]) atomicAdd(&route->n_kept, block_counts[0]);
  }
  for (int t = threadIdx.x; t < nd * 256; t += blockDim.x) {
    if (h[t]) atomicAdd(&hist[(u64)j * kDigits * 256 + t], (u64)h[t]);
    if (hk[t]) atomicAdd(&hist_kept[(u64)j * kDigits * 256 + t], (u64)hk[t]);
  }
}

// Exclusive prefix sum of one u64 per thread over a 256-thread block.
__device__ __forceinline__ u64 scan256(u64 v, u64* warp_sums) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  u64 x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 y = __shfl_up_sync(full, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  u64 before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  return before + x - v;
}

// The partition route runs when the caller names fill keys and the
// contract holds: then every masked entry sorts after every kept one on
// the fill keys, all masked entries tie there, and a stable partition by
// the mask after the other keys' passes leaves the masked tail in its
// final order, so the fill keys' passes sort the kept prefix alone.
__device__ __forceinline__ bool partition_route(const Slots& sl,
                                                const Route* route) {
  return sl.fill_keys > 0 && route->broken == 0;
}

// One block per pass slot: the digit's bucket bases, the entries it
// sorts, and whether it runs.
__global__ void plan_kernel(const u64* __restrict__ hist,
                            const u64* __restrict__ hist_kept,
                            const u64* __restrict__ wide,
                            const Route* __restrict__ route, i64 n, Slots sl,
                            Plan* __restrict__ plan) {
  __shared__ u64 warp_sums[kWarps];
  const int s = blockIdx.x;
  const int key = sl.key[s];
  const bool part = partition_route(sl, route);
  const u64 kept = route->n_kept;
  Pass& p = plan->pass[s];
  if (key < 0) {  // the partition: kept entries first
    p.base[threadIdx.x] = threadIdx.x == 0 ? 0 : (i64)kept;
    if (threadIdx.x == 0) {
      p.n = n;
      p.active = part && kept != 0 && kept != (u64)n && *wide == 0;
    }
    return;
  }
  const bool fill = key < sl.fill_keys;
  const bool prefix = part && fill;
  const u64 total = prefix ? kept : (u64)n;
  const size_t at = ((size_t)key * kDigits + sl.digit[s]) * 256 + threadIdx.x;
  u64 c = prefix ? hist_kept[at] : hist[at];
  if (fill && !prefix)  // the full route: all three parts of the entries
    c += hist_kept[at] +
         ((width_max(sl.bits[key]) >> (8 * sl.digit[s]) & 255) == threadIdx.x
              ? route->n_fill[key] : 0);
  const int single = __syncthreads_or(c == total);
  p.base[threadIdx.x] = (i64)scan256(c, warp_sums);
  if (threadIdx.x == 0) {
    p.n = (i64)total;
    p.active = !single && *wide == 0;
  }
}

// One warp reads the passes' flags, one thread chains the passes that
// run through the buffer sets.
__global__ void select_kernel(Slots sl, const Route* __restrict__ route,
                              i64 n, Plan* __restrict__ plan) {
  __shared__ int active[kSlots];
  for (int t = threadIdx.x; t < sl.n; t += blockDim.x)
    active[t] = plan->pass[t].active;
  __syncwarp();
  if (threadIdx.x != 0) return;
  int set = -1;
  int cur_key = -2;
  plan->tail_set = -1;
  for (int t = 0; t < sl.n; ++t) {
    Pass& p = plan->pass[t];
    if (sl.key[t] < 0) plan->tail_set = active[t] ? (set < 0 ? 0 : 1 - set)
                                                  : set;
    if (!active[t]) continue;
    p.source = sl.key[t] != cur_key ? (set < 0 ? kIdentity : kGather)
                                    : kCarried;
    cur_key = sl.key[t];
    p.src = set < 0 ? 0 : set;
    p.dst = set < 0 ? 0 : 1 - set;
    set = p.dst;
    p.write_key = 0;
    for (int u = t + 1; u < sl.n && sl.key[u] == sl.key[t]; ++u)
      if (active[u]) {
        p.write_key = 1;
        break;
      }
  }
  plan->final_set = set;
  plan->n_head = partition_route(sl, route) ? (i64)route->n_kept : n;
}

__device__ __forceinline__ u64 load_status(const u64* p) {
  return *(const volatile u64*)p;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  *(volatile u64*)p = v;
}

// Stage a warp's run of `count` (<= kWarpRun) entries of `src` into
// shared `dst`: 16-byte loads when the run is whole and aligned.
template <typename T>
__device__ __forceinline__ void stage_run(const T* __restrict__ src,
                                          int count, T* dst, int lane) {
  constexpr int kPer = 16 / sizeof(T);
  if (count == kWarpRun && ((size_t)src & 15) == 0) {
    const uint4* s4 = (const uint4*)src;
    uint4* d4 = (uint4*)dst;
#pragma unroll
    for (int q = 0; q < kWarpRun / kPer / 32; ++q)
      d4[lane + 32 * q] = s4[lane + 32 * q];
  } else {
    for (int e = lane; e < count; e += 32) dst[e] = src[e];
  }
}

// One stable digit pass of slot `s` over the key plane `plane` (read by
// kIdentity and kGather passes; null for the partition pass, whose key
// is the mask bit).
__global__ void __launch_bounds__(kThreads, 2)
onesweep_kernel(const u64* __restrict__ plane, const bool* __restrict__ mask,
                int s, int shift, const Plan* __restrict__ plan, Buffers buf,
                u32* __restrict__ tile_counter, u64* __restrict__ status) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* skey = (u64*)smem;
  u32* sidx = (u32*)(skey + kTile);
  int* whist = (int*)(sidx + kTile);
  __shared__ int warp_sums[32];
  __shared__ int tstart[256];
  __shared__ i64 goff[256];
  __shared__ u32 tile_s;

  const Pass& pass = plan->pass[s];
  if (!pass.active) return;  // a constant digit: the whole grid returns
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) tile_s = atomicAdd(&tile_counter[s], 1u);
  for (int t = tid; t < kWarps * 256; t += kThreads) whist[t] = 0;
  __syncthreads();
  const int source = pass.source;
  const i64 tile = tile_s;
  const i64 t0 = tile * kTile;
  if (t0 >= pass.n) return;  // past the kept prefix: the block returns
  const int cnt = (int)min((i64)kTile, pass.n - t0);
  const int wbase = warp * kWarpRun;
  const int wcnt = max(0, min(kWarpRun, cnt - wbase));
  const u64 epoch = (u64)(s + 1) << kEpochShift;

  // 1. load the warp's run, staged with 16-byte loads, read warp-striped
  if (source != kIdentity)
    stage_run(buf.index[pass.src] + t0 + wbase, wcnt, sidx + wbase, lane);
  if (source == kCarried || (source == kIdentity && plane))
    stage_run((source == kCarried ? buf.key[pass.src] : plane) + t0 + wbase,
              wcnt, skey + wbase, lane);
  __syncwarp();
  u64 k[kItems];
  u32 ix[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int e = r * 32 + lane;
    k[r] = 0;
    ix[r] = 0;
    if (e < wcnt) {
      ix[r] = source == kIdentity ? (u32)(t0 + wbase + e) : sidx[wbase + e];
      k[r] = !plane ? (u64)!mask[ix[r]]
                    : source == kGather ? plane[ix[r]] : skey[wbase + e];
    }
  }

  // 2. rank equal digits stably: off[r] counts the warp's earlier
  //    entries of the same digit
  int off[kItems];
  int* wh = whist + warp * 256;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool ok = r * 32 + lane < wcnt;
    const unsigned dig = ok ? (unsigned)(k[r] >> shift) & 255u : 256u;
    const unsigned peers = __match_any_sync(full, dig);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (ok && lane == leader) {
      base = wh[dig];
      wh[dig] = base + __popc(peers);
    }
    base = __shfl_sync(full, base, leader);
    __syncwarp();
    off[r] = base + __popc(peers & ((1u << lane) - 1u));
  }
  __syncthreads();

  // 3. thread tid owns digit tid: the warps' offsets within it, the
  //    tile's count, published at once; the tile-local digit starts
  int count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = whist[w * 256 + tid];
    whist[w * 256 + tid] = count;
    count += c;
  }
  u64* st = status + (size_t)tile * 256 + tid;
  store_status(st, epoch | (tile == 0 ? kInclusive : kAggregate) | (u64)count);
  int total;
  const int tex = pgrtk::block_exclusive_scan(count, &total, warp_sums);
  tstart[tid] = tex;
  __syncthreads();

  // 4. reorder the tile by digit in shared memory
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (r * 32 + lane < wcnt) {
      const unsigned dig = (unsigned)(k[r] >> shift) & 255u;
      const int p = tstart[dig] + whist[warp * 256 + dig] + off[r];
      skey[p] = k[r];
      sidx[p] = ix[r];
    }
  }

  // 5. decoupled look-back: the entries of digit tid in earlier tiles
  i64 excl = 0;
  if (tile > 0) {
    i64 j = tile - 1;
    for (;;) {
      u64 w[kLookahead];
#pragma unroll
      for (int q = 0; q < kLookahead; ++q)
        w[q] = j - q >= 0 ? load_status(status + (size_t)(j - q) * 256 + tid)
                          : 0;
      int q = 0;
      bool done = false;
      for (; q < kLookahead; ++q) {
        const u64 v = w[q];
        const u64 flag = (v >> kFlagShift) & 3u;
        if ((v & ~((1ull << kEpochShift) - 1)) != epoch || flag == 0) break;
        excl += (i64)(v & kValueMask);
        if (flag == 2) {
          done = true;
          break;
        }
      }
      if (done) break;
      j -= q;
    }
    store_status(st, epoch | kInclusive | (u64)(excl + count));
  }
  goff[tid] = pass.base[tid] + excl - tex;
  __syncthreads();

  // 6. write each digit's run contiguously
  u64* kout = buf.key[pass.dst];
  u32* iout = buf.index[pass.dst];
  const bool write_key = pass.write_key;
  for (int e = tid; e < cnt; e += kThreads) {
    const u64 v = skey[e];
    const i64 pos = goff[(v >> shift) & 255] + e;
    if (write_key) kout[pos] = v;
    iout[pos] = sidx[e];
  }
}

// The input index of sorted position i: the plan's head or tail order.
__device__ __forceinline__ i64 perm_at(const Plan* plan, const Buffers& buf,
                                       i64 i) {
  const int set = i < plan->n_head ? plan->final_set : plan->tail_set;
  return set < 0 ? i : (i64)buf.index[set][i];
}

// out[j][i] = in[j][perm[i]] for every plane, mask_out[i] = mask[perm[i]],
// and (link != null) the link flag of sorted row i to row i + 1 from
// planes 0 (sid), 1 (bgn), 2 (end) and the mask.  perm is the order the
// plan names.
__global__ void gather_link_kernel(Planes pl, const Plan* __restrict__ plan,
                                   Buffers buf, i64 n,
                                   const bool* __restrict__ mask,
                                   bool* __restrict__ mask_out,
                                   bool* __restrict__ link) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 p = perm_at(plan, buf, i);
  for (int j = 0; j < pl.n; ++j) pl.out[j][i] = pl.in[j][p];
  if (mask_out) mask_out[i] = mask[p];
  if (link && i + 1 < n) {
    const i64 q = perm_at(plan, buf, i + 1);
    link[i] = pl.in[0][p] == pl.in[0][q] && pl.in[2][p] == pl.in[1][q] &&
              mask[p] && mask[q];
  }
}

i64 tiles(i64 n) { return (n + kTile - 1) / kTile; }

size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

// Scratch layout: the two (key, index) buffer sets, then the digit
// histograms, the per-slot tile counters and the tiles' status words
// (one zeroed run), then the plan.
struct Scratch {
  Buffers buf;
  u64* hist;
  u64* hist_kept;
  Route* route;
  u32* counters;
  u64* status;
  size_t zero_bytes;  // hist .. status
  Plan* plan;
};

size_t scratch_layout(i64 n, char* base, Scratch* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  char* k0 = take(8 * (size_t)n);
  char* k1 = take(8 * (size_t)n);
  char* i0 = take(4 * (size_t)n);
  char* i1 = take(4 * (size_t)n);
  const size_t zero0 = off;
  char* hist = take(8 * (size_t)kMaxKeys * kDigits * 256);
  char* hist_kept = take(8 * (size_t)kMaxKeys * kDigits * 256);
  char* route = take(sizeof(Route));
  char* counters = take(4 * (size_t)kSlots);
  char* status = take(8 * 256 * (size_t)tiles(n));
  const size_t zero1 = off;
  char* plan = take(sizeof(Plan));
  if (s) {
    s->buf.key[0] = (u64*)k0;
    s->buf.key[1] = (u64*)k1;
    s->buf.index[0] = (u32*)i0;
    s->buf.index[1] = (u32*)i1;
    s->hist = (u64*)hist;
    s->hist_kept = (u64*)hist_kept;
    s->route = (Route*)route;
    s->counters = (u32*)counters;
    s->status = (u64*)status;
    s->zero_bytes = zero1 - zero0;
    s->plan = (Plan*)plan;
  }
  return off;
}

// The engine.  keys: n_keys int64 planes, most significant first, with
// their bit widths; fill_keys: how many leading key planes hold their
// width's maximum wherever the mask is false (the pair tables' INT64_MAX
// fill; the engine checks it on the card and sorts those planes over the
// kept entries alone when it holds, see partition_route); planes:
// n_planes payload planes gathered into sorted order (outs); mask (bool,
// may be null unless fill_keys > 0) gathered into mask_out and read by
// the link pass when link != null.  wide: one device uint64 the engine
// sets to the planes holding values wider than their bit width (bit j
// for key j; nothing is sorted then: outs hold the input order).  Issues
// every launch on `stream` and never waits for it.
int radix_sort_gather(const void* const* keys, const int* bits, int n_keys,
                      int fill_keys, i64 n, const void* const* planes,
                      void* const* outs, int n_planes, const void* mask,
                      void* mask_out, void* link, void* scratch, void* wide,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_keys < 1 || n_keys > kMaxKeys || n_planes < 0 ||
      n_planes > kMaxPlanes || n < 0 || n > 0xffffffffll ||
      (link && (n_planes < 3 || !mask)) || fill_keys < 0 ||
      fill_keys > n_keys || (fill_keys && !mask))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < n_keys; ++j)
    if (bits[j] < 1 || bits[j] > 64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(wide, 0, 8, st);
  if (err != cudaSuccess || n == 0) return (int)err;
  Scratch s;
  scratch_layout(n, (char*)scratch, &s);

  Keys ks;
  Slots sl;
  sl.n = 0;
  sl.fill_keys = fill_keys;
  for (int j = 0; j < n_keys; ++j) {
    ks.key[j] = (const u64*)keys[j];
    ks.bits[j] = sl.bits[j] = bits[j];
  }
  for (int j = n_keys - 1; j >= 0; --j) {
    if (j == fill_keys - 1) {  // the partition slot
      sl.key[sl.n] = -1;
      sl.digit[sl.n] = 0;
      ++sl.n;
    }
    for (int d = 0; d < (bits[j] + 7) / 8; ++d) {
      sl.key[sl.n] = j;
      sl.digit[sl.n] = d;
      ++sl.n;
    }
  }
  cudaMemsetAsync(s.hist, 0, s.zero_bytes, st);
  const i64 hb = (n + kThreads - 1) / kThreads;  // a few blocks a plane:
  histogram_kernel<<<dim3((unsigned)(hb < 256 ? hb : 256), n_keys),  // few flushes
                     kThreads, 0, st>>>(ks, n, fill_keys, (const bool*)mask,
                                        s.hist, s.hist_kept, (u64*)wide,
                                        s.route);
  plan_kernel<<<sl.n, kThreads, 0, st>>>(s.hist, s.hist_kept,
                                          (const u64*)wide, s.route, n, sl,
                                          s.plan);
  select_kernel<<<1, 32, 0, st>>>(sl, s.route, n, s.plan);
  err = pgrtk::allow_smem(onesweep_kernel, kPassSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned n_tiles = (unsigned)tiles(n);
  for (int t = 0; t < sl.n; ++t)
    onesweep_kernel<<<n_tiles, kThreads, kPassSmem, st>>>(
        sl.key[t] < 0 ? nullptr : ks.key[sl.key[t]], (const bool*)mask, t,
        8 * sl.digit[t], s.plan, s.buf, s.counters, s.status);

  Planes pl;
  pl.n = n_planes;
  for (int j = 0; j < n_planes; ++j) {
    pl.in[j] = (const i64*)planes[j];
    pl.out[j] = (i64*)outs[j];
  }
  gather_link_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                       0, st>>>(pl, s.plan, s.buf, n, (const bool*)mask,
                                (bool*)mask_out, (bool*)link);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long pgrtk_radix_scratch_bytes(long long n) {
  return (long long)scratch_layout(n, nullptr, nullptr);
}

// The MAP-graph rows: keys = payload = (sid, bgn, end, h0, h1, ori);
// mask (N,) bool; outs the 6 sorted planes; link (N-1,) bool.
extern "C" int pgrtk_sort_link_rows(const void* const* keys, const int* bits,
                                    int n_keys, int fill_keys, long long n,
                                    const void* const* planes,
                                    void* const* outs, int n_planes,
                                    const void* mask, void* mask_out,
                                    void* link, void* scratch, void* wide,
                                    void* stream) {
  return radix_sort_gather(keys, bits, n_keys, fill_keys, n, planes, outs,
                           n_planes, mask, mask_out, link, scratch, wide,
                           stream);
}

// The pair table: keys (k0, k1, sid, bgn) with invalid entries' keys at
// INT64_MAX (fill_keys 2); payload the 6 table planes; mask = valid; no
// link.
extern "C" int pgrtk_sort_pairs(const void* const* keys, const int* bits,
                                int n_keys, int fill_keys, long long n,
                                const void* const* planes, void* const* outs,
                                int n_planes, const void* mask,
                                void* mask_out, void* link, void* scratch,
                                void* wide, void* stream) {
  return radix_sort_gather(keys, bits, n_keys, fill_keys, n, planes, outs,
                           n_planes, mask, mask_out, link, scratch, wide,
                           stream);
}
