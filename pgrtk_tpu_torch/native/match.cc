// O(nD) greedy banded diff alignment, exact semantics of the reference
// "match_reads" (pgr-db/src/shmmrutils.rs:57-223).  Used for fragment
// delta-compression and position pin-down.
//
// The port's copy of pgrtk_tpu/native/src/match.cc: the FRG writer
// (core/frag_io.py) delta-compresses repeat fragments with it, and
// map_positions_in_seq aligns many pairs at once through
// pgr_match_reads_batch, the port's own entry.
#include "pgrtk.h"

#include <atomic>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Delta {
  uint32_t x, y;
  int32_t dk;
};

// Per-d sparse row of delta points: ks visited at depth d form an
// arithmetic sequence k_min..k_max step 2; store base and stride-2 slots.
struct DeltaRows {
  std::vector<int32_t> base_k;
  std::vector<std::vector<Delta>> rows;
  void ensure(uint32_t d) {
    if (rows.size() <= d) {
      rows.resize(d + 1);
      base_k.resize(d + 1, INT32_MIN);
    }
  }
  void insert(uint32_t d, int32_t k, const Delta &dp) {
    ensure(d);
    if (base_k[d] == INT32_MIN) base_k[d] = k;
    size_t idx = (size_t)((k - base_k[d]) / 2);
    if (rows[d].size() <= idx) rows[d].resize(idx + 1, Delta{0, 0, INT32_MIN});
    if (rows[d][idx].dk == INT32_MIN) rows[d][idx] = dp;  // or_insert semantics
  }
  const Delta &get(uint32_t d, int32_t k) const {
    return rows[d][(size_t)((k - base_k[d]) / 2)];
  }
};

}  // namespace

extern "C" void pgr_match_reads(const uint8_t *seq0, int64_t len0,
                                const uint8_t *seq1, int64_t len1,
                                int get_delta, double tol,
                                uint32_t min_match_len,
                                uint32_t min_match_start, uint32_t bandwidth,
                                pgr_ovlp *out) {
  std::memset(out, 0, sizeof(*out));
  const int64_t min_len = len0 < len1 ? len0 : len1;
  const uint32_t d_max = 32 + (uint32_t)(tol * (double)min_len);
  const uint32_t max_band_width = bandwidth;
  const uint32_t band_tolerance = bandwidth;

  int32_t k_min = 0, k_max = 0;
  // uv_map: k in [-d_max, d_max] -> (u = x+y, v = x); offset-indexed vector
  std::vector<uint32_t> u_map(2 * (size_t)d_max + 3, 0);
  std::vector<uint32_t> v_map(2 * (size_t)d_max + 3, 0);
  const int64_t off = (int64_t)d_max + 1;

  DeltaRows delta_pts;

  int64_t best_m = -1;
  bool matched = false;
  uint32_t d_final = 0;
  int32_t k_final = 0;
  bool start = false;
  uint32_t longest_match = 0;

  uint32_t r_bgn0 = 0, r_bgn1 = 0, r_end0 = 0, r_end1 = 0;
  uint32_t r_mend0 = 0, r_mend1 = 0;

  for (uint32_t d = 0; d < d_max; ++d) {
    if (k_max - k_min > (int32_t)max_band_width) break;
    for (int32_t k = k_min; k <= k_max; k += 2) {
      uint32_t x;
      int32_t pre_k;
      const uint32_t vn = v_map[(size_t)(k - 1 + off)];
      const uint32_t vp = v_map[(size_t)(k + 1 + off)];
      if (k == k_min || (k != k_max && vn < vp)) {
        x = vp;
        pre_k = k + 1;
      } else {
        x = vn + 1;
        pre_k = k - 1;
      }
      uint32_t y = (uint32_t)((int32_t)x - k);

      if (get_delta) delta_pts.insert(d, k, Delta{x, y, k - pre_k});

      const uint32_t x1 = x, y1 = y;
      while ((int64_t)x < len0 && (int64_t)y < len1 && seq0[x] == seq1[y]) {
        ++x;
        ++y;
      }

      if ((x - x1) >= min_match_start && !start) {
        r_bgn0 = x1;
        r_bgn1 = y1;
        start = true;
      }
      if ((x - x1) > longest_match) {
        longest_match = x - x1;
        r_mend0 = x;
        r_mend1 = y;
      }

      u_map[(size_t)(k + off)] = x + y;
      v_map[(size_t)(k + off)] = x;
      if ((int64_t)(x + y) > best_m) best_m = (int64_t)(x + y);
      if ((int64_t)x >= len0 || (int64_t)y >= len1) {
        matched = true;
        d_final = d;
        k_final = k;
        r_end0 = x;
        r_end1 = y;
        break;
      }
    }
    // banding (reference: shmmrutils.rs:181-196)
    int32_t k_max_new = k_min, k_min_new = k_max;
    for (int32_t k2 = k_min; k2 <= k_max; k2 += 2) {
      const uint32_t u = u_map[(size_t)(k2 + off)];
      if ((int64_t)u >= best_m - (int64_t)band_tolerance) {
        if (k2 < k_min_new) k_min_new = k2;
        if (k2 > k_max_new) k_max_new = k2;
      }
    }
    k_max = k_max_new + 1;
    k_min = k_min_new - 1;

    if (matched) {
      uint32_t d_inside = 0;
      if (get_delta) {
        // backtrace (reference: shmmrutils.rs:36-55), filtered to
        // [bgn0, end0], counting strict-interior deltas
        std::vector<Delta> dpts;
        uint32_t dd = d_final;
        int32_t kk = k_final;
        while (dd > 0) {
          const Delta &dp = delta_pts.get(dd, kk);
          if (dp.x >= r_bgn0 && dp.x <= r_end0) dpts.push_back(dp);
          --dd;
          kk -= dp.dk;
        }
        for (const auto &dp : dpts)
          if (dp.x > r_bgn0 && dp.x < r_end0) ++d_inside;
        out->n_deltas = (int64_t)dpts.size();
        out->deltas = (pgr_delta *)std::malloc(
            sizeof(pgr_delta) * (dpts.size() ? dpts.size() : 1));
        std::memcpy(out->deltas, dpts.data(), sizeof(pgr_delta) * dpts.size());
      }
      out->dist = d_inside;
      out->m_size = (r_end0 - r_bgn0 + r_end1 - r_bgn1 + 2 * d_inside) >> 1;
      if (out->m_size < min_match_len) matched = false;
      break;
    }
  }

  if (!matched) {
    if (out->deltas) {
      std::free(out->deltas);
      out->deltas = nullptr;
      out->n_deltas = 0;
    }
    out->matched = 0;
    return;
  }
  out->matched = 1;
  out->bgn0 = r_bgn0;
  out->end0 = r_end0;
  out->bgn1 = r_bgn1;
  out->end1 = r_end1;
  out->m_end0 = r_mend0;
  out->m_end1 = r_mend1;
}

extern "C" void pgr_match_reads_batch(
    int64_t n, const uint8_t *const *seq0, const int64_t *len0,
    const uint8_t *const *seq1, const int64_t *len1, int get_delta,
    double tol, uint32_t min_match_len, uint32_t min_match_start,
    uint32_t bandwidth, int32_t n_threads, pgr_ovlp *out) {
  std::atomic<int64_t> next{0};
  auto work = [&]() {
    for (int64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1))
      pgr_match_reads(seq0[i], len0[i], seq1[i], len1[i], get_delta, tol,
                      min_match_len, min_match_start, bandwidth, &out[i]);
  };
  std::vector<std::thread> pool;
  for (int32_t t = 1; t < n_threads; ++t) pool.emplace_back(work);
  work();
  for (auto &th : pool) th.join();
}
