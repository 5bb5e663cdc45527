// Gap-affine wavefront alignment (WFA).
//
// Equivalent of the reference's wavefront-aln dependency used by
// wfa_align_bases (reference: pgr-db/src/aln.rs:244-267): align two byte
// strings under (mismatch, gap_open, gap_extend) penalties, return the
// two gapped alignment strings.  Implemented from the WFA recurrences
// (Marco-Sola et al. 2021); wavefronts wider than max_wf_length are
// adaptively trimmed around the furthest-progress diagonal (the reference
// caps its wavefront length the same way).
//
// The port's copy of pgrtk_tpu/native/src/wfa.cc: the per-segment host
// path of ops/wfa.py::batch_wfa_align for the segments the card does not
// take, and the arbiter K13 (csrc/wfa.cu) is held against.  The result
// strings are freed with pgr_free (dfs_walk.cc).
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int32_t KNULL = INT32_MIN / 2;  // "no entry"

struct WF {
  int32_t lo = 0, hi = -1;          // diagonal range (empty when hi < lo)
  std::vector<int32_t> m, i, d;      // furthest offsets per diagonal (x)
  inline int32_t get(const std::vector<int32_t> &v, int32_t k) const {
    if (k < lo || k > hi) return KNULL;
    return v[(size_t)(k - lo)];
  }
  inline int32_t M(int32_t k) const { return get(m, k); }
  inline int32_t I(int32_t k) const { return get(i, k); }
  inline int32_t D(int32_t k) const { return get(d, k); }
};

struct Aligner {
  const uint8_t *t;  // "target" = seq0, length n (x axis)
  const uint8_t *q;  // "query"  = seq1, length m (y axis)
  int64_t n, m;
  int32_t x, o, e;   // mismatch, gap open, gap extend
  uint32_t max_wf_length;
  std::vector<WF> wfs;  // per score

  inline int32_t extend(int32_t k, int32_t off) const {
    // offset = x position; y = x - k
    int32_t xx = off, yy = off - k;
    while (xx < n && yy < m && t[xx] == q[yy]) {
      ++xx;
      ++yy;
    }
    return xx;
  }

  bool align(int32_t max_score) {
    wfs.clear();
    wfs.resize(1);
    WF &w0 = wfs[0];
    w0.lo = 0;
    w0.hi = 0;
    w0.m = {extend(0, 0)};
    w0.i = {KNULL};
    w0.d = {KNULL};
    const int32_t end_k = (int32_t)(n - m);
    if (w0.m[0] >= n && w0.m[0] - end_k >= m) return true;

    for (int32_t s = 1; s <= max_score; ++s) {
      wfs.emplace_back();
      WF &w = wfs[(size_t)s];
      const WF *wx = s >= x ? &wfs[(size_t)(s - x)] : nullptr;
      const WF *woe = s >= o + e ? &wfs[(size_t)(s - o - e)] : nullptr;
      const WF *we = s >= e ? &wfs[(size_t)(s - e)] : nullptr;

      int32_t lo = INT32_MAX, hi = INT32_MIN;
      auto upd = [&](const WF *src) {
        if (src && src->hi >= src->lo) {
          lo = std::min(lo, src->lo - 1);
          hi = std::max(hi, src->hi + 1);
        }
      };
      upd(wx);
      upd(woe);
      upd(we);
      if (lo > hi) {
        w.lo = 0;
        w.hi = -1;
        continue;
      }
      w.lo = lo;
      w.hi = hi;
      size_t width = (size_t)(hi - lo + 1);
      w.m.assign(width, KNULL);
      w.i.assign(width, KNULL);
      w.d.assign(width, KNULL);

      for (int32_t k = lo; k <= hi; ++k) {
        size_t idx = (size_t)(k - lo);
        // insertion into target axis? Convention: I advances x (gap in q),
        // D advances y (gap in t).
        int32_t ins = KNULL;
        if (woe) ins = std::max(ins, woe->M(k - 1));
        if (we) ins = std::max(ins, we->I(k - 1));
        if (ins > KNULL) ins += 1;
        w.i[idx] = ins;

        int32_t del = KNULL;
        if (woe) del = std::max(del, woe->M(k + 1));
        if (we) del = std::max(del, we->D(k + 1));
        w.d[idx] = del;

        int32_t mm = KNULL;
        if (wx) {
          int32_t v = wx->M(k);
          if (v > KNULL) mm = v + 1;
        }
        mm = std::max(mm, std::max(w.i[idx], w.d[idx]));
        if (mm > KNULL) {
          int32_t yy = mm - k;
          if (mm < 0 || mm > n || yy < 0 || yy > m) {
            w.m[idx] = KNULL;
            continue;
          }
          mm = extend(k, mm);
          w.m[idx] = mm;
          if (mm >= n && mm - k >= m && k == (int32_t)(n - m)) return true;
        }
      }

      // adaptive trim: keep at most max_wf_length diagonals around best
      if ((uint32_t)(w.hi - w.lo + 1) > max_wf_length) {
        int32_t best_k = w.lo;
        int64_t best_v = INT64_MIN;
        for (int32_t k = w.lo; k <= w.hi; ++k) {
          int32_t v = w.M(k);
          if (v <= KNULL) continue;
          int64_t progress = (int64_t)v + (int64_t)(v - k);  // x + y
          if (progress > best_v) {
            best_v = progress;
            best_k = k;
          }
        }
        int32_t half = (int32_t)max_wf_length / 2;
        int32_t nlo = best_k - half;
        int32_t nhi = best_k + half;
        nlo = std::max(nlo, w.lo);
        nhi = std::min(nhi, w.hi);
        std::vector<int32_t> nm(nhi - nlo + 1), ni(nhi - nlo + 1),
            nd(nhi - nlo + 1);
        for (int32_t k = nlo; k <= nhi; ++k) {
          nm[k - nlo] = w.M(k);
          ni[k - nlo] = w.I(k);
          nd[k - nlo] = w.D(k);
        }
        w.lo = nlo;
        w.hi = nhi;
        w.m = std::move(nm);
        w.i = std::move(ni);
        w.d = std::move(nd);
      }
    }
    return false;
  }

  // backtrace from (score, end diagonal, M state)
  void backtrace(int32_t final_s, std::string &ta, std::string &qa) const {
    int32_t k = (int32_t)(n - m);
    int32_t s = final_s;
    int32_t off = wfs[(size_t)s].M(k);
    char state = 'M';
    std::string rt, rq;

    while (true) {
      if (state == 'M') {
        // undo free match extension down to the entry point of M at (s,k)
        int32_t entry;
        const WF &w = wfs[(size_t)s];
        int32_t from_x = KNULL, from_i = w.I(k), from_d = w.D(k);
        if (s >= x) {
          int32_t v = wfs[(size_t)(s - x)].M(k);
          if (v > KNULL) from_x = v + 1;
        }
        entry = std::max(from_x, std::max(from_i, from_d));
        if (s == 0) entry = 0;
        // emit matches from entry..off
        for (int32_t p = off; p > entry; --p) {
          rt.push_back((char)t[p - 1]);
          rq.push_back((char)q[p - 1 - k]);
        }
        off = entry;
        if (s == 0) {
          // leading matches to origin
          break;
        }
        if (from_x == entry && from_x > KNULL) {
          // mismatch
          rt.push_back((char)t[off - 1]);
          rq.push_back((char)q[off - 1 - k]);
          s -= x;
          off -= 1;
          state = 'M';
          off = wfs[(size_t)s].M(k);
          // note: off at (s-x, k) is the M value; emit continues there
        } else if (from_i == entry && from_i > KNULL) {
          state = 'I';
        } else {
          state = 'D';
        }
      } else if (state == 'I') {
        // I(s,k) came from M(s-o-e, k-1)+1 or I(s-e, k-1)+1
        rt.push_back((char)t[off - 1]);
        rq.push_back('-');
        int32_t from_open = KNULL, from_ext = KNULL;
        if (s >= o + e) from_open = wfs[(size_t)(s - o - e)].M(k - 1);
        if (s >= e) from_ext = wfs[(size_t)(s - e)].I(k - 1);
        off -= 1;
        k -= 1;
        if (from_ext > KNULL && from_ext == off &&
            !(from_open > KNULL && from_open == off)) {
          s -= e;
          state = 'I';
        } else if (from_open > KNULL && from_open == off) {
          s -= o + e;
          state = 'M';
        } else {
          s -= e;
          state = 'I';
        }
      } else {  // 'D'
        rt.push_back('-');
        rq.push_back((char)q[off - k - 1]);
        int32_t from_open = KNULL, from_ext = KNULL;
        if (s >= o + e) from_open = wfs[(size_t)(s - o - e)].M(k + 1);
        if (s >= e) from_ext = wfs[(size_t)(s - e)].D(k + 1);
        k += 1;
        if (from_ext > KNULL && from_ext == off &&
            !(from_open > KNULL && from_open == off)) {
          s -= e;
          state = 'D';
        } else if (from_open > KNULL && from_open == off) {
          s -= o + e;
          state = 'M';
        } else {
          s -= e;
          state = 'D';
        }
      }
      if (s == 0 && state == 'M') {
        int32_t v = wfs[0].M(k);
        (void)v;
        // emit remaining matches to origin
        for (int32_t p = off; p > 0; --p) {
          rt.push_back((char)t[p - 1]);
          rq.push_back((char)q[p - 1 - k]);
        }
        break;
      }
    }
    ta.assign(rt.rbegin(), rt.rend());
    qa.assign(rq.rbegin(), rq.rend());
  }
};

}  // namespace

extern "C" {

// Returns final score >= 0 on success, -1 if no alignment within limits.
// *t_aln / *q_aln are malloc'd NUL-terminated gapped strings.
int32_t pgr_wfa_align(const uint8_t *t, int64_t n, const uint8_t *q,
                      int64_t m, uint32_t max_wf_length,
                      int32_t mismatch, int32_t gap_open, int32_t gap_ext,
                      int32_t max_steps, char **t_aln, char **q_aln) {
  Aligner a;
  a.t = t;
  a.q = q;
  a.n = n;
  a.m = m;
  a.x = mismatch;
  a.o = gap_open;
  a.e = gap_ext;
  a.max_wf_length = max_wf_length ? max_wf_length : 0x7FFFFFFF;
  if (!a.align(max_steps)) return -1;
  int32_t final_s = (int32_t)a.wfs.size() - 1;
  std::string ta, qa;
  a.backtrace(final_s, ta, qa);
  *t_aln = (char *)std::malloc(ta.size() + 1);
  *q_aln = (char *)std::malloc(qa.size() + 1);
  std::memcpy(*t_aln, ta.c_str(), ta.size() + 1);
  std::memcpy(*q_aln, qa.c_str(), qa.size() + 1);
  return final_s;
}

}  // extern "C"
