// Sparse anchor-chaining DP, exact semantics of the reference "sparse_aln"
// (pgr-db/src/aln.rs:12-142): stable-sort anchors by query start, score
// each against up to max_span distinct predecessors with a gap penalty,
// then iterated best-score traceback extracting multiple chains.
//
// Note on determinism: the reference's traceback scans an FxHashSet in hash
// order, so equal-score ties break nondeterministically there; we scan in
// sorted-anchor order (deterministic, canonical).  Chain contents are
// identical; only the emission order of exactly-tied chains can differ.
//
// The port's copy of pgrtk_tpu/native/src/chain.cc, with one deliberate
// difference: an exact duplicate anchor that recurs after other anchors
// can make the value-keyed predecessors cycle.  The JAX package's walk
// then loops forever; this one stops when a chain grows past the distinct
// anchors, returns -1 and reports the two anchors (core/aln_ref.py's
// sparse_aln raises there too).  ops/chain.py::chain_groups runs it on the
// groups whose device scan would leave the lookback window.
#include "pgrtk.h"

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct HP {
  uint32_t v[6];  // q_bgn, q_end, q_ori, t_bgn, t_end, t_ori
  bool operator==(const HP &o) const {
    return std::memcmp(v, o.v, sizeof(v)) == 0;
  }
};

struct HPHash {
  size_t operator()(const HP &h) const {
    uint64_t a = ((uint64_t)h.v[0] << 32) | h.v[1];
    uint64_t b = ((uint64_t)h.v[2] << 32) | h.v[3];
    uint64_t c = ((uint64_t)h.v[4] << 32) | h.v[5];
    uint64_t x = a * 0x9E3779B97F4A7C15ULL;
    x ^= b + 0x9E3779B97F4A7C15ULL + (x << 6) + (x >> 2);
    x ^= c + 0x9E3779B97F4A7C15ULL + (x << 6) + (x >> 2);
    return (size_t)x;
  }
};

struct Entry {
  float score = 0.f;
  bool has_prev = false;
  HP prev{};
};

struct QTriple {
  uint32_t b, e, o;
  bool operator==(const QTriple &x) const {
    return b == x.b && e == x.e && o == x.o;
  }
};

}  // namespace

extern "C" int64_t pgr_sparse_aln(const uint32_t *hits, int64_t n,
                                  uint32_t max_span, float penalty,
                                  int64_t max_gap, int oriented,
                                  uint32_t **out, int64_t *out_len,
                                  uint32_t *cycle) {
  std::vector<HP> sp(n);
  for (int64_t i = 0; i < n; ++i) std::memcpy(sp[i].v, hits + 6 * i, 24);
  // stable sort by query begin only (reference: aln.rs:21)
  std::stable_sort(sp.begin(), sp.end(),
                   [](const HP &a, const HP &b) { return a.v[0] < b.v[0]; });

  std::unordered_map<HP, Entry, HPHash> vs;
  vs.reserve((size_t)n * 2);

  const HP &first = sp[0];
  vs[first] = Entry{(float)first.v[1] - (float)first.v[0], false, HP{}};

  std::vector<QTriple> span_set;
  span_set.reserve(max_span + 1);

  for (int64_t i = 1; i < n; ++i) {
    const HP hp = sp[i];
    bool best_set = false;
    HP best_v{};
    float best_s = 0.f;
    span_set.clear();
    for (int64_t j = i - 1; j >= 0; --j) {
      const HP pre = sp[j];
      if (oriented) {
        if ((pre.v[2] ^ pre.v[5]) != (hp.v[2] ^ hp.v[5])) continue;
      }
      if (max_gap >= 0) {
        const float mg = (float)max_gap;
        if (hp.v[2] == hp.v[5]) {
          if (std::fabs((float)hp.v[0] - (float)pre.v[1]) > mg ||
              std::fabs((float)hp.v[3] - (float)pre.v[4]) > mg)
            continue;
        } else if (std::fabs((float)hp.v[0] - (float)pre.v[1]) > mg ||
                   std::fabs((float)hp.v[4] - (float)pre.v[3]) > mg) {
          continue;
        }
      }
      if (pre.v[0] == hp.v[0] && pre.v[1] == hp.v[1] && pre.v[2] == hp.v[2])
        continue;  // same left coordinate
      QTriple qt{pre.v[0], pre.v[1], pre.v[2]};
      if (std::find(span_set.begin(), span_set.end(), qt) == span_set.end())
        span_set.push_back(qt);
      auto it = vs.find(pre);
      const float p_s = it == vs.end() ? 0.f : it->second.score;
      float s = p_s + ((float)hp.v[1] - (float)hp.v[0]);
      if (hp.v[2] == hp.v[5]) {
        s -= penalty * (std::fabs((float)hp.v[0] - (float)pre.v[1]) +
                        std::fabs((float)hp.v[3] - (float)pre.v[4]));
      } else {
        s -= penalty * (std::fabs((float)hp.v[0] - (float)pre.v[1]) +
                        std::fabs((float)hp.v[4] - (float)pre.v[3]));
      }
      if (s > best_s) {
        best_s = s;
        best_v = pre;
        best_set = true;
      }
      if (span_set.size() >= (size_t)max_span) break;
    }
    if (best_s > 0.f) {
      vs[hp] = Entry{best_s, best_set, best_v};
    } else {
      vs[hp] = Entry{(float)hp.v[1] - (float)hp.v[0], false, HP{}};
    }
  }

  // unique keys in sorted first-occurrence order
  std::vector<HP> uniq;
  uniq.reserve((size_t)n);
  {
    std::unordered_set<HP, HPHash> seen;
    seen.reserve((size_t)n * 2);
    for (const auto &hp : sp)
      if (seen.insert(hp).second) uniq.push_back(hp);
  }
  std::unordered_set<HP, HPHash> unvisited(uniq.begin(), uniq.end());

  struct Chain {
    float score;
    std::vector<HP> track;
  };
  std::vector<Chain> chains;

  while (!unvisited.empty()) {
    float best_s = 0.f;
    bool have = false;
    HP best{};
    for (const auto &hp : uniq) {
      if (!unvisited.count(hp)) continue;
      const float s = vs.count(hp) ? vs[hp].score : 0.f;
      if (s > best_s) {
        best_s = s;
        best = hp;
        have = true;
      }
    }
    if (!have) break;  // only non-positive scores remain
    std::vector<HP> track;
    HP v = best;
    bool v_ok = true;
    while (v_ok) {
      if (!unvisited.count(v)) break;
      track.push_back(v);
      if (track.size() > uniq.size()) {  // the walk revisits v
        std::memcpy(cycle, best.v, 24);
        std::memcpy(cycle + 6, v.v, 24);
        *out = nullptr;
        *out_len = 0;
        return -1;
      }
      auto it = vs.find(v);
      if (it != vs.end() && it->second.has_prev) {
        v = it->second.prev;
      } else {
        v_ok = false;
      }
    }
    if (track.empty()) break;
    std::reverse(track.begin(), track.end());
    for (const auto &hp : track) unvisited.erase(hp);
    const float bgn_s = vs.count(track[0]) ? vs[track[0]].score : 0.f;
    chains.push_back(Chain{best_s - bgn_s, std::move(track)});
  }

  // serialize
  int64_t words = 1;
  for (const auto &c : chains) words += 2 + 6 * (int64_t)c.track.size();
  uint32_t *blob = (uint32_t *)std::malloc(sizeof(uint32_t) * (size_t)words);
  int64_t p = 0;
  blob[p++] = (uint32_t)chains.size();
  for (const auto &c : chains) {
    std::memcpy(blob + p, &c.score, 4);
    ++p;
    blob[p++] = (uint32_t)c.track.size();
    for (const auto &hp : c.track) {
      std::memcpy(blob + p, hp.v, 24);
      p += 6;
    }
  }
  *out = blob;
  *out_len = words;
  return (int64_t)chains.size();
}
