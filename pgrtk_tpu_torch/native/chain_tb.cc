// Host traceback for the batched device chain-DP scorer (ops/chain.py).
//
// Mirrors the reference's iterated best-first chain extraction over
// VALUE-deduplicated anchors (pgr-db/src/aln.rs:105-141): candidate
// order is first appearance in the sorted list, score/prev of a value
// come from its LAST occurrence (the reference's maps are value-keyed).
// The Python implementation of the same walk costs ~1.2 ms per group;
// this runs the whole batch in microseconds per group so the device
// batch path is not floored by host post-processing.
//
// The port's copy of pgrtk_tpu/native/src/chain_tb.cc, with one
// deliberate difference: an exact duplicate anchor that recurs after
// other anchors can make the value-keyed predecessors cycle.  The JAX
// package's walk then loops forever; this one stops when a chain grows
// past the group's distinct anchors and returns the group (ops/chain.py's
// Python traceback raises there too).
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
  uint32_t v[6];
  bool operator==(const Key &o) const {
    return memcmp(v, o.v, sizeof(v)) == 0;
  }
};

struct KeyHash {
  size_t operator()(const Key &k) const {
    uint64_t h = 1469598103934665603ull;
    for (uint32_t x : k.v) {
      h ^= x;
      h *= 1099511628211ull;
    }
    return (size_t)h;
  }
};

}  // namespace

extern "C" {

void pgr_free(void *p);

// anchors: (G, N, 6) u32; valid: (G, N) u8; scores: (G, N) f32;
// prev: (G, N) i32.  Output blob (malloc'd u32 array, *out_len words):
// per group: [n_chains, then per chain: score(f32 bits), m, m*6 coords].
// Returns -1, or the first group whose walk revisits an anchor: *out is
// then NULL and cycle[0..1] hold the slots of the anchor the walk started
// from and of the anchor it revisited (first occurrences).
int64_t pgr_chain_traceback(const uint32_t *anchors, const uint8_t *valid,
                            const float *scores, const int32_t *prev,
                            int64_t G, int64_t N, uint32_t **out,
                            int64_t *out_len, int64_t *cycle) {
  std::vector<uint32_t> blob;
  std::vector<int32_t> uniq_first;   // first index per unique value
  std::vector<int32_t> last_of_idx;  // idx -> last occurrence of its value
  std::vector<int32_t> uniq_of_idx;  // idx -> position in uniq order
  std::vector<uint8_t> unvisited;

  for (int64_t g = 0; g < G; ++g) {
    const uint32_t *A = anchors + g * N * 6;
    const uint8_t *V = valid + g * N;
    const float *S = scores + g * N;
    const int32_t *P = prev + g * N;

    std::unordered_map<Key, int32_t, KeyHash> first_of;
    first_of.reserve((size_t)N * 2);
    uniq_first.clear();
    last_of_idx.assign((size_t)N, -1);
    uniq_of_idx.assign((size_t)N, -1);
    for (int64_t i = 0; i < N; ++i) {
      if (!V[i]) continue;
      Key k;
      memcpy(k.v, A + i * 6, sizeof(k.v));
      auto it = first_of.find(k);
      int32_t uid;
      if (it == first_of.end()) {
        uid = (int32_t)uniq_first.size();
        first_of.emplace(k, uid);
        uniq_first.push_back((int32_t)i);
      } else {
        uid = it->second;
      }
      uniq_of_idx[(size_t)i] = uid;
    }
    // last occurrence per unique value (ascending scan overwrites)
    std::vector<int32_t> last_of_uid(uniq_first.size(), -1);
    for (int64_t i = 0; i < N; ++i) {
      if (V[i]) last_of_uid[(size_t)uniq_of_idx[(size_t)i]] = (int32_t)i;
    }
    size_t n_uniq = uniq_first.size();
    unvisited.assign(n_uniq, 1);

    size_t header_at = blob.size();
    blob.push_back(0);  // n_chains, patched below
    uint32_t n_chains = 0;
    std::vector<int32_t> track;
    size_t n_left = n_uniq;
    while (n_left) {
      float best_s = 0.0f;
      int32_t best_uid = -1;
      for (size_t u = 0; u < n_uniq; ++u) {
        if (!unvisited[u]) continue;
        float s = S[last_of_uid[u]];
        if (s > best_s) {
          best_s = s;
          best_uid = (int32_t)u;
        }
      }
      if (best_uid < 0) break;
      track.clear();
      int32_t uid = best_uid;
      while (uid >= 0 && unvisited[(size_t)uid]) {
        track.push_back(uid);
        if (track.size() > n_uniq) {  // the walk revisits uid
          cycle[0] = uniq_first[(size_t)best_uid];
          cycle[1] = uniq_first[(size_t)uid];
          *out = nullptr;
          *out_len = 0;
          return g;
        }
        int32_t pi = P[last_of_uid[(size_t)uid]];
        uid = pi >= 0 ? uniq_of_idx[(size_t)pi] : -1;
      }
      if (track.empty()) break;
      for (int32_t u : track) {
        unvisited[(size_t)u] = 0;
        --n_left;
      }
      float bgn_s = S[last_of_uid[(size_t)track.back()]];
      float chain_score = best_s - bgn_s;
      uint32_t score_bits;
      memcpy(&score_bits, &chain_score, 4);
      blob.push_back(score_bits);
      blob.push_back((uint32_t)track.size());
      for (auto it2 = track.rbegin(); it2 != track.rend(); ++it2) {
        const uint32_t *row = A + (int64_t)uniq_first[(size_t)*it2] * 6;
        blob.insert(blob.end(), row, row + 6);
      }
      ++n_chains;
    }
    blob[header_at] = n_chains;
  }

  *out_len = (int64_t)blob.size();
  *out = (uint32_t *)std::malloc(blob.size() * sizeof(uint32_t));
  memcpy(*out, blob.data(), blob.size() * sizeof(uint32_t));
  return -1;
}

}  // extern "C"
