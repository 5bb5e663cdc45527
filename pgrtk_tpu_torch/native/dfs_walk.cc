// Weighted bidirected DFS walk — native host runtime for the MAP-graph
// layer.  The port's copy of pgrtk_tpu/native/src/dfs_walk.cc (this copy
// also defines pgr_free, which the JAX package's library defines in
// another file).
//
// Exact re-derivation of graph/bundles.py::weighted_dfs_walk, which
// itself reproduces the reference's BiDiGraphWeightedDfs
// (pgr-db/src/graph_utils.rs:63-290): a priority queue of frontier
// nodes keyed on coverage score (ties broken by the node key tuple,
// matching Python's heapq on (-score, node)), each step visiting a node
// and its skew-symmetric reverse together, preferring the
// highest-score successor (stable sort by score only — insertion-order
// ties, the Rust Ord), parent = the ranked in-neighbor with the
// smallest rank scanning node then reverse-node predecessor lists in
// insertion order.
//
// Nodes are pre-interned ids; the caller supplies the reverse-id map
// and CSR adjacency in insertion order (Python dict semantics).  The
// Python walk costs microseconds per node at chromosome scale; this
// runs the same order ~two decades faster so principal-bundle
// decomposition is not floored by the host graph phase.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <queue>
#include <vector>

namespace {

struct Less {
  const uint64_t *keys;  // (n, 3)
  // priority_queue top == "largest": we want top = max score, ties ->
  // lexicographically SMALLEST key tuple (heapq pops the smallest
  // (-score, node) entry)
  bool operator()(const std::pair<int64_t, uint32_t> &a,
                  const std::pair<int64_t, uint32_t> &b) const {
    if (a.first != b.first) return a.first < b.first;
    const uint64_t *ka = keys + 3ull * a.second;
    const uint64_t *kb = keys + 3ull * b.second;
    if (ka[0] != kb[0]) return ka[0] > kb[0];
    if (ka[1] != kb[1]) return ka[1] > kb[1];
    return ka[2] > kb[2];
  }
};

}  // namespace

extern "C" {

void pgr_free(void *p) { std::free(p); }

// Returns a malloc'd blob of int64 rows
// (node, parent|-1, score, is_leaf, rank, branch, branch_rank) in walk
// order; caller frees with pgr_free.
void pgr_dfs_walk(const uint64_t *node_keys, const uint32_t *rev,
                  const int64_t *score, const int64_t *succ_indptr,
                  const uint32_t *succ_idx, const int64_t *pred_indptr,
                  const uint32_t *pred_idx, int64_t n_nodes,
                  uint32_t start, int64_t **out, int64_t *out_len) {
  std::vector<char> discovered(n_nodes, 0);
  std::vector<int64_t> grank(n_nodes, -1);
  grank[start] = 0;
  std::vector<int64_t> rows;
  rows.reserve(7ull * n_nodes);

  Less less{node_keys};
  std::priority_queue<std::pair<int64_t, uint32_t>,
                      std::vector<std::pair<int64_t, uint32_t>>, Less>
      pq(less);

  bool have_next = true;
  uint32_t next = start;
  int64_t current_branch = 0;
  int64_t branch_rank_state = 0;
  std::vector<std::pair<int64_t, uint32_t>> succ_f;
  std::vector<uint32_t> succ_r;

  for (;;) {
    uint32_t node;
    int64_t branch_rank;
    if (have_next) {
      node = next;
      branch_rank = branch_rank_state;
    } else {
      if (pq.empty()) break;
      node = pq.top().second;
      pq.pop();
      branch_rank_state = 0;
      branch_rank = 0;
      ++current_branch;
    }
    int64_t branch = current_branch;

    if (discovered[node]) {
      have_next = false;
      continue;
    }
    discovered[node] = 1;
    uint32_t rnode = rev[node];
    discovered[rnode] = 1;

    succ_f.clear();
    for (int64_t e = succ_indptr[node]; e < succ_indptr[node + 1]; ++e) {
      uint32_t s = succ_idx[e];
      if (s == node || s == rnode) continue;  // self / self-reverse
      if (!discovered[s]) succ_f.emplace_back(score[s], s);
    }
    succ_r.clear();
    for (int64_t e = succ_indptr[rnode]; e < succ_indptr[rnode + 1]; ++e) {
      uint32_t s = succ_idx[e];
      if (s == node || s == rnode) continue;
      if (!discovered[s]) succ_r.push_back(s);
    }

    bool is_leaf = succ_f.empty();
    if (is_leaf) have_next = false;
    if (!succ_f.empty()) {
      // stable sort by score ONLY: equal scores keep insertion order
      // (the Rust WeightedNode Ord); the best is the LAST entry
      std::stable_sort(
          succ_f.begin(), succ_f.end(),
          [](const std::pair<int64_t, uint32_t> &a,
             const std::pair<int64_t, uint32_t> &b) {
            return a.first < b.first;
          });
      next = succ_f.back().second;
      have_next = true;
      succ_f.pop_back();
      for (const auto &s : succ_f) pq.push(s);
    }
    for (uint32_t s : succ_r) pq.push({score[s], s});

    // parent: smallest-rank ranked in-neighbor, strict <, scanning
    // node's preds then rnode's preds in insertion order
    int64_t node_rank = -1;
    int64_t p_node = -1;
    for (int64_t e = pred_indptr[node]; e < pred_indptr[node + 1]; ++e) {
      uint32_t n2 = pred_idx[e];
      int64_t r = grank[n2];
      if (r >= 0 && (node_rank < 0 || r < node_rank)) {
        node_rank = r;
        p_node = n2;
      }
    }
    for (int64_t e = pred_indptr[rnode]; e < pred_indptr[rnode + 1]; ++e) {
      uint32_t n2 = pred_idx[e];
      int64_t r = grank[n2];
      if (r >= 0 && (node_rank < 0 || r < node_rank)) {
        node_rank = r;
        p_node = n2;
      }
    }
    node_rank = (node_rank < 0 ? 0 : node_rank) + 1;
    grank[node] = node_rank;
    grank[rnode] = node_rank;

    ++branch_rank_state;
    rows.push_back((int64_t)node);
    rows.push_back(p_node);
    rows.push_back(score[node]);
    rows.push_back(is_leaf ? 1 : 0);
    rows.push_back(node_rank);
    rows.push_back(branch);
    rows.push_back(branch_rank);
  }

  int64_t *blob = (int64_t *)malloc(sizeof(int64_t) * rows.size());
  for (size_t i = 0; i < rows.size(); ++i) blob[i] = rows[i];
  *out = blob;
  *out_len = (int64_t)rows.size();
}

}  // extern "C"
