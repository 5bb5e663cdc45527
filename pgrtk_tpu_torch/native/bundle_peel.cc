// Principal-bundle peeling — native host runtime for the MAP-graph
// layer.  The port's copy of pgrtk_tpu/native/src/bundle_peel.cc.
//
// Exact re-derivation of the peel loop in
// graph/bundles.py::get_principal_bundles_from_adj_list (itself
// reproducing pgr-db/src/seq_db.rs:1086-1183): over the filtered main-
// vertex graph, mark terminals (a vertex that branches out, or that has
// a successor with in-degree > 1), then repeatedly peel linear paths —
// start preference: the LAST no-predecessor vertex in node insertion
// order (Python's find_starts().pop()), falling back to the first alive
// vertex in insertion order; a plain DFS runs until it hits a terminal,
// pushing alive successors in reversed insertion order; the peeled path
// and its skew-symmetric reverse (id ^ 1) leave the graph.
//
// The Python/Rust loop recomputes find_starts() after every peel by
// scanning the remaining graph; the selected start is equivalently the
// max-insertion-position member of the zero-alive-pred set, which this
// implementation maintains INCREMENTALLY (alive pred counts decremented
// as predecessors die, ordered set of zero-pred nodes, linked list of
// alive nodes for the first-alive fallback) — same selections, O((N+E)
// log N) instead of O(paths * N * deg).
#include <cstdint>
#include <cstdlib>
#include <set>
#include <vector>

extern "C" {

void pgr_free(void *p);

// order: node ids in g0 insertion order (the alive-iteration order).
// Returns malloc'd blob: [n_paths, then per path: len, ids...].
void pgr_bundle_peel(const int64_t *succ_indptr, const uint32_t *succ_idx,
                     const int64_t *pred_indptr, const uint32_t *pred_idx,
                     const uint32_t *order, int64_t n_nodes, int64_t n_order,
                     int64_t **out, int64_t *out_len) {
  std::vector<char> alive(n_nodes, 0);
  std::vector<int64_t> pos(n_nodes, -1);  // insertion position
  for (int64_t i = 0; i < n_order; ++i) {
    alive[order[i]] = 1;
    pos[order[i]] = i;
  }

  // terminal marking on the UNPEELED graph (seq_db.rs:1116-1123 marks v
  // both when v branches and when some successor has in-degree > 1)
  std::vector<char> terminal(n_nodes, 0);
  for (int64_t i = 0; i < n_order; ++i) {
    uint32_t v = order[i];
    if (succ_indptr[v + 1] - succ_indptr[v] > 1) terminal[v] = 1;
    for (int64_t e = succ_indptr[v]; e < succ_indptr[v + 1]; ++e) {
      uint32_t w = succ_idx[e];
      if (pred_indptr[w + 1] - pred_indptr[w] > 1) terminal[v] = 1;
    }
  }

  // alive predecessor counts (deduped CSR == dict semantics)
  std::vector<int64_t> pred_count(n_nodes, 0);
  for (int64_t i = 0; i < n_order; ++i) {
    uint32_t v = order[i];
    pred_count[v] = pred_indptr[v + 1] - pred_indptr[v];
  }

  // zero-pred alive nodes ordered by insertion position; find_starts()
  // returns them in insertion order and Python pops the LAST -> max
  std::set<int64_t> zero_pred;  // holds insertion positions
  for (int64_t i = 0; i < n_order; ++i)
    if (pred_count[order[i]] == 0) zero_pred.insert(i);

  // linked list of alive insertion positions (first-alive fallback)
  std::vector<int64_t> nxt(n_order + 1), prv(n_order + 1);
  // sentinel n_order acts as head/tail anchor
  for (int64_t i = 0; i <= n_order; ++i) {
    nxt[i] = (i + 1) % (n_order + 1);
    prv[i] = (i + n_order) % (n_order + 1);
  }
  // head = nxt[n_order]

  auto remove_node = [&](uint32_t v) {
    if (!alive[v]) return;
    alive[v] = 0;
    int64_t p = pos[v];
    if (p >= 0) {
      nxt[prv[p]] = nxt[p];
      prv[nxt[p]] = prv[p];
      zero_pred.erase(p);
    }
    for (int64_t e = succ_indptr[v]; e < succ_indptr[v + 1]; ++e) {
      uint32_t w = succ_idx[e];
      if (!alive[w]) continue;
      if (--pred_count[w] == 0) zero_pred.insert(pos[w]);
    }
  };

  std::vector<std::vector<uint32_t>> paths;
  std::vector<int64_t> seen_stamp(n_nodes, -1);
  int64_t stamp = 0;
  std::vector<uint32_t> stack, path;

  for (;;) {
    uint32_t s;
    if (!zero_pred.empty()) {
      s = order[*zero_pred.rbegin()];  // find_starts().pop(): the LAST
    } else if (nxt[n_order] != n_order) {
      s = order[nxt[n_order]];  // next(iter(g1_succ)): first alive
    } else {
      break;
    }

    path.clear();
    stack.clear();
    stack.push_back(s);
    ++stamp;
    while (!stack.empty()) {
      uint32_t v = stack.back();
      stack.pop_back();
      if (seen_stamp[v] == stamp || !alive[v]) continue;
      seen_stamp[v] = stamp;
      path.push_back(v);
      if (terminal[v]) break;
      // Python pushes `reversed(list(g1_succ[v]))`, so the stack pops
      // the insertion-FIRST alive successor first; g1_succ holds only
      // alive targets, which the alive[] filter reproduces exactly
      for (int64_t j = succ_indptr[v + 1] - 1; j >= succ_indptr[v]; --j) {
        uint32_t w = succ_idx[j];
        if (alive[w] && seen_stamp[w] != stamp) stack.push_back(w);
      }
    }
    // path is never empty: s is alive when selected
    for (uint32_t v : path) {
      remove_node(v);
      remove_node(v ^ 1u);  // skew-symmetric reverse leaves too
    }
    paths.push_back(path);
  }

  int64_t total = 1;
  for (auto &p : paths) total += 1 + (int64_t)p.size();
  int64_t *blob = (int64_t *)malloc(sizeof(int64_t) * total);
  int64_t k = 0;
  blob[k++] = (int64_t)paths.size();
  for (auto &p : paths) {
    blob[k++] = (int64_t)p.size();
    for (uint32_t v : p) blob[k++] = v;
  }
  *out = blob;
  *out_len = total;
}

}  // extern "C"
