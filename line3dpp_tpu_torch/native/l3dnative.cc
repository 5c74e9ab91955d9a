// Native host-side kernels for the irregular, sequential pipeline stages.
//
// The reference implements graph clustering as C++ union-find
// (clustering.cc:6-48, universe.h:49-104); this library is the equivalent
// fast path for the host stage: ops/clustering.py builds it at first use
// (plain g++ -O3, no external dependencies) and falls back to python when it
// cannot.

#include <cstdint>
#include <vector>

namespace {

struct UF {
  std::vector<int32_t> parent;
  std::vector<int32_t> rank;
  std::vector<int64_t> size;
  std::vector<double> threshold;

  explicit UF(int32_t n, float c)
      : parent(n), rank(n, 0), size(n, 1), threshold(n, c) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }

  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    // single-step compression, matching universe.h:70-78 semantics
    parent[x] = root;
    return root;
  }
};

}  // namespace

extern "C" {

// Felzenszwalb clustering over edges pre-sorted by ascending weight.
// Components a, b merge when w <= threshold[a] && w <= threshold[b]; the
// merged root gets threshold = w + c / size (clustering.cc:24-43 with the
// adaptive constant c = 3.0 from line3D.cc:2089).
int l3d_cluster(const int32_t* ei, const int32_t* ej, const float* ew,
                int64_t n_edges, int32_t n_nodes, float c,
                int32_t* labels_out) {
  if (n_nodes <= 0) return 0;
  UF uf(n_nodes, c);
  for (int64_t e = 0; e < n_edges; ++e) {
    int32_t a = uf.find(ei[e]);
    int32_t b = uf.find(ej[e]);
    if (a == b) continue;
    double w = ew[e];
    if (w <= uf.threshold[a] && w <= uf.threshold[b]) {
      int32_t root;
      if (uf.rank[a] > uf.rank[b]) {
        uf.parent[b] = a;
        uf.size[a] += uf.size[b];
        root = a;
      } else {
        uf.parent[a] = b;
        uf.size[b] += uf.size[a];
        if (uf.rank[a] == uf.rank[b]) ++uf.rank[b];
        root = b;
      }
      uf.threshold[root] = w + c / static_cast<double>(uf.size[root]);
    }
  }
  for (int32_t i = 0; i < n_nodes; ++i) labels_out[i] = uf.find(i);
  return 0;
}

}  // extern "C"
