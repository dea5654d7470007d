// neklab_tpu native mesh-preprocessing library.
//
// The counterpart of the reference stack's C-level mesh machinery
// (gslib gather-scatter setup, genmap partitioning — SURVEY section 2.2):
// everything here is host-side preprocessing whose cost scales with element
// count and which the Python fallbacks handle too slowly at production mesh
// sizes. Exposed via a plain C ABI, loaded from Python with ctypes.
//
// Components:
//   nt_adjacency_coloring : element adjacency from the global-DOF numbering
//                           (elements sharing a DOF are adjacent) + greedy
//                           colorings of G and G^2 (used by the two-level
//                           pressure-preconditioner probing).
//   nt_rcb_partition      : recursive coordinate bisection of element
//                           centroids into nparts balanced parts (genmap).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// gidx: [nel * npts] global DOF ids. colors2/colors3: [nel] outputs.
// Returns max(ncolors2, 0) on success, -1 on failure.
int64_t nt_adjacency_coloring(int64_t nel, int64_t npts, const int64_t* gidx,
                              int32_t* colors2, int32_t* colors3) {
  // dof -> owning elements
  int64_t nglob = 0;
  for (int64_t i = 0; i < nel * npts; ++i) nglob = std::max(nglob, gidx[i] + 1);
  std::vector<std::vector<int32_t>> owners(nglob);
  {
    std::vector<int64_t> last_seen(nglob, -1);
    for (int64_t e = 0; e < nel; ++e) {
      for (int64_t p = 0; p < npts; ++p) {
        int64_t g = gidx[e * npts + p];
        if (g < 0 || g >= nglob) return -1;
        if (last_seen[g] != e) {  // dedupe within the element
          last_seen[g] = e;
          owners[g].push_back((int32_t)e);
        }
      }
    }
  }
  // adjacency lists (deduped)
  std::vector<std::vector<int32_t>> adj(nel);
  for (int64_t g = 0; g < nglob; ++g) {
    const auto& own = owners[g];
    if (own.size() < 2) continue;
    for (size_t a = 0; a < own.size(); ++a)
      for (size_t b = 0; b < own.size(); ++b)
        if (a != b) adj[own[a]].push_back(own[b]);
  }
  for (auto& v : adj) {
    std::sort(v.begin(), v.end());
    v.erase(std::unique(v.begin(), v.end()), v.end());
  }
  // greedy coloring of G
  auto greedy = [&](const std::vector<std::vector<int32_t>>& a, int32_t* out) {
    int32_t ncol = 0;
    for (int64_t v = 0; v < nel; ++v) {
      std::vector<char> used(ncol + 2, 0);
      for (int32_t u : a[v])
        if (u < v) used[out[u]] = 1;
      int32_t c = 0;
      while (c < (int32_t)used.size() && used[c]) ++c;
      out[v] = c;
      ncol = std::max(ncol, c + 1);
    }
    return ncol;
  };
  int64_t nc2 = greedy(adj, colors2);
  // squared graph (distance <= 2)
  std::vector<std::vector<int32_t>> adj2(nel);
  for (int64_t v = 0; v < nel; ++v) {
    std::vector<int32_t> s(adj[v]);
    for (int32_t u : adj[v]) s.insert(s.end(), adj[u].begin(), adj[u].end());
    std::sort(s.begin(), s.end());
    s.erase(std::unique(s.begin(), s.end()), s.end());
    s.erase(std::remove(s.begin(), s.end(), (int32_t)v), s.end());
    adj2[v] = std::move(s);
  }
  greedy(adj2, colors3);
  return nc2;
}

// Recursive coordinate bisection: centroids [nel * ndim], part out [nel].
static void rcb_recurse(std::vector<int32_t>& ids, const double* c, int ndim,
                        int64_t nel, int32_t p0, int32_t nparts, int32_t* part) {
  if (nparts == 1) {
    for (int32_t e : ids) part[e] = p0;
    return;
  }
  // widest dimension of this subset
  int best = 0;
  double best_span = -1;
  for (int d = 0; d < ndim; ++d) {
    double lo = 1e300, hi = -1e300;
    for (int32_t e : ids) {
      double v = c[(int64_t)e * ndim + d];
      lo = std::min(lo, v); hi = std::max(hi, v);
    }
    if (hi - lo > best_span) { best_span = hi - lo; best = d; }
  }
  int32_t nleft = nparts / 2;
  size_t split = ids.size() * nleft / nparts;
  std::nth_element(ids.begin(), ids.begin() + split, ids.end(),
                   [&](int32_t a, int32_t b) {
                     return c[(int64_t)a * ndim + best] < c[(int64_t)b * ndim + best];
                   });
  std::vector<int32_t> left(ids.begin(), ids.begin() + split);
  std::vector<int32_t> right(ids.begin() + split, ids.end());
  rcb_recurse(left, c, ndim, nel, p0, nleft, part);
  rcb_recurse(right, c, ndim, nel, p0 + nleft, nparts - nleft, part);
}

void nt_rcb_partition(int64_t nel, int32_t ndim, const double* centroids,
                      int32_t nparts, int32_t* part) {
  std::vector<int32_t> ids(nel);
  for (int64_t i = 0; i < nel; ++i) ids[i] = (int32_t)i;
  rcb_recurse(ids, centroids, ndim, nel, 0, nparts, part);
}

}  // extern "C"
