// Native host-side graph kernels of the PyTorch port (C ABI, loaded via
// ctypes). A copy of the functions of gnn_ecommerce_tpu/native/graph_core.cpp
// that the serving slice calls; the port keeps its own copy so that it
// imports nothing of the JAX package.
//
//   coo_sort_by_dst     stable counting sort of the arc permutation (graph build)
//   pair_aggregate      light users' item-item pairs for the B_ii build
//   pair_count          capacity for pair_aggregate
//   ell_sort_by_degree  degree sort of CSR rows for the ELL plan
//   ell_fill_bin        densify one ELL degree bin
//
// Build: g++ -O3 -shared -fPIC -std=c++17 graph_core.cpp -o libgraph_core.so

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Stable counting sort: fills order[0..n) with a permutation such that
// dst[order] is ascending and equal keys keep input order.
void coo_sort_by_dst(const int64_t* dst, int64_t n, int64_t num_nodes,
                     int64_t* order, int64_t* indptr /* [num_nodes+1] */) {
  std::vector<int64_t> count(num_nodes + 1, 0);
  for (int64_t e = 0; e < n; ++e) count[dst[e] + 1]++;
  for (int64_t v = 0; v < num_nodes; ++v) count[v + 1] += count[v];
  std::memcpy(indptr, count.data(), (num_nodes + 1) * sizeof(int64_t));
  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  for (int64_t e = 0; e < n; ++e) order[cursor[dst[e]]++] = e;
}

// Item-item co-occurrence pairs for the dense 2-hop operator (B_ii) build:
// for each user row of the CSR (indptr over users, item/weight lists), emit
// every ordered pair (item_a, item_b) with value w_a * w_b, then aggregate
// duplicates into a COO sorted by (a, b) via two stable counting-sort passes
// (O(P + I)). Returns the number of unique pairs written to out_*.
//
// Caller guarantees capacity: out arrays sized to total pair count
// P = sum_u deg_u^2 (capacity_hint). Rows with deg > max_deg are skipped
// (they go through the dense matmul path instead).
int64_t pair_aggregate(const int64_t* indptr, int64_t n_rows,
                       const int64_t* items, const float* weights,
                       int64_t n_items, int64_t max_deg, int64_t* out_a,
                       int64_t* out_b, double* out_v) {
  // Pass 1: emit pairs grouped by b (counting sort pass over b built into
  // emission): first count b occurrences.
  std::vector<int64_t> count_b(n_items + 1, 0);
  int64_t total = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t lo = indptr[r], hi = indptr[r + 1], deg = hi - lo;
    if (deg > max_deg) continue;
    for (int64_t q = lo; q < hi; ++q) count_b[items[q] + 1] += deg;
    total += deg * deg;
  }
  for (int64_t v = 0; v < n_items; ++v) count_b[v + 1] += count_b[v];

  std::vector<int64_t> tmp_a(total);
  std::vector<double> tmp_v(total);
  std::vector<int64_t> cursor(count_b.begin(), count_b.end() - 1);
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t lo = indptr[r], hi = indptr[r + 1], deg = hi - lo;
    if (deg > max_deg) continue;
    for (int64_t qb = lo; qb < hi; ++qb) {
      const int64_t b = items[qb];
      const double wb = weights[qb];
      int64_t c = cursor[b];
      for (int64_t qa = lo; qa < hi; ++qa, ++c) {
        tmp_a[c] = items[qa];
        tmp_v[c] = static_cast<double>(weights[qa]) * wb;
      }
      cursor[b] = c;
    }
  }
  // tmp is now sorted by b (stable within b by emission order). Pass 2:
  // stable counting sort by a, aggregating equal (a, b) on the fly is not
  // possible mid-sort, so sort fully then linear-aggregate.
  std::vector<int64_t> count_a(n_items + 1, 0);
  for (int64_t k = 0; k < total; ++k) count_a[tmp_a[k] + 1]++;
  for (int64_t v = 0; v < n_items; ++v) count_a[v + 1] += count_a[v];
  std::vector<int64_t> pos(count_a.begin(), count_a.end() - 1);
  // Scatter b/v into the a-sorted order. Reuse count_b's memory for b's.
  std::vector<int64_t> sorted_b(total);
  std::vector<double> sorted_v(total);
  {
    // b of element k is recoverable: elements are grouped by b; walk groups.
    int64_t b = 0;
    for (int64_t k = 0; k < total; ++k) {
      while (b < n_items && k >= count_b[b + 1]) ++b;
      const int64_t p = pos[tmp_a[k]]++;
      sorted_b[p] = b;
      sorted_v[p] = tmp_v[k];
    }
  }
  // Recover a per element from count_a groups and aggregate duplicates.
  int64_t m = -1, last_a = -1, last_b = -1;
  {
    int64_t a = 0;
    for (int64_t k = 0; k < total; ++k) {
      while (a < n_items && k >= count_a[a + 1]) ++a;
      const int64_t b = sorted_b[k];
      if (a != last_a || b != last_b) {
        ++m;
        out_a[m] = a;
        out_b[m] = b;
        out_v[m] = 0.0;
        last_a = a;
        last_b = b;
      }
      out_v[m] += sorted_v[k];
    }
  }
  return m + 1;
}

// Total pair count for capacity sizing: sum over rows of deg^2 (deg <= max_deg).
int64_t pair_count(const int64_t* indptr, int64_t n_rows, int64_t max_deg) {
  int64_t total = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t deg = indptr[r + 1] - indptr[r];
    if (deg <= max_deg) total += deg * deg;
  }
  return total;
}

// Degree sort for the ELL plan: stable counting sort of rows by degree.
// Writes order [n_rows] (ascending degree, ties in row order) and returns
// the max degree. O(n_rows + max_deg).
int64_t ell_sort_by_degree(const int64_t* indptr, int64_t n_rows,
                           int64_t* order) {
  int64_t max_deg = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t d = indptr[r + 1] - indptr[r];
    if (d > max_deg) max_deg = d;
  }
  std::vector<int64_t> count(max_deg + 2, 0);
  for (int64_t r = 0; r < n_rows; ++r) count[indptr[r + 1] - indptr[r] + 1]++;
  for (int64_t d = 0; d <= max_deg; ++d) count[d + 1] += count[d];
  for (int64_t r = 0; r < n_rows; ++r)
    order[count[indptr[r + 1] - indptr[r]]++] = r;
  return max_deg;
}

// Fill one ELL degree bin: rows = order[lo:hi] (degrees <= W), emit dense
// [nb, W] index/weight blocks (zero padding). One pass over the bin's arcs.
void ell_fill_bin(const int64_t* indptr, const int32_t* src, const float* w,
                  const int64_t* rows, int64_t nb, int64_t W, int32_t* ib,
                  float* wb) {
  std::memset(ib, 0, nb * W * sizeof(int32_t));
  std::memset(wb, 0, nb * W * sizeof(float));
  for (int64_t k = 0; k < nb; ++k) {
    const int64_t r = rows[k], lo = indptr[r], d = indptr[r + 1] - lo;
    int32_t* ibk = ib + k * W;
    float* wbk = wb + k * W;
    for (int64_t j = 0; j < d; ++j) {
      ibk[j] = src[lo + j];
      wbk[j] = w[lo + j];
    }
  }
}

}  // extern "C"
