// Native host-side graph kernels of the PyTorch port (C ABI, loaded via
// ctypes). A copy of the functions of gnn_ecommerce_tpu/native/graph_core.cpp
// that the port calls; the port keeps its own copy so that it imports
// nothing of the JAX package.
//
//   coo_sort_by_dst     stable counting sort of the arc permutation (graph build)
//   groupby_edges       (user, item) -> sum(weight), any(purchased) on factorized
//                       id codes, summed in event order (event -> edge ETL)
//   read_events_csv     multithreaded reader of an event CSV's id and type columns
//   pair_aggregate      light users' item-item pairs for the B_ii build
//   pair_count          capacity for pair_aggregate
//   ell_sort_by_degree  degree sort of CSR rows for the ELL plan
//   ell_fill_bin        densify one ELL degree bin
//   bfs_batch           multithreaded per-source BFS with parent pointers
//                       (shortest-path explanations)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread graph_core.cpp -o libgraph_core.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
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

// Aggregate (u, i) pairs: weight sums and purchased-any, emitted in
// lexicographic (u, i) order. u in [0, n_u), i in [0, n_i) (factorized
// codes). Returns the number of unique pairs; out arrays must have
// capacity n (worst case all pairs unique).
int64_t groupby_edges(const int64_t* u, const int64_t* i, const double* w,
                      const uint8_t* purchased, int64_t n, int64_t n_u,
                      int64_t n_i, int64_t* out_u, int64_t* out_i,
                      double* out_w, uint8_t* out_p) {
  // Two-pass stable counting sort on (i, then u) -> (u, i) lexicographic.
  std::vector<int64_t> tmp(n), order(n);
  {
    std::vector<int64_t> count(n_i + 1, 0);
    for (int64_t e = 0; e < n; ++e) count[i[e] + 1]++;
    for (int64_t v = 0; v < n_i; ++v) count[v + 1] += count[v];
    for (int64_t e = 0; e < n; ++e) tmp[count[i[e]]++] = e;
  }
  {
    std::vector<int64_t> count(n_u + 1, 0);
    for (int64_t e = 0; e < n; ++e) count[u[e] + 1]++;
    for (int64_t v = 0; v < n_u; ++v) count[v + 1] += count[v];
    for (int64_t k = 0; k < n; ++k) order[count[u[tmp[k]]]++] = tmp[k];
  }
  int64_t m = -1;
  int64_t last_u = -1, last_i = -1;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t e = order[k];
    if (u[e] != last_u || i[e] != last_i) {
      ++m;
      last_u = u[e];
      last_i = i[e];
      out_u[m] = last_u;
      out_i[m] = last_i;
      out_w[m] = 0.0;
      out_p[m] = 0;
    }
    out_w[m] += w[e];
    out_p[m] |= purchased[e];
  }
  return m + 1;
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

// Batched BFS over an undirected CSR graph. For each source s (with targets
// targets[t_indptr[s]..t_indptr[s+1]]), run one frontier BFS up to `cutoff`
// hops, then emit per target: distance (or -1) and the path node sequence.
//
// Outputs, indexed by the target's global position t:
//   dist_out[t]                      hop count or -1
//   path_out[t*(cutoff+1) .. ]       node ids, path_len = dist+1 entries
//
// A node's parent is the first frontier node (in frontier order, then CSR
// order) that reaches it. Each source is run by one worker, so the paths do
// not depend on the number of threads. Workers take sources from an atomic
// counter; each owns dist/parent arrays of size N, re-initialized per
// source by an epoch stamp (no O(N) clear between sources).
void bfs_batch(const int64_t* indptr, const int64_t* indices, int64_t n_nodes,
               const int64_t* sources, int64_t n_sources,
               const int64_t* t_indptr, const int64_t* targets,
               int64_t cutoff, int64_t n_threads, int64_t* dist_out,
               int64_t* path_out) {
  std::atomic<int64_t> next{0};
  if (n_threads <= 0) n_threads = 1;

  auto worker = [&]() {
    std::vector<int64_t> seen_epoch(n_nodes, -1);
    std::vector<int64_t> dist(n_nodes), parent(n_nodes);
    std::vector<int64_t> frontier, next_frontier;
    int64_t epoch = 0;

    for (;;) {
      const int64_t s_idx = next.fetch_add(1);
      if (s_idx >= n_sources) break;
      const int64_t s = sources[s_idx];
      const int64_t t_lo = t_indptr[s_idx], t_hi = t_indptr[s_idx + 1];
      if (t_lo == t_hi) continue;

      int64_t remaining = 0;
      for (int64_t t = t_lo; t < t_hi; ++t)
        if (targets[t] != s) ++remaining;

      ++epoch;
      seen_epoch[s] = epoch;
      dist[s] = 0;
      parent[s] = -1;
      frontier.clear();
      frontier.push_back(s);

      for (int64_t d = 0; d < cutoff && remaining > 0 && !frontier.empty();
           ++d) {
        next_frontier.clear();
        for (const int64_t v : frontier) {
          for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p) {
            const int64_t nb = indices[p];
            if (seen_epoch[nb] == epoch) continue;
            seen_epoch[nb] = epoch;
            dist[nb] = d + 1;
            parent[nb] = v;
            next_frontier.push_back(nb);
          }
        }
        frontier.swap(next_frontier);
        for (int64_t t = t_lo; t < t_hi; ++t) {
          const int64_t tgt = targets[t];
          if (tgt != s && seen_epoch[tgt] == epoch && dist[tgt] == d + 1)
            --remaining;
        }
      }

      for (int64_t t = t_lo; t < t_hi; ++t) {
        const int64_t tgt = targets[t];
        int64_t* path = path_out + t * (cutoff + 1);
        if (tgt == s) {
          dist_out[t] = 0;
          path[0] = s;
          continue;
        }
        if (seen_epoch[tgt] != epoch) {
          dist_out[t] = -1;
          continue;
        }
        const int64_t d = dist[tgt];
        dist_out[t] = d;
        int64_t v = tgt;
        for (int64_t k = d; k >= 0; --k) {
          path[k] = v;
          v = parent[v];
        }
      }
    }
  };

  std::vector<std::thread> threads;
  for (int64_t k = 0; k < n_threads; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Multithreaded CSV event-log reader.
//
// The reference's ETL reads the 2.43 GB raw event CSV through single-threaded
// pandas (notebooks/0.eda.ipynb cell 7); this extracts three columns —
// integer user id, integer item id, and a small-cardinality event-type
// string mapped to a code — straight from the mmap-able byte buffer.
//
// CSV handling: fields split on ',' outside double quotes; '"' toggles a
// quote state (quoted commas in other columns, e.g. brand/category, are
// skipped correctly); rows with missing/non-integer id fields get id -1
// (caller drops them). Event-type strings are interned into a tiny global
// table (≤ MAX_TYPES) under a mutex — insertions are rare (4 types in the
// reference data).
//
// LIMITATION: row splitting is on raw '\n' and does NOT honor quote state,
// so a quoted field containing an embedded newline splits its row into
// fragments (usually dropped via id -1). The Python caller compares parsed
// rows against the file's raw line count and falls back to a plain CSV
// parser on any non-trivial drop ratio, so such files are handled correctly
// end to end.
// ---------------------------------------------------------------------------

static const int64_t MAX_TYPES = 32;
static const int64_t TYPE_NAME_LEN = 64;

// Parse a signed integer field [p, end); returns -1 on empty/invalid.
static inline int64_t parse_id(const char* p, const char* end) {
  if (p < end && *p == '"') ++p;
  if (p < end && end[-1] == '"') --end;
  if (p >= end) return -1;
  int64_t sign = 1;
  if (*p == '-') { sign = -1; ++p; }
  int64_t v = 0;
  bool any = false;
  for (; p < end; ++p) {
    if (*p < '0' || *p > '9') {
      if (*p == '.') break;  // "12345.0" floats from pandas round-trips
      return -1;
    }
    v = v * 10 + (*p - '0');
    any = true;
  }
  return any ? sign * v : -1;
}

struct TypeTable {
  char names[MAX_TYPES][TYPE_NAME_LEN];
  int64_t lens[MAX_TYPES];
  std::atomic<int64_t> n{0};
  std::mutex mu;

  uint8_t intern(const char* p, int64_t len) {
    if (len >= TYPE_NAME_LEN) len = TYPE_NAME_LEN - 1;
    int64_t cur = n.load(std::memory_order_acquire);
    for (int64_t k = 0; k < cur; ++k)
      if (lens[k] == len && std::memcmp(names[k], p, len) == 0) return (uint8_t)k;
    std::lock_guard<std::mutex> g(mu);
    cur = n.load(std::memory_order_relaxed);
    for (int64_t k = 0; k < cur; ++k)
      if (lens[k] == len && std::memcmp(names[k], p, len) == 0) return (uint8_t)k;
    if (cur >= MAX_TYPES) return (uint8_t)(MAX_TYPES - 1);
    std::memcpy(names[cur], p, len);
    names[cur][len] = 0;
    lens[cur] = len;
    n.store(cur + 1, std::memory_order_release);
    return (uint8_t)cur;
  }
};

// Parse one CSV row in [p, row_end); extract the three wanted columns.
static inline void parse_row(const char* p, const char* row_end, int64_t col_u,
                             int64_t col_i, int64_t col_t, TypeTable* types,
                             int64_t* u, int64_t* it, uint8_t* tc) {
  int64_t col = 0;
  bool quoted = false;
  const char* field = p;
  *u = -1; *it = -1; *tc = 255;
  for (const char* q = p;; ++q) {
    if (q < row_end && *q == '"') { quoted = !quoted; continue; }
    if (q < row_end && (*q != ',' || quoted)) continue;
    // field = [field, q)
    const char* fe = q;
    if (col == col_u) *u = parse_id(field, fe);
    else if (col == col_i) *it = parse_id(field, fe);
    else if (col == col_t) {
      const char* fp = field;
      if (fp < fe && *fp == '"') ++fp;
      if (fp < fe && fe[-1] == '"') --fe;
      *tc = types->intern(fp, fe - fp);
    }
    ++col;
    field = q + 1;
    if (q >= row_end) break;
  }
}

// Read events from a CSV byte buffer (header already skipped by the caller:
// `data` starts at the first data row). Returns the number of rows parsed.
// out arrays must hold at least the newline count of `data` + 1 entries.
int64_t read_events_csv(const char* data, int64_t size, int64_t col_u,
                        int64_t col_i, int64_t col_t, int64_t n_threads,
                        int64_t* out_u, int64_t* out_i, uint8_t* out_t,
                        char* type_names /* [MAX_TYPES * TYPE_NAME_LEN] */,
                        int64_t* n_types) {
  if (size <= 0) { *n_types = 0; return 0; }
  TypeTable types;
  if (n_threads < 1) n_threads = 1;
  // Split into byte ranges aligned to newlines.
  std::vector<int64_t> starts(n_threads + 1, 0);
  for (int64_t k = 1; k < n_threads; ++k) {
    int64_t pos = size * k / n_threads;
    if (pos < 1) pos = 1;  // data[pos - 1] below must stay in-bounds
    while (pos < size && data[pos - 1] != '\n') ++pos;
    starts[k] = pos;
  }
  starts[n_threads] = size;
  // Pass 1: count rows per range (memchr newline scan).
  std::vector<int64_t> rows(n_threads, 0);
  {
    std::vector<std::thread> ths;
    for (int64_t k = 0; k < n_threads; ++k)
      ths.emplace_back([&, k] {
        const char* p = data + starts[k];
        const char* end = data + starts[k + 1];
        int64_t c = 0;
        while (p < end) {
          const char* nl = (const char*)memchr(p, '\n', end - p);
          if (!nl) { if (end > p) ++c; break; }
          ++c;
          p = nl + 1;
        }
        rows[k] = c;
      });
    for (auto& t : ths) t.join();
  }
  std::vector<int64_t> row_off(n_threads + 1, 0);
  for (int64_t k = 0; k < n_threads; ++k) row_off[k + 1] = row_off[k] + rows[k];
  // Pass 2: parse.
  {
    std::vector<std::thread> ths;
    for (int64_t k = 0; k < n_threads; ++k)
      ths.emplace_back([&, k] {
        const char* p = data + starts[k];
        const char* end = data + starts[k + 1];
        int64_t r = row_off[k];
        while (p < end) {
          const char* nl = (const char*)memchr(p, '\n', end - p);
          const char* row_end = nl ? nl : end;
          if (row_end > p && row_end[-1] == '\r') --row_end;
          if (row_end > p)
            parse_row(p, row_end, col_u, col_i, col_t, &types,
                      &out_u[r], &out_i[r], &out_t[r]);
          else { out_u[r] = -1; out_i[r] = -1; out_t[r] = 255; }
          ++r;
          if (!nl) break;
          p = nl + 1;
        }
      });
    for (auto& t : ths) t.join();
  }
  int64_t nt = types.n.load();
  for (int64_t k = 0; k < nt; ++k)
    std::memcpy(type_names + k * TYPE_NAME_LEN, types.names[k], TYPE_NAME_LEN);
  *n_types = nt;
  return row_off[n_threads];
}

}  // extern "C"
