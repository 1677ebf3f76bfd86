// Native TreeSHAP — the per-row, per-tree path-dependent SHAP walk
// (copied from h2o3_tpu/native/treeshap.cpp; the algorithm is unchanged).
//
// Reference behavior: h2o-genmodel/src/main/java/hex/genmodel/algos/tree/
// TreeSHAP.java (Lundberg algorithm 2 over node covers), surfaced as
// predict_contributions. The recursion is data-dependent control flow
// with per-row path state, so it runs on the host, parallel over rows.
// Its plain Python version is h2o3_tpu_torch/explain.py _shap_one_tree.
//
// C ABI (ctypes, see h2o3_tpu_torch/native.py): all forest arrays are the
// flattened (T, M) tables of h2o3_tpu_torch/models/tree/compressed.py.

#include <cstring>
#include <cstdint>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

constexpr int MAXP = 72;   // max unique path length (depth<=20 in practice)

struct PE { int d; double z; double o; double w; };

struct Tree {
  const int32_t* feat;
  const int32_t* thresh;
  const uint8_t* na_left;
  const int32_t* left;
  const int32_t* right;
  const float* leaf_val;
  const int32_t* cat_split;
  const float* cover;
};

struct Ctx {
  const int32_t* binned;     // (n, F)
  int F;
  const uint8_t* cat_table;  // (cat_rows, tableB)
  int tableB;
  const int32_t* na_bins;    // (F,)
};

inline void extend(PE* m, int& len, double pz, double po, int pi) {
  m[len].d = pi; m[len].z = pz; m[len].o = po;
  m[len].w = (len == 0) ? 1.0 : 0.0;
  for (int i = len - 1; i >= 0; --i) {
    m[i + 1].w += po * m[i].w * (i + 1) / (double)(len + 1);
    m[i].w = pz * m[i].w * (len - i) / (double)(len + 1);
  }
  ++len;
}

inline void unwind(PE* m, int& len, int i) {
  const int l = len - 1;
  const double one = m[i].o, zero = m[i].z;
  double n = m[l].w;
  for (int j = l - 1; j >= 0; --j) {
    if (one != 0.0) {
      const double tmp = m[j].w;
      m[j].w = n * (l + 1) / ((j + 1) * one);
      n = tmp - m[j].w * zero * (l - j) / (double)(l + 1);
    } else {
      m[j].w = m[j].w * (l + 1) / (zero * (l - j));
    }
  }
  for (int j = i; j < l; ++j) {
    m[j].d = m[j + 1].d; m[j].z = m[j + 1].z; m[j].o = m[j + 1].o;
  }
  --len;
}

inline double unwound_sum(const PE* m, int len, int i) {
  const int l = len - 1;
  const double one = m[i].o, zero = m[i].z;
  double total = 0.0;
  if (one != 0.0) {
    double n = m[l].w;
    for (int j = l - 1; j >= 0; --j) {
      const double tmp = n / ((j + 1) * one);
      total += tmp;
      n = m[j].w - tmp * zero * (l - j);
    }
  } else {
    for (int j = l - 1; j >= 0; --j)
      total += m[j].w / (zero * (l - j));
  }
  return total * (l + 1);
}

void recurse(const Ctx& c, const Tree& t, const int32_t* x, double* phi,
             int node, const PE* parent, int plen,
             double pz, double po, int pi) {
  PE m[MAXP];
  std::memcpy(m, parent, plen * sizeof(PE));
  int len = plen;
  extend(m, len, pz, po, pi);
  const int f = t.feat[node];
  if (f < 0) {                         // leaf
    const double v = t.leaf_val[node];
    for (int i = 1; i < len; ++i)
      phi[m[i].d] += unwound_sum(m, len, i) * (m[i].o - m[i].z) * v;
    return;
  }
  // routing: NA bin, categorical subset, or numeric threshold
  const int b = x[f];
  bool go_left;
  if (b == c.na_bins[f]) {
    go_left = t.na_left[node] != 0;
  } else {
    const int cs = t.cat_split[node];
    if (cs >= 0) {
      const int bb = std::min(b, c.tableB - 1);
      go_left = c.cat_table[(size_t)cs * c.tableB + bb] != 0;
    } else {
      go_left = b <= t.thresh[node];
    }
  }
  const int h = go_left ? t.left[node] : t.right[node];
  const int cold = go_left ? t.right[node] : t.left[node];
  double iz = 1.0, io = 1.0;
  int k = -1;
  for (int i = 1; i < len; ++i)
    if (m[i].d == f) { k = i; break; }
  if (k >= 0) {
    iz = m[k].z; io = m[k].o;
    unwind(m, len, k);
  }
  const double rj = std::max((double)t.cover[node], 1e-12);
  recurse(c, t, x, phi, h, m, len, iz * t.cover[h] / rj, io, f);
  recurse(c, t, x, phi, cold, m, len, iz * t.cover[cold] / rj, 0.0, f);
}

}  // namespace

extern "C" {

// phi must be zero-initialized (n_rows, F+1) float64; contributions for all
// trees accumulate into columns [0, F); callers add the bias afterwards.
void h2o_treeshap(const int32_t* binned, long long n_rows, int F,
                  const int32_t* feat, const int32_t* thresh,
                  const uint8_t* na_left, const int32_t* left,
                  const int32_t* right, const float* leaf_val,
                  const int32_t* cat_split, const uint8_t* cat_table,
                  int tableB, const int32_t* na_bins, const float* cover,
                  int T, int M, double* phi, int nthreads) {
  const Ctx c{binned, F, cat_table, tableB, na_bins};
  nthreads = std::max(1, std::min(nthreads, 64));
  auto worker = [&](long long r0, long long r1) {
    PE root[1];
    for (long long r = r0; r < r1; ++r) {
      const int32_t* x = binned + (size_t)r * F;
      double* ph = phi + (size_t)r * (F + 1);
      for (int ti = 0; ti < T; ++ti) {
        const size_t off = (size_t)ti * M;
        const Tree t{feat + off, thresh + off, na_left + off, left + off,
                     right + off, leaf_val + off, cat_split + off,
                     cover + off};
        recurse(c, t, x, ph, 0, root, 0, 1.0, 1.0, -1);
      }
    }
  };
  if (nthreads == 1 || n_rows < 64) {
    worker(0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  const long long chunk = (n_rows + nthreads - 1) / nthreads;
  for (int i = 0; i < nthreads; ++i) {
    const long long r0 = i * chunk, r1 = std::min<long long>(r0 + chunk, n_rows);
    if (r0 >= r1) break;
    threads.emplace_back(worker, r0, r1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
