// Jonker-Volgenant style optimal linear assignment with cost_limit.
//
// Host source of the port (a copy of the reference package's solver), built
// with the host C++ compiler by rtmodt_tpu_torch/_build.py and loaded with
// ctypes by rtmodt_tpu_torch/ops/lapjv.py. Semantics of
// lap.lapjv(cost, extend_cost=True, cost_limit=...).
//
// Implementation: shortest-augmenting-path with dual potentials (O(n^3)),
// on the standard (r+c)x(r+c) augmentation that encodes extend_cost +
// cost_limit: skipping a row or column costs cost_limit/2 via virtual
// partners, virtual-virtual pairs are free.

#include <cfloat>
#include <cstring>
#include <vector>

namespace {

constexpr double kInf = DBL_MAX / 4;

// Square assignment via shortest augmenting paths with potentials.
// a is n*n row-major; out col_to_row[j] = assigned row (0-based).
void sap_square(int n, const std::vector<double>& a, std::vector<int>& col_to_row) {
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0), minv(n + 1);
  std::vector<int> pcol(n + 1, 0), way(n + 1, 0);
  std::vector<char> used(n + 1);

  for (int i = 1; i <= n; ++i) {
    pcol[0] = i;
    int j0 = 0;
    std::fill(minv.begin(), minv.end(), kInf);
    std::fill(used.begin(), used.end(), 0);
    do {
      used[j0] = 1;
      const int i0 = pcol[j0];
      int j1 = -1;
      double delta = kInf;
      const double* row = a.data() + static_cast<size_t>(i0 - 1) * n;
      for (int j = 1; j <= n; ++j) {
        if (used[j]) continue;
        const double cur = row[j - 1] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= n; ++j) {
        if (used[j]) {
          u[pcol[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (pcol[j0] != 0);
    do {
      const int j1 = way[j0];
      pcol[j0] = pcol[j1];
      j0 = j1;
    } while (j0);
  }

  col_to_row.assign(n, -1);
  for (int j = 1; j <= n; ++j) col_to_row[j - 1] = pcol[j] - 1;
}

}  // namespace

extern "C" {

// Solve assignment on an r x c cost matrix (row-major double).
// Assignments with cost > cost_limit are refused (entry stays -1).
// Returns the total cost of accepted assignments.
double lapjv_solve(int r, int c, const double* cost, double cost_limit,
                   int* row_to_col, int* col_to_row) {
  const int n = r + c;
  const double half = cost_limit < kInf ? cost_limit / 2.0 : kInf / 8;
  std::vector<double> big(static_cast<size_t>(n) * n, 0.0);
  for (int i = 0; i < r; ++i) {
    for (int j = 0; j < n; ++j) {
      big[static_cast<size_t>(i) * n + j] = (j < c) ? cost[static_cast<size_t>(i) * c + j] : half;
    }
  }
  for (int i = r; i < n; ++i) {
    for (int j = 0; j < c; ++j) big[static_cast<size_t>(i) * n + j] = half;
    // bottom-right block stays 0 (virtual-virtual is free)
  }

  std::vector<int> c2r;
  sap_square(n, big, c2r);

  for (int i = 0; i < r; ++i) row_to_col[i] = -1;
  for (int j = 0; j < c; ++j) col_to_row[j] = -1;
  double total = 0.0;
  for (int j = 0; j < c; ++j) {
    const int i = c2r[j];
    if (i >= 0 && i < r) {
      row_to_col[i] = j;
      col_to_row[j] = i;
      total += cost[static_cast<size_t>(i) * c + j];
    }
  }
  return total;
}

}  // extern "C"
