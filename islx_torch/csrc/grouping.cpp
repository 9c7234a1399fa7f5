// Person grouping on the host: greedy limb assignment + subset merge
// (the port's copy of islx's native/grouping.cpp, same ABI and semantics).
//
// Consumes the fused step's sorted compact connection lists and fixed-K
// peak tables for a whole batch in one call and writes the candidate and
// subset tables of each frame: the C++ form of
// islx_torch/ops/grouping.py::assemble_sorted (reference semantics:
// src/body.py:166-231). The greedy pick and the person merge are
// sequential within a frame, so they run on the host.
//
// ABI (islx_torch/ops/native.py): plain C, raw pointers, caller-allocated
// outputs. Built at first use by islx_torch/ops/_build.py with
// g++ -O3 -shared -fPIC -std=c++17.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Connection {
  double a_gid, b_gid, score;
  int i, j;
};

}  // namespace

extern "C" {

// Returns 0 on success. Per frame f:
//   cand_out[f]   : [max_cand, 4]  (x, y, score, id), n_cand_out[f] rows
//   subset_out[f] : [max_subset, njoint+2], n_subset_out[f] rows
int islx_assemble_batch(
    int B, int C, int K, int L, int M, int njoint,
    const int32_t* xy,       // [B, C, K, 2]
    const float* score,      // [B, C, K]
    const int32_t* count,    // [B, C]
    const int32_t* pair,     // [B, L, M] sorted candidate pair (i*K + j)
    const float* cscore,     // [B, L, M]
    const uint8_t* cok,      // [B, L, M]
    const int32_t* limb_seq, // [L, 2]
    int max_cand, int max_subset,
    double* cand_out,        // [B, max_cand, 4]
    int32_t* n_cand_out,     // [B]
    double* subset_out,      // [B, max_subset, njoint+2]
    int32_t* n_subset_out) { // [B]
  // subset rows: njoint-1 joint slots + (score, parts) == njoint+1 columns
  // (reference src/body.py:182: -1*np.ones((0, njoint+1)))
  const int cols = njoint + 1;
  std::vector<int> id_base(C);
  std::vector<char> used_i(K), used_j(K);
  std::vector<Connection> conns;
  std::vector<double> subset;   // n_rows * cols, column layout [..., score, parts]
  conns.reserve(K);

  for (int f = 0; f < B; ++f) {
    const int32_t* f_xy = xy + (size_t)f * C * K * 2;
    const float* f_score = score + (size_t)f * C * K;
    const int32_t* f_count = count + (size_t)f * C;
    double* f_cand = cand_out + (size_t)f * max_cand * 4;
    double* f_subset = subset_out + (size_t)f * max_subset * cols;

    // ---- candidate table + per-channel global id offsets ----
    int next_id = 0;
    for (int c = 0; c < C; ++c) {
      id_base[c] = next_id;
      int n = f_count[c];
      for (int k = 0; k < n && next_id < max_cand; ++k, ++next_id) {
        double* row = f_cand + (size_t)next_id * 4;
        row[0] = f_xy[(c * K + k) * 2 + 0];
        row[1] = f_xy[(c * K + k) * 2 + 1];
        row[2] = f_score[c * K + k];
        row[3] = next_id;
      }
    }
    n_cand_out[f] = next_id;

    subset.clear();
    int n_rows = 0;

    for (int l = 0; l < L; ++l) {
      const int a_part = limb_seq[l * 2], b_part = limb_seq[l * 2 + 1];
      const int n_a = f_count[a_part], n_b = f_count[b_part];
      if (n_a == 0 || n_b == 0) continue;  // special_k: skipped entirely

      // ---- greedy selection from the pre-sorted compact list ----
      std::fill(used_i.begin(), used_i.end(), 0);
      std::fill(used_j.begin(), used_j.end(), 0);
      conns.clear();
      const int cap = n_a < n_b ? n_a : n_b;
      const size_t base = ((size_t)f * L + l) * M;
      for (int t = 0; t < M; ++t) {
        if (!cok[base + t]) break;  // invalid entries sorted to the tail
        const int p = pair[base + t];
        const int i = p / K, j = p % K;
        if (i >= n_a || j >= n_b) continue;
        if (used_i[i] || used_j[j]) continue;
        used_i[i] = used_j[j] = 1;
        conns.push_back({(double)(id_base[a_part] + i),
                         (double)(id_base[b_part] + j),
                         (double)cscore[base + t], i, j});
        if ((int)conns.size() >= cap) break;
      }

      // ---- subset merge (reference semantics src/body.py:185-225) ----
      const int index_a = a_part, index_b = b_part;
      for (const auto& cn : conns) {
        int found = 0, s1 = -1, s2 = -1;
        for (int r = 0; r < n_rows; ++r) {
          double* row = subset.data() + (size_t)r * cols;
          if (row[index_a] == cn.a_gid || row[index_b] == cn.b_gid) {
            if (found == 0) s1 = r; else if (found == 1) s2 = r;
            ++found;
          }
        }
        if (found == 1) {
          double* row = subset.data() + (size_t)s1 * cols;
          if (row[index_b] != cn.b_gid) {
            row[index_b] = cn.b_gid;
            row[cols - 1] += 1;
            row[cols - 2] += f_cand[(size_t)cn.b_gid * 4 + 2] + cn.score;
          }
        } else if (found >= 2) {
          double* r1 = subset.data() + (size_t)s1 * cols;
          double* r2 = subset.data() + (size_t)s2 * cols;
          bool disjoint = true;
          for (int c = 0; c < cols - 2; ++c)
            if (r1[c] >= 0 && r2[c] >= 0) { disjoint = false; break; }
          if (disjoint) {
            for (int c = 0; c < cols - 2; ++c) r1[c] += r2[c] + 1;
            r1[cols - 2] += r2[cols - 2] + cn.score;
            r1[cols - 1] += r2[cols - 1];
            // delete row s2
            for (int r = s2; r + 1 < n_rows; ++r)
              std::memcpy(subset.data() + (size_t)r * cols,
                          subset.data() + (size_t)(r + 1) * cols,
                          sizeof(double) * cols);
            --n_rows;
            subset.resize((size_t)n_rows * cols);
          } else {
            r1[index_b] = cn.b_gid;
            r1[cols - 1] += 1;
            r1[cols - 2] += f_cand[(size_t)cn.b_gid * 4 + 2] + cn.score;
          }
        } else if (found == 0 && l < njoint - 2) {
          subset.resize((size_t)(n_rows + 1) * cols);
          double* row = subset.data() + (size_t)n_rows * cols;
          for (int c = 0; c < cols; ++c) row[c] = -1.0;
          row[index_a] = cn.a_gid;
          row[index_b] = cn.b_gid;
          row[cols - 1] = 2;
          row[cols - 2] = f_cand[(size_t)cn.a_gid * 4 + 2] +
                          f_cand[(size_t)cn.b_gid * 4 + 2] + cn.score;
          ++n_rows;
        }
      }
    }

    // ---- prune weak rows (src/body.py:227-231) ----
    int out_rows = 0;
    for (int r = 0; r < n_rows && out_rows < max_subset; ++r) {
      const double* row = subset.data() + (size_t)r * cols;
      const double parts = row[cols - 1];
      if (parts < 4 || row[cols - 2] / parts < 0.4) continue;
      std::memcpy(f_subset + (size_t)out_rows * cols, row,
                  sizeof(double) * cols);
      ++out_rows;
    }
    n_subset_out[f] = out_rows;
  }
  return 0;
}

}  // extern "C"
