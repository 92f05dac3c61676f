// Levenshtein edit distance over token-id sequences (C ABI).
//
// The port's copy of the JAX package's native distance (NeMo's word_error_rate
// uses the `editdistance` C++ extension). Tokens are mapped to int32 ids on
// the Python side (one id per distinct word or character), so the core is a
// branch-light two-row DP.
//
// Built by ops/build.py (`host_library("edit_distance")`): g++ -O3 -std=c++17
// -shared -fPIC; loaded by decode/wer.py.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Distance between a[0:na] and b[0:nb].
int64_t edit_distance_i32(const int32_t* a, int64_t na, const int32_t* b,
                          int64_t nb) {
  if (na < nb) {
    std::swap(a, b);
    std::swap(na, nb);
  }
  if (nb == 0) return na;
  std::vector<int64_t> row(static_cast<size_t>(nb) + 1);
  for (int64_t j = 0; j <= nb; ++j) row[j] = j;
  for (int64_t i = 1; i <= na; ++i) {
    int64_t diag = row[0];  // row[j-1] of the previous row
    row[0] = i;
    const int32_t ca = a[i - 1];
    for (int64_t j = 1; j <= nb; ++j) {
      const int64_t up = row[j];
      const int64_t sub = diag + (ca != b[j - 1] ? 1 : 0);
      const int64_t del = up + 1;
      const int64_t ins = row[j - 1] + 1;
      row[j] = std::min(sub, std::min(del, ins));
      diag = up;
    }
  }
  return row[nb];
}

// Batch: sequences are concatenated; offsets give [start, end) per pair.
// Returns the summed distance (the WER numerator); per-pair results are
// written to `out` when non-null.
int64_t edit_distance_batch_i32(const int32_t* data_a, const int64_t* off_a,
                                const int32_t* data_b, const int64_t* off_b,
                                int64_t n_pairs, int64_t* out) {
  int64_t total = 0;
  for (int64_t k = 0; k < n_pairs; ++k) {
    const int64_t d = edit_distance_i32(
        data_a + off_a[k], off_a[k + 1] - off_a[k],
        data_b + off_b[k], off_b[k + 1] - off_b[k]);
    if (out) out[k] = d;
    total += d;
  }
  return total;
}

}  // extern "C"
