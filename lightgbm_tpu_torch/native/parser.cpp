// Native tabular text parsing kernels for the data loader.
//
// Runtime counterpart of the reference's Parser layer
// (ref: src/io/parser.cpp:319 CSVParser/TSVParser/LibSVMParser) — the
// compute path is PyTorch on the card; byte-level IO parsing is the kind
// of host-runtime work that belongs in native code. Compiled on demand by
// lightgbm_tpu_torch/native/__init__.py (g++ -O3 -shared) and driven through
// ctypes over newline-aligned file chunks, so the loader streams with
// bounded memory (two_round loading).
//
// Contract notes:
// - buffers are NUL-terminated by the Python side (strtod may peek past a
//   field's end, never past the terminator);
// - empty fields and na/nan/null tokens parse as NaN;
// - returns the number of rows written; a row is any non-empty line.
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline bool is_na_token(const char* p, const char* q) {
  // "", "na", "nan", "null", "?" (case-insensitive)
  const long n = q - p;
  if (n == 0) return true;
  if (n == 1 && *p == '?') return true;
  char b[5];
  if (n > 4) return false;
  for (long i = 0; i < n; ++i) b[i] = static_cast<char>(std::tolower(p[i]));
  b[n] = '\0';
  return !std::strcmp(b, "na") || !std::strcmp(b, "nan") ||
         !std::strcmp(b, "null");
}

inline const char* field_end(const char* p, const char* end, char sep) {
  while (p < end && *p != sep && *p != '\n' && *p != '\r') ++p;
  return p;
}

inline double parse_field(const char* p, const char* q) {
  while (p < q && (*p == ' ' || *p == '\t')) ++p;
  const char* t = q;
  while (t > p && (t[-1] == ' ' || t[-1] == '\t')) --t;
  if (is_na_token(p, t)) return NAN;
  char* done = nullptr;
  double v = std::strtod(p, &done);
  if (done == p) return NAN;
  return v;
}

}  // namespace

extern "C" {

// Number of sep-separated fields on the first non-empty line.
int64_t lgbm_count_cols(const char* buf, int64_t len, char sep) {
  const char* p = buf;
  const char* end = buf + len;
  while (p < end && (*p == '\n' || *p == '\r')) ++p;
  if (p >= end) return 0;
  int64_t n = 1;
  for (; p < end && *p != '\n'; ++p) n += (*p == sep);
  return n;
}

// Dense CSV/TSV chunk -> row-major out[max_rows * n_cols].
// Missing trailing fields on a short row become NaN.
int64_t lgbm_parse_dense(const char* buf, int64_t len, char sep,
                         int64_t n_cols, double* out, int64_t max_rows) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t r = 0;
  while (p < end && r < max_rows) {
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    double* row = out + r * n_cols;
    int64_t c = 0;
    while (true) {
      const char* q = field_end(p, end, sep);
      if (c < n_cols) row[c] = parse_field(p, q);
      ++c;
      p = q;
      if (p < end && *p == sep) { ++p; continue; }
      break;
    }
    for (; c < n_cols; ++c) row[c] = NAN;
    ++r;
  }
  return r;
}

// LibSVM chunk: "label idx:val idx:val ...". Labels to labels[], feature
// triplets to (rows, cols, vals). Returns rows parsed; *nnz_out = triplets
// written (parsing stops cleanly if max_nnz would overflow — caller sizes
// max_nnz to worst case = number of ':' in the chunk); *max_col_out = max
// feature index seen (or -1).
int64_t lgbm_parse_libsvm(const char* buf, int64_t len, double* labels,
                          int64_t max_rows, int32_t* rows, int32_t* cols,
                          double* vals, int64_t max_nnz, int64_t* nnz_out,
                          int32_t* max_col_out) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t r = 0, k = 0;
  int32_t maxc = -1;
  while (p < end && r < max_rows) {
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    char* done = nullptr;
    labels[r] = std::strtod(p, &done);
    p = (done == p) ? p : done;
    while (p < end && *p != '\n') {
      while (p < end && (*p == ' ' || *p == '\t')) ++p;
      if (p >= end || *p == '\n' || *p == '\r') break;
      const char* q = p;
      while (q < end && *q != ':' && *q != ' ' && *q != '\t' && *q != '\n')
        ++q;
      // non-numeric keys (e.g. qid:) are metadata, not features
      if (q < end && *q == ':' && (std::isdigit(*p) || *p == '+')) {
        long idx = std::strtol(p, nullptr, 10);
        double v = std::strtod(q + 1, &done);
        if (k < max_nnz) {
          rows[k] = static_cast<int32_t>(r);
          cols[k] = static_cast<int32_t>(idx);
          vals[k] = v;
          ++k;
          if (idx > maxc) maxc = static_cast<int32_t>(idx);
        }
        p = done;
      } else {
        // stray token (e.g. qid:7): skip the whole token incl. its value
        while (q < end && *q != ' ' && *q != '\t' && *q != '\n') ++q;
        p = q;
      }
    }
    ++r;
  }
  *nnz_out = k;
  *max_col_out = maxc;
  return r;
}

}  // extern "C"
