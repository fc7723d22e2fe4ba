// Native text parser for CSV / TSV / LibSVM training files (the port's
// copy of lightgbm_tpu/native/parser.cpp; count_dims, parse_dense and
// parse_libsvm parse numbers byte for byte as the JAX package does).
//
// Reference analog: the C++ data-loading path (src/io/parser.cpp
// Parser::CreateParser + CSVParser/TSVParser/LibSVMParser,
// src/io/dataset_loader.cpp ExtractFeaturesFromFile): the device builds
// histograms, but turning gigabytes of text into the raw feature matrix is
// host work and belongs in native code. Python binds via ctypes
// (io_native.py).
//
// Numbers: parse_double computes double(mantissa) / 10^frac for up to 18
// digits, so a value with more than 15 significant digits (a mantissa
// above 2^53) is rounded twice and may land 1 ulp away from strtod. The
// port keeps this: parity with the JAX package is the target.
//
// Build: g++ -O3 -shared -fPIC -std=c++14 (io_native.py, at first use,
// into lightgbm_tpu_torch/_build/).
//
// Exported ABI:
//   parse_dense(path, sep, n_rows, n_cols, out)      CSV/TSV -> row-major
//   parse_libsvm(path, n_rows, n_cols, out)          index:value pairs
//   count_dims(path, sep_out, rows_out, cols_out)    format autodetection
//   parse_dense_range(path, sep, begin, end, n_cols, max_rows, out, next)
//                                                    the whole lines of a
//                                                    byte range (streaming)
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// fast strtod-ish for the common numeric case; falls back to strtod for
// exponents/specials (the reference vendors fast_double_parser for this)
inline const char* parse_double(const char* p, double* out) {
  while (*p == ' ') ++p;
  const char* start = p;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  else if (*p == '+') ++p;
  if ((*p < '0' || *p > '9') && *p != '.') {
    // nan / inf / malformed
    char* end = nullptr;
    double v = std::strtod(start, &end);
    if (end == start) { *out = std::nan(""); return p; }
    *out = v;
    return end;
  }
  uint64_t mant = 0;
  int digits = 0, frac = 0;
  while (*p >= '0' && *p <= '9' && digits < 18) {
    mant = mant * 10 + (*p - '0');
    ++p; ++digits;
  }
  if (*p == '.') {
    ++p;
    while (*p >= '0' && *p <= '9' && digits < 18) {
      mant = mant * 10 + (*p - '0');
      ++p; ++digits; ++frac;
    }
  }
  if (*p == 'e' || *p == 'E' || (*p >= '0' && *p <= '9')) {
    char* end = nullptr;
    double v = std::strtod(start, &end);
    *out = v;
    return end;
  }
  static const double kPow10[19] = {
      1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11,
      1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18};
  double v = static_cast<double>(mant) / kPow10[frac];
  *out = neg ? -v : v;
  return p;
}

// One line [p, line_end) of a delimiter-separated file into `row`
// (n_cols doubles): missing/short fields become NaN.
inline void parse_dense_line(const char* p, const char* line_end, char sep,
                             int64_t n_cols, double* row) {
  for (int64_t c = 0; c < n_cols; ++c) row[c] = std::nan("");
  int64_t c = 0;
  const char* q = p;
  while (q < line_end && c < n_cols) {
    if (*q == sep) { ++c; ++q; continue; }
    double v;
    const char* nq = parse_double(q, &v);
    if (nq == q || nq > line_end) { ++q; continue; }
    row[c] = v;
    q = nq;
  }
}

inline bool read_file(const char* path, std::string* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf->resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(&(*buf)[0], 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

}  // namespace

extern "C" {

// Detect separator (',' or '\t' or ' ' or libsvm=-1), rows, and max column
// count from the file. Returns 0 on success.
int count_dims(const char* path, int* sep_out, int64_t* rows_out,
               int64_t* cols_out) {
  std::string buf;
  if (!read_file(path, &buf)) return 1;
  int64_t rows = 0, cols = 0;
  char sep = 0;
  bool libsvm = false;
  const char* p = buf.c_str();
  const char* end = p + buf.size();
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* next = line_end ? line_end + 1 : end;
    if (!line_end) line_end = end;
    while (line_end > p && line_end[-1] == '\r') --line_end;
    if (line_end > p && *p != '#') {
      if (rows == 0) {
        // sniff the first line: libsvm has "idx:value" tokens
        for (const char* q = p; q < line_end; ++q) {
          if (*q == ':') { libsvm = true; break; }
          if (*q == ',') { sep = ','; break; }
          if (*q == '\t') { sep = '\t'; break; }
        }
        if (!sep && !libsvm) sep = ' ';
      }
      int64_t c = 0;
      if (libsvm) {
        for (const char* q = p; q < line_end; ++q) {
          if (*q == ':') {
            const char* b = q;
            while (b > p && b[-1] >= '0' && b[-1] <= '9') --b;
            int64_t idx = std::atoll(std::string(b, q).c_str());
            if (idx + 1 > c) c = idx + 1;
          }
        }
        c += 1;  // label column
      } else {
        c = 1;
        for (const char* q = p; q < line_end; ++q)
          if (*q == sep) ++c;
      }
      if (c > cols) cols = c;
      ++rows;
    }
    p = next;
  }
  *sep_out = libsvm ? -1 : sep;
  *rows_out = rows;
  *cols_out = cols;
  return 0;
}

// Parse a delimiter-separated file into a pre-allocated row-major
// (n_rows, n_cols) double array. Missing/short fields become NaN.
int parse_dense(const char* path, int sep_ci, int64_t n_rows, int64_t n_cols,
                double* out) {
  std::string buf;
  if (!read_file(path, &buf)) return 1;
  const char sep = static_cast<char>(sep_ci);
  const char* p = buf.c_str();
  const char* end = p + buf.size();
  int64_t r = 0;
  while (p < end && r < n_rows) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* next = line_end ? line_end + 1 : end;
    if (!line_end) line_end = end;
    while (line_end > p && line_end[-1] == '\r') --line_end;
    if (line_end > p && *p != '#') {
      parse_dense_line(p, line_end, sep, n_cols, out + r * n_cols);
      ++r;
    }
    p = next;
  }
  return 0;
}

// Parse a LibSVM file: column 0 of `out` gets the label, feature j goes to
// column j+1. Absent features stay 0 (LibSVM sparse semantics).
int parse_libsvm(const char* path, int64_t n_rows, int64_t n_cols,
                 double* out) {
  std::string buf;
  if (!read_file(path, &buf)) return 1;
  const char* p = buf.c_str();
  const char* end = p + buf.size();
  int64_t r = 0;
  std::memset(out, 0, sizeof(double) * static_cast<size_t>(n_rows * n_cols));
  while (p < end && r < n_rows) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* next = line_end ? line_end + 1 : end;
    if (!line_end) line_end = end;
    while (line_end > p && line_end[-1] == '\r') --line_end;
    if (line_end > p && *p != '#') {
      double* row = out + r * n_cols;
      double label;
      const char* q = parse_double(p, &label);
      row[0] = label;
      while (q < line_end) {
        while (q < line_end && (*q == ' ' || *q == '\t')) ++q;
        if (q >= line_end) break;
        char* colon_end = nullptr;
        long idx = std::strtol(q, &colon_end, 10);
        if (!colon_end || *colon_end != ':') { ++q; continue; }
        q = colon_end + 1;
        double v;
        const char* nq = parse_double(q, &v);
        if (idx + 1 < n_cols && idx >= 0) row[idx + 1] = v;
        q = nq;
      }
      ++r;
    }
    p = next;
  }
  return 0;
}

// Parse the whole lines of bytes [begin, end) of a delimiter-separated file
// into the row-major (max_rows, n_cols) double array `out`, exactly as
// parse_dense parses them (missing/short fields NaN; blank and '#' lines
// skipped). A line counts when its '\n' lies before `end`, or when `end`
// is the end of the file. Stops before the data line that would be row
// `max_rows`. Writes the offset just past the last line consumed to
// *next_out and returns the number of rows written; -1 when the file
// cannot be read.
int64_t parse_dense_range(const char* path, int sep_ci, int64_t begin,
                          int64_t end, int64_t n_cols, int64_t max_rows,
                          double* out, int64_t* next_out) {
  *next_out = begin;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const int64_t size = static_cast<int64_t>(std::ftell(f));
  if (end > size) end = size;
  if (begin >= end) { std::fclose(f); return 0; }
  std::string buf;
  buf.resize(static_cast<size_t>(end - begin));
  std::fseek(f, static_cast<long>(begin), SEEK_SET);
  size_t got = std::fread(&buf[0], 1, buf.size(), f);
  std::fclose(f);
  if (got != buf.size()) return -1;
  const bool at_eof = end == size;
  const char sep = static_cast<char>(sep_ci);
  const char* base = buf.c_str();
  const char* p = base;
  const char* stop = base + buf.size();
  int64_t r = 0;
  while (p < stop) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(stop - p)));
    if (!line_end && !at_eof) break;  // a cut line: the next range's
    const char* next = line_end ? line_end + 1 : stop;
    if (!line_end) line_end = stop;
    while (line_end > p && line_end[-1] == '\r') --line_end;
    if (line_end > p && *p != '#') {
      if (r >= max_rows) break;
      parse_dense_line(p, line_end, sep, n_cols, out + r * n_cols);
      ++r;
    }
    p = next;
  }
  *next_out = begin + static_cast<int64_t>(p - base);
  return r;
}

}  // extern "C"
