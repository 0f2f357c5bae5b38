// Host data loader: libsvm / CSV -> dense float32 matrices.
//
// A copy of the JAX package's native/loader.cpp: a small C++ parser
// behind a C ABI, loaded from Python with ctypes
// (utils/host_native.py), filling host numpy buffers that the chunk
// sources (utils/io.py, utils/hashing.py) hand to the device one chunk
// at a time. The pure-Python parsers remain the portable fallback and
// give the same arrays.
//
// Two access patterns:
//  - whole-file: *_dims() then *_fill() into caller-allocated buffers;
//  - streaming:  reader_open()/reader_next()/reader_close() yields
//    fixed-size row blocks for the out-of-core engines (utils/io.py).
//
// All functions return 0 on success, negative error codes otherwise.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrParse = -2;
constexpr int kErrArg = -3;
// the file holds an embedded NUL byte: every parser here works on
// NUL-terminated line buffers, which would silently truncate the row
// and diverge from the Python fallback — surface a distinct code so
// the ctypes layer can fall back to the Python parsers instead of
// mis-ingesting
constexpr int kErrNul = -4;

// fast float parse: strtof handles inf/nan/exponents; we just wrap it
inline bool parse_float(const char*& p, float* out) {
  char* end = nullptr;
  *out = strtof(p, &end);
  if (end == p) return false;
  p = end;
  return true;
}

inline void skip_ws(const char*& p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
}

struct LineReader {
  FILE* f = nullptr;
  char* buf = nullptr;
  size_t cap = 0;
  bool nul = false;  // an embedded NUL byte ended iteration

  explicit LineReader(const char* path) { f = fopen(path, "rb"); }
  ~LineReader() {
    if (f) fclose(f);
    free(buf);
  }
  bool ok() const { return f != nullptr; }
  // returns nullptr at EOF or on an embedded NUL (check `nul`);
  // strips trailing newline
  const char* next() {
    if (!f || nul) return nullptr;
    ssize_t n = getline(&buf, &cap, f);
    if (n < 0) return nullptr;
    while (n > 0 && (buf[n - 1] == '\n' || buf[n - 1] == '\r')) buf[--n] = 0;
    if (memchr(buf, 0, static_cast<size_t>(n)) != nullptr) {
      nul = true;  // parsers are NUL-terminated-string based: bail
      return nullptr;
    }
    return buf;
  }
};

// CRC-32 (IEEE 802.3), bit-identical to Python's zlib.crc32(data, crc):
// the hashed-CSV reader must produce the same slots/signs as the Python
// FeatureHasher (utils/hashing.py) or native and fallback ingestion
// would silently train on different features.
inline uint32_t crc32_update(uint32_t crc, const char* buf, size_t len) {
  static const auto table = [] {
    std::vector<uint32_t> t(256);
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  crc ^= 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    crc = table[(crc ^ static_cast<uint8_t>(buf[i])) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// per-categorical-column memo: value -> (slot, sign); size-capped like
// the Python FeatureHasher (Criteo columns reach 10M+ uniques)
constexpr size_t kMemoCap = 1u << 20;

// transparent hashing so memo probes take a string_view — the hot
// ingestion loop must not heap-allocate a std::string per categorical
// field just to check the memo (C++20 heterogeneous lookup)
struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view sv) const noexcept {
    return std::hash<std::string_view>{}(sv);
  }
};
struct SvEq {
  using is_transparent = void;
  bool operator()(std::string_view a, std::string_view b) const noexcept {
    return a == b;
  }
};

struct HashedSpec {
  std::vector<int64_t> numeric, categorical;
  int64_t n_hash = 0;
  uint32_t seed = 0;
  char delim = ',';
  int64_t max_col = 0;
  std::vector<std::unordered_map<std::string, std::pair<int64_t, float>,
                                 SvHash, SvEq>>
      memo;
};

// does the line hold anything besides whitespace/comment?
inline bool svm_line_nonempty(const char* line) {
  const char* p = line;
  skip_ws(p);
  return *p != 0 && *p != '#';
}

// parse one libsvm line into y + (idx, val) writes on a dense row
inline int svm_parse_line(const char* line, float* y, float* row,
                          int64_t n_features, int zero_based) {
  const char* p = line;
  skip_ws(p);
  if (!parse_float(p, y)) return kErrParse;
  while (true) {
    skip_ws(p);
    if (*p == 0 || *p == '#') break;
    char* end = nullptr;
    long idx = strtol(p, &end, 10);
    if (end == p || *end != ':') return kErrParse;
    p = end + 1;
    float val;
    if (!parse_float(p, &val)) return kErrParse;
    int64_t j = zero_based ? idx : idx - 1;
    if (j >= 0 && j < n_features) row[j] = val;
  }
  return 0;
}

// parse one CSV line of exactly n_cols floats into dst; trailing
// content (extra columns, trailing commas) is a parse error so ragged
// files fail loudly, matching the numpy fallback
inline int csv_parse_line(const char* line, float* dst, int64_t n_cols) {
  const char* p = line;
  for (int64_t c = 0; c < n_cols; ++c) {
    skip_ws(p);
    if (!parse_float(p, &dst[c])) return kErrParse;
    skip_ws(p);
    if (c + 1 < n_cols) {
      if (*p != ',') return kErrParse;
      ++p;
    }
  }
  skip_ws(p);
  if (*p != 0) return kErrParse;
  return 0;
}

struct Reader {
  LineReader lr;
  int fmt;  // 0 = libsvm, 1 = csv, 2 = hashed csv
  int64_t n_features = 0;
  int64_t n_cols = 0;  // csv: total columns incl. label
  int64_t label_col = -1;
  int zero_based = 0;
  HashedSpec* hspec = nullptr;

  Reader(const char* path, int fmt_) : lr(path), fmt(fmt_) {}
  ~Reader() { delete hspec; }
};

// split a line on spec.delim into (start, len) fields
inline void split_fields(const char* line, char delim,
                         std::vector<std::pair<const char*, size_t>>* out) {
  out->clear();
  const char* start = line;
  const char* p = line;
  for (;; ++p) {
    if (*p == delim || *p == 0) {
      out->emplace_back(start, static_cast<size_t>(p - start));
      if (*p == 0) break;
      start = p + 1;
    }
  }
}

// float() parity with the Python fallback: surrounding whitespace ok,
// anything else trailing is an error; empty field -> 0 handled by the
// caller. strtof extensions Python rejects are rejected here too
// (C99 hex floats); underscored literals are rejected on BOTH paths
// (the fallback mirrors this) so native and Python never diverge.
inline bool parse_field_float(const char* s, size_t len, float* out) {
  // stack buffer: numeric fields are short, and the hot path must not
  // heap-allocate per field; oversized fields take the slow copy
  char stack[64];
  std::string heap;
  const char* p;
  if (len < sizeof(stack)) {
    std::memcpy(stack, s, len);
    stack[len] = 0;
    p = stack;
  } else {
    heap.assign(s, len);
    p = heap.c_str();
  }
  for (size_t i = 0; i < len; ++i)
    if (p[i] == 'x' || p[i] == 'X' || p[i] == '_') return false;
  char* end = nullptr;
  *out = strtof(p, &end);
  if (end == p) return false;
  while (*end == ' ' || *end == '\t') ++end;
  return *end == 0;
}

// one hashed-CSV row: numeric passthrough + signed-hash accumulation.
// xrow must be zeroed by the caller (signs ACCUMULATE into slots).
inline int hashed_parse_row(
    HashedSpec* h,
    const std::vector<std::pair<const char*, size_t>>& fields,
    int64_t label_col, float* xrow, float* y) {
  if (static_cast<int64_t>(fields.size()) <= h->max_col) return kErrParse;
  auto [lp, ll] = fields[label_col];
  if (ll == 0) {
    *y = 0.0f;
  } else if (!parse_field_float(lp, ll, y)) {
    return kErrParse;
  }
  for (size_t j = 0; j < h->numeric.size(); ++j) {
    auto [fp, fl] = fields[h->numeric[j]];
    if (fl == 0) {
      xrow[j] = 0.0f;  // empty field -> 0, the Criteo convention
    } else if (!parse_field_float(fp, fl, &xrow[j])) {
      return kErrParse;
    }
  }
  float* hash_base = xrow + h->numeric.size();
  for (size_t j = 0; j < h->categorical.size(); ++j) {
    auto [fp, fl] = fields[h->categorical[j]];
    std::string_view value(fp, fl);  // no allocation on memo hits
    auto& memo = h->memo[j];
    auto it = memo.find(value);
    int64_t slot;
    float sign;
    if (it != memo.end()) {
      slot = it->second.first;
      sign = it->second.second;
    } else {
      // token layout matches utils/hashing.py: "<j>=<value>" where j
      // is the position within the categorical list
      std::string token = std::to_string(j);
      token += '=';
      token.append(value.data(), value.size());
      slot = crc32_update(h->seed, token.data(), token.size()) % h->n_hash;
      token.push_back('#');
      sign = (crc32_update(h->seed, token.data(), token.size()) & 1)
                 ? 1.0f : -1.0f;
      if (memo.size() < kMemoCap) memo.emplace(std::string(value),
                                               std::make_pair(slot, sign));
    }
    hash_base[slot] += sign;
  }
  return 0;
}

}  // namespace

extern "C" {

// ---- whole-file libsvm -------------------------------------------------

// rows and 1-based max feature index (0 if none)
int svm_dims(const char* path, int zero_based, int64_t* n_rows,
             int64_t* max_feature) {
  LineReader lr(path);
  if (!lr.ok()) return kErrOpen;
  int64_t rows = 0, maxf = 0;
  while (const char* line = lr.next()) {
    if (!svm_line_nonempty(line)) continue;
    ++rows;
    const char* p = line;
    skip_ws(p);
    float dummy;
    if (!parse_float(p, &dummy)) return kErrParse;
    while (true) {
      skip_ws(p);
      if (*p == 0 || *p == '#') break;
      char* end = nullptr;
      long idx = strtol(p, &end, 10);
      if (end == p || *end != ':') return kErrParse;
      p = end + 1;
      float val;
      if (!parse_float(p, &val)) return kErrParse;
      int64_t j = zero_based ? idx + 1 : idx;
      if (j > maxf) maxf = j;
    }
  }
  if (lr.nul) return kErrNul;
  *n_rows = rows;
  *max_feature = maxf;
  return 0;
}

// fill pre-allocated X (n_rows * n_features, zeroed) and y (n_rows)
int svm_fill(const char* path, int zero_based, int64_t n_rows,
             int64_t n_features, float* X, float* y) {
  if (!X || !y || n_features <= 0) return kErrArg;
  LineReader lr(path);
  if (!lr.ok()) return kErrOpen;
  int64_t i = 0;
  while (const char* line = lr.next()) {
    if (!svm_line_nonempty(line)) continue;
    if (i >= n_rows) break;
    int rc = svm_parse_line(line, &y[i], &X[i * n_features], n_features,
                            zero_based);
    if (rc != 0) return rc;
    ++i;
  }
  if (lr.nul) return kErrNul;
  return i == n_rows ? 0 : kErrParse;
}

// non-blank data-line count (hashed-CSV n_rows pass; no float parsing,
// so categorical columns are fine)
int64_t csv_count_rows(const char* path, int skip_header) {
  LineReader lr(path);
  if (!lr.ok()) return kErrOpen;
  int64_t n = 0;
  bool skipped = !skip_header;
  while (const char* line = lr.next()) {
    const char* p = line;
    skip_ws(p);
    if (*p == 0) continue;
    if (!skipped) {
      skipped = true;
      continue;
    }
    ++n;
  }
  if (lr.nul) return kErrNul;
  return n;
}

// ---- whole-file csv ----------------------------------------------------

int csv_dims(const char* path, int skip_header, int64_t* n_rows,
             int64_t* n_cols) {
  LineReader lr(path);
  if (!lr.ok()) return kErrOpen;
  int64_t rows = 0, cols = 0;
  bool first = true;
  while (const char* line = lr.next()) {
    const char* p = line;
    skip_ws(p);
    if (*p == 0) continue;
    if (first) {
      cols = 1;
      for (const char* q = line; *q; ++q)
        if (*q == ',') ++cols;
      first = false;
      if (skip_header) continue;
    }
    ++rows;
  }
  if (lr.nul) return kErrNul;
  *n_rows = rows;
  *n_cols = cols;
  return 0;
}

// fill X (n_rows * (n_cols-1)) and y (n_rows); label_col may be negative
// (python-style, counted from the end)
int csv_fill(const char* path, int skip_header, int64_t label_col,
             int64_t n_rows, int64_t n_cols, float* X, float* y) {
  if (!X || !y || n_cols < 2) return kErrArg;
  int64_t lc = label_col < 0 ? label_col + n_cols : label_col;
  if (lc < 0 || lc >= n_cols) return kErrArg;
  LineReader lr(path);
  if (!lr.ok()) return kErrOpen;
  float* tmp = static_cast<float*>(malloc(sizeof(float) * n_cols));
  if (!tmp) return kErrArg;
  int64_t i = 0;
  bool first = true;
  while (const char* line = lr.next()) {
    const char* p = line;
    skip_ws(p);
    if (*p == 0) continue;
    if (first) {
      first = false;
      if (skip_header) continue;
    }
    if (i >= n_rows) break;
    int rc = csv_parse_line(line, tmp, n_cols);
    if (rc != 0) {
      free(tmp);
      return rc;
    }
    float* xrow = &X[i * (n_cols - 1)];
    int64_t xj = 0;
    for (int64_t c = 0; c < n_cols; ++c) {
      if (c == lc)
        y[i] = tmp[c];
      else
        xrow[xj++] = tmp[c];
    }
    ++i;
  }
  free(tmp);
  if (lr.nul) return kErrNul;
  return i == n_rows ? 0 : kErrParse;
}

// ---- streaming reader --------------------------------------------------

void* reader_open_svm(const char* path, int64_t n_features,
                      int zero_based) {
  Reader* r = new Reader(path, 0);
  if (!r->lr.ok()) {
    delete r;
    return nullptr;
  }
  r->n_features = n_features;
  r->zero_based = zero_based;
  return r;
}

void* reader_open_csv(const char* path, int64_t n_cols, int64_t label_col,
                      int skip_header) {
  Reader* r = new Reader(path, 1);
  if (!r->lr.ok()) {
    delete r;
    return nullptr;
  }
  r->n_cols = n_cols;
  r->n_features = n_cols - 1;
  r->label_col = label_col < 0 ? label_col + n_cols : label_col;
  // An out-of-range label column would make the per-row column split in
  // reader_next write n_cols floats into an (n_cols-1)-wide X row —
  // refuse at open time instead (csv_fill applies the same check).
  if (n_cols < 2 || r->label_col < 0 || r->label_col >= n_cols) {
    delete r;
    return nullptr;
  }
  if (skip_header) {
    // discard the first NON-BLANK line, mirroring csv_dims: a leading
    // blank line must not absorb the skip and leave the header in the
    // data stream
    while (const char* line = r->lr.next()) {
      const char* p = line;
      skip_ws(p);
      if (*p != 0) break;
    }
  }
  return r;
}

void* reader_open_csv_hashed(const char* path, int64_t label_col,
                             const int64_t* numeric, int64_t n_numeric,
                             const int64_t* categorical, int64_t n_cat,
                             int64_t n_hash, int64_t seed, char delim,
                             int skip_header) {
  if (label_col < 0 || n_hash < 2 || (n_numeric <= 0 && n_cat <= 0))
    return nullptr;
  Reader* r = new Reader(path, 2);
  if (!r->lr.ok()) {
    delete r;
    return nullptr;
  }
  auto* h = new HashedSpec;
  h->numeric.assign(numeric, numeric + n_numeric);
  h->categorical.assign(categorical, categorical + n_cat);
  h->n_hash = n_hash;
  h->seed = static_cast<uint32_t>(seed);
  h->delim = delim;
  h->max_col = label_col;
  for (int64_t c : h->numeric) {
    if (c < 0) { delete h; delete r; return nullptr; }
    if (c > h->max_col) h->max_col = c;
  }
  for (int64_t c : h->categorical) {
    if (c < 0) { delete h; delete r; return nullptr; }
    if (c > h->max_col) h->max_col = c;
  }
  h->memo.resize(h->categorical.size());
  r->hspec = h;
  r->label_col = label_col;
  r->n_features = n_numeric + (n_cat > 0 ? n_hash : 0);
  if (skip_header) {
    while (const char* line = r->lr.next()) {
      const char* p = line;
      skip_ws(p);
      if (*p != 0) break;
    }
  }
  return r;
}

// reads up to max_rows rows into X (max_rows * n_features, caller-zeroed
// for libsvm and hashed csv) and y; returns rows read (0 at EOF) or a
// negative error
int64_t reader_next(void* handle, int64_t max_rows, float* X, float* y) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r || !X || !y) return kErrArg;
  float* tmp = nullptr;
  if (r->fmt == 1) {
    tmp = static_cast<float*>(malloc(sizeof(float) * r->n_cols));
    if (!tmp) return kErrArg;
  }
  int64_t i = 0;
  while (i < max_rows) {
    const char* line = r->lr.next();
    if (!line) break;
    const char* p = line;
    skip_ws(p);
    if (*p == 0) continue;
    if (r->fmt == 0) {
      if (!svm_line_nonempty(line)) continue;
      int rc = svm_parse_line(line, &y[i], &X[i * r->n_features],
                              r->n_features, r->zero_based);
      if (rc != 0) return rc;
    } else if (r->fmt == 2) {
      static thread_local std::vector<std::pair<const char*, size_t>>
          fields;
      split_fields(line, r->hspec->delim, &fields);
      int rc = hashed_parse_row(r->hspec, fields, r->label_col,
                                &X[i * r->n_features], &y[i]);
      if (rc != 0) return rc;
    } else {
      int rc = csv_parse_line(line, tmp, r->n_cols);
      if (rc != 0) {
        free(tmp);
        return rc;
      }
      float* xrow = &X[i * r->n_features];
      int64_t xj = 0;
      for (int64_t c = 0; c < r->n_cols; ++c) {
        if (c == r->label_col)
          y[i] = tmp[c];
        else
          xrow[xj++] = tmp[c];
      }
    }
    ++i;
  }
  free(tmp);
  if (r->lr.nul) return kErrNul;
  return i;
}

void reader_close(void* handle) { delete static_cast<Reader*>(handle); }

}  // extern "C"
