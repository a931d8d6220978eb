// Native RCV1/LIBSVM-style parser: text rows -> CSR arrays, and the CSR ->
// padded [N, P] pack.
//
// The port's own copy of the JAX package's parser (same scan, same pack,
// same ABI), so both packages read a corpus into the same arrays bit for
// bit.  Lines are "docid  f:v f:v ..." (the reference's RCV1 vectors,
// utils/Dataset.scala:19-34); they are parsed straight into flat CSR
// buffers (int32 col ids, f32 values, int64 row offsets) by a chunked
// multi-threaded scan, the layout the pack (data/rcv1.py pack_csr) reads.
//
// C ABI only, loaded through ctypes (data/_native/__init__.py), built
// with g++ on the host at first use.

#include <algorithm>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Floating-point std::from_chars needs libstdc++ >= 11 (__cpp_lib_to_chars);
// older toolchains (GCC 10) only have the integer overloads.  The shim
// below reproduces the from_chars contract the parser
// relies on — single token, NO leading whitespace, NO leading '+', ptr
// advanced past exactly the consumed characters, ptr == first on failure —
// on top of strtof (bounded copy; number tokens in these files are short).
#if defined(__cpp_lib_to_chars)
inline const char* parse_float(const char* first, const char* last, float& v) {
  auto r = std::from_chars(first, last, v, std::chars_format::general);
  return r.ptr;
}
#else
#include <locale.h>
inline const char* parse_float(const char* first, const char* last, float& v) {
  if (first >= last) return first;
  // from_chars parity: strtof would skip whitespace and accept a leading
  // '+'/"inf"/"nan"/hex — reject everything a LIBSVM value can't start with
  const char c = *first;
  if (!((c >= '0' && c <= '9') || c == '-' || c == '.')) return first;
  char buf[64];
  size_t n = static_cast<size_t>(last - first);
  if (n > sizeof(buf) - 1) n = sizeof(buf) - 1;
  memcpy(buf, first, n);
  buf[n] = '\0';
  // from_chars parity, continued: strtof reads "0x10" as hex (from_chars
  // general format stops after the "0") — truncate at the 'x' so both
  // build paths advance identically
  size_t digit0 = (buf[0] == '-') ? 1 : 0;
  if (buf[digit0] == '0' && (buf[digit0 + 1] == 'x' || buf[digit0 + 1] == 'X'))
    buf[digit0 + 1] = '\0';
  // strtof is locale-dependent (a de_DE LC_NUMERIC expects ',' and would
  // truncate "3.14" to 3.0); parse under an explicit "C" locale so an
  // embedding process's setlocale() cannot corrupt the data path
  static locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  char* endp = nullptr;
  float out = strtof_l(buf, &endp, c_loc);
  if (endp == buf) return first;
  v = out;
  return first + (endp - buf);
}
#endif

struct ChunkOut {
  std::vector<int32_t> doc_ids;
  std::vector<int64_t> row_nnz;
  std::vector<int32_t> col_idx;
  std::vector<float> values;
  int64_t skipped_lines = 0;
};

// Parse [begin, end) which is aligned to line boundaries.
//
// Number parsing uses std::from_chars (single-pass, locale-free) — on this
// toolchain it is several times faster than strtol/strtof, and the float
// overload accepts both fixed and scientific forms (chars_format::general).
// Unlike strtol/strtof, from_chars accepts neither leading whitespace nor a
// leading '+', so both are skipped explicitly where the old functions
// tolerated them (line start and after ':').
void parse_chunk(const char* begin, const char* end, int32_t index_offset,
                 ChunkOut* out) {
  const char* p = begin;
  while (p < end) {
    // skip blank lines and leading whitespace
    while (p < end && (*p == '\n' || *p == '\r' || *p == ' ' || *p == '\t')) ++p;
    if (p >= end) break;
    // doc id
    if (*p == '+') ++p;
    long doc = 0;
    auto rd = std::from_chars(p, end, doc);
    if (rd.ptr == p) {  // not a number: skip the malformed line entirely.
      // Counted so callers can observe the divergence from the python
      // fallback / reference (Dataset.scala:24), which raise here instead.
      ++out->skipped_lines;
      while (p < end && *p != '\n') ++p;
      continue;
    }
    p = rd.ptr;
    out->doc_ids.push_back(static_cast<int32_t>(doc));
    int64_t nnz = 0;
    // feature:value pairs until end of line
    while (p < end && *p != '\n') {
      while (p < end && *p == ' ') ++p;
      if (p >= end || *p == '\n' || *p == '\r') break;
      long feat = 0;
      auto rf = std::from_chars(p, end, feat);
      if (rf.ptr == p) {  // malformed token; skip to next space/newline
        while (p < end && *p != ' ' && *p != '\n') ++p;
        continue;
      }
      p = rf.ptr;
      if (p < end && *p == ':') {
        ++p;
        if (p < end && *p == '+') ++p;
        float v = 0.0f;
        const char* rv = parse_float(p, end, v);
        if (rv == p) {  // malformed value; drop token
          while (p < end && *p != ' ' && *p != '\n') ++p;
          continue;
        }
        p = rv;
        out->col_idx.push_back(static_cast<int32_t>(feat) + index_offset);
        out->values.push_back(v);
        ++nnz;
      }
      // token without ':' (e.g. the reference's dropped parts(1)) is skipped
    }
    out->row_nnz.push_back(nnz);
    while (p < end && *p != '\n') ++p;  // consume rest of line
  }
}

}  // namespace

extern "C" {

// Bumped on every CsrResult/function-signature change.  The ctypes loader
// refuses (and rebuilds) a library reporting a different version: an
// mtime staleness check alone cannot catch a stale prebuilt .so whose
// timestamp was normalized by a copy.
int32_t dsgd_abi_version() { return 2; }

struct CsrResult {
  int64_t n_rows;
  int64_t nnz;
  int32_t* doc_ids;  // [n_rows]
  int64_t* row_ptr;  // [n_rows + 1]
  int32_t* col_idx;  // [nnz]
  float* values;     // [nnz]
  int64_t skipped_lines;  // malformed (non-numeric doc id) lines dropped
};

// Parse a whole file. index_offset is added to every feature id (use -1 to
// convert the file's 1-based ids to 0-based). Returns nullptr on I/O error.
CsrResult* dsgd_parse_svm(const char* path, int n_threads,
                          int32_t index_offset) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size));
  if (size > 0 && fread(buf.data(), 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  if (n_threads < 1) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? static_cast<int>(hw) : 1;
  }
  // chunk boundaries aligned to newlines
  std::vector<const char*> bounds;
  const char* base = buf.data();
  const char* fend = base + size;
  bounds.push_back(base);
  for (int t = 1; t < n_threads; ++t) {
    const char* guess = base + size * t / n_threads;
    while (guess < fend && *guess != '\n') ++guess;
    if (guess < fend) ++guess;
    bounds.push_back(guess);
  }
  bounds.push_back(fend);

  std::vector<ChunkOut> outs(bounds.size() - 1);
  std::vector<std::thread> threads;
  for (size_t t = 0; t + 1 < bounds.size(); ++t) {
    if (bounds[t] >= bounds[t + 1]) continue;
    threads.emplace_back(parse_chunk, bounds[t], bounds[t + 1], index_offset,
                         &outs[t]);
  }
  for (auto& th : threads) th.join();

  auto* res = static_cast<CsrResult*>(malloc(sizeof(CsrResult)));
  int64_t n_rows = 0, nnz = 0, skipped = 0;
  for (auto& o : outs) {
    n_rows += static_cast<int64_t>(o.doc_ids.size());
    nnz += static_cast<int64_t>(o.values.size());
    skipped += o.skipped_lines;
  }
  res->n_rows = n_rows;
  res->nnz = nnz;
  res->skipped_lines = skipped;
  res->doc_ids = static_cast<int32_t*>(malloc(sizeof(int32_t) * n_rows));
  res->row_ptr = static_cast<int64_t*>(malloc(sizeof(int64_t) * (n_rows + 1)));
  res->col_idx = static_cast<int32_t*>(malloc(sizeof(int32_t) * (nnz ? nnz : 1)));
  res->values = static_cast<float*>(malloc(sizeof(float) * (nnz ? nnz : 1)));

  int64_t row_at = 0, nz_at = 0;
  res->row_ptr[0] = 0;
  for (auto& o : outs) {
    if (!o.doc_ids.empty()) {
      memcpy(res->doc_ids + row_at, o.doc_ids.data(),
             sizeof(int32_t) * o.doc_ids.size());
    }
    for (size_t i = 0; i < o.row_nnz.size(); ++i) {
      res->row_ptr[row_at + 1] = res->row_ptr[row_at] + o.row_nnz[i];
      ++row_at;
    }
    if (!o.values.empty()) {
      memcpy(res->col_idx + nz_at, o.col_idx.data(),
             sizeof(int32_t) * o.col_idx.size());
      memcpy(res->values + nz_at, o.values.data(),
             sizeof(float) * o.values.size());
      nz_at += static_cast<int64_t>(o.values.size());
    }
  }
  return res;
}

void dsgd_free_csr(CsrResult* r) {
  if (!r) return;
  free(r->doc_ids);
  free(r->row_ptr);
  free(r->col_idx);
  free(r->values);
  free(r);
}

// CSR -> padded [n_rows, p] pack (the layout ops/sparse.py kernels consume).
// out_idx / out_val must be zero-initialized by the caller.  Rows with
// nnz <= p are straight memcpys; wider rows keep their p largest-|value|
// features in ascending-column order (matching the numpy fallback in
// data/rcv1.py pack_csr).  Returns the number of truncated rows.
//
// It takes the place of the numpy scatter pack (data/rcv1.py), whose
// np.repeat index expansion is the slowest stage of a full-scale load.
int64_t dsgd_pack_csr(int64_t n_rows, const int64_t* row_ptr,
                      const int32_t* col_idx, const float* values, int64_t p,
                      int32_t* out_idx, float* out_val) {
  int64_t truncated = 0;
  std::vector<int32_t> order;  // scratch for truncation rows only
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t s = row_ptr[r], e = row_ptr[r + 1];
    const int64_t nnz = e - s;
    int32_t* oi = out_idx + r * p;
    float* ov = out_val + r * p;
    if (nnz <= p) {
      if (nnz > 0) {
        memcpy(oi, col_idx + s, sizeof(int32_t) * nnz);
        memcpy(ov, values + s, sizeof(float) * nnz);
      }
      continue;
    }
    ++truncated;
    order.resize(nnz);
    for (int64_t i = 0; i < nnz; ++i) order[i] = static_cast<int32_t>(i);
    std::nth_element(order.begin(), order.begin() + p, order.end(),
                     [&](int32_t a, int32_t b) {
                       // NaN maps below every real |value| (abs >= 0) to keep
                       // the ordering strict-weak (raw NaN comparisons would
                       // make NaN "equivalent" to everything — UB for
                       // nth_element) and to match numpy argsort's NaN-last
                       float av = std::abs(values[s + a]);
                       float bv = std::abs(values[s + b]);
                       if (av != av) av = -1.0f;
                       if (bv != bv) bv = -1.0f;
                       // |value| ties keep the earlier position — same rule
                       // as the numpy fallback's stable argsort
                       return av != bv ? av > bv : a < b;
                     });
    std::sort(order.begin(), order.begin() + p);  // ascending column order
    for (int64_t i = 0; i < p; ++i) {
      oi[i] = col_idx[s + order[i]];
      ov[i] = values[s + order[i]];
    }
  }
  return truncated;
}

}  // extern "C"
