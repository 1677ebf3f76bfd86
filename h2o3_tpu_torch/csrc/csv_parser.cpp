// CSV parser of the port's ingest (h2o3_tpu_torch/ingest), host C++ with a
// plain C interface, loaded with ctypes (h2o3_tpu_torch/native.py).
//
// The port's own copy of h2o3_tpu/native/csv_parser.cpp, extended. The
// reference reads CSV with pandas' C engine (h2o3_tpu/ingest/parser.py
// csv_read_kwargs: na_values + pandas' default NA list, skipinitialspace,
// the setup's quote char, skipped blank lines) and converts time columns
// with pd.to_datetime over the whole column. This file follows those
// semantics so the port needs no pandas:
//  - tokenizing: the state machine of pandas' tokenizer (quoted fields
//    with "" escapes and embedded newlines, \n, \r\n and bare \r record
//    ends, blank and whitespace-only lines skipped, a space at the start
//    of a field skipped, text after a closing quote kept);
//  - numbers: parsed in double with the arithmetic of pandas' default
//    converter (precise_xstrtod: at most 17 digits accumulated, then one
//    multiply or divide by a power of ten), so each value is bit for bit
//    the reference's double, then rounded to nearest float32;
//  - NA: a token equal to an NA string, or a number equal to a numeric
//    NA value, is missing, in every column kind;
//  - enum columns: tokens interned per call into a local domain sorted by
//    bytes (Python's str order for UTF-8) and int32 codes (-1 = NA);
//  - string and time columns: raw token bytes and offsets, NA flagged;
//  - times: the format is inferred from the column's first non-NA token
//    and every token must match it, as pd.to_datetime(errors="coerce")
//    does (h2o3_tpu_torch/ingest/chunked.py resolves it column-wide);
//    when that token is no valid time, each token is read on its own in
//    any supported shape, as pandas then parses element by element.
// One call parses one byte range [buf, buf + len) into caller buffers;
// calls on different ranges run on different threads (ctypes releases
// the GIL), which is how a large file's chunks parse across cores.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <string_view>
#include <vector>

namespace {

// --- numbers --------------------------------------------------------------

struct Pow10 {
  double e[309];
  Pow10() {
    char s[16];
    for (int i = 0; i <= 308; ++i) {
      std::snprintf(s, sizeof s, "1e%d", i);
      e[i] = std::strtod(s, nullptr);       // correctly rounded literals
    }
  }
};
const Pow10 kPow10;

inline bool is_digit(unsigned char c) { return c >= '0' && c <= '9'; }
inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
         c == '\r';
}

// pandas' precise_xstrtod over [p, end): returns false when the token is
// not a number (no mantissa digit, or text left after trailing spaces).
bool parse_number(const char* p, const char* end, double* out) {
  while (p < end && is_space(*p)) ++p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = *p == '-'; ++p; }
  double number = 0.0;
  int exponent = 0, num_digits = 0, num_decimals = 0;
  const int max_digits = 17;
  bool any_digit = false;
  while (p < end && is_digit(*p)) {
    any_digit = true;
    if (num_digits < max_digits) {
      number = number * 10.0 + (*p - '0');
      ++num_digits;
    } else {
      ++exponent;
    }
    ++p;
  }
  if (p < end && *p == '.') {
    ++p;
    while (num_digits < max_digits && p < end && is_digit(*p)) {
      any_digit = true;
      number = number * 10.0 + (*p - '0');
      ++p;
      ++num_digits;
      ++num_decimals;
    }
    if (num_digits >= max_digits)
      while (p < end && is_digit(*p)) { any_digit = true; ++p; }
    exponent -= num_decimals;
  }
  if (!any_digit) return false;
  if (neg) number = -number;
  if (p < end && (*p == 'e' || *p == 'E')) {
    const char* q = p + 1;
    bool eneg = false;
    if (q < end && (*q == '-' || *q == '+')) { eneg = *q == '-'; ++q; }
    int n = 0, k = 0;
    while (k < max_digits && q < end && is_digit(*q)) {
      n = n * 10 + (*q - '0');
      ++k;
      ++q;
    }
    if (k > 0) {                 // no digit after 'e': it stays unconsumed
      exponent += eneg ? -n : n;
      p = q;
    }
  }
  if (exponent > 308) {
    number = number == 0.0 ? 0.0 : std::copysign(HUGE_VAL, number);
  } else if (exponent > 0) {
    number *= kPow10.e[exponent];
  } else if (exponent < -308) {
    if (exponent < -616) {
      number = 0.0;
    } else {
      number /= kPow10.e[-308 - exponent];
      number /= kPow10.e[308];
    }
  } else {
    number /= kPow10.e[-exponent];
  }
  while (p < end && is_space(*p)) ++p;
  if (p != end) return false;
  *out = number;
  return true;
}

bool ieq(std::string_view a, const char* b) {
  size_t n = std::strlen(b);
  if (a.size() != n) return false;
  for (size_t i = 0; i < n; ++i) {
    unsigned char c = a[i];
    if (c >= 'A' && c <= 'Z') c = c - 'A' + 'a';
    if (c != (unsigned char)b[i]) return false;
  }
  return true;
}

// --- the NA set -----------------------------------------------------------

struct NaSet {
  std::vector<std::string> strs;
  std::vector<double> floats;      // numeric NA values (never NaN)
  bool has_empty = false;
  size_t max_len = 0;
  bool first[256] = {};
  void add(std::string s) {
    if (s.empty()) { has_empty = true; return; }
    first[(unsigned char)s[0]] = true;
    max_len = std::max(max_len, s.size());
    strs.push_back(std::move(s));
  }
  bool contains(std::string_view t) const {
    if (t.empty()) return has_empty;
    if (t.size() > max_len || !first[(unsigned char)t[0]]) return false;
    for (const auto& s : strs)
      if (s.size() == t.size() && std::memcmp(s.data(), t.data(), t.size()) == 0)
        return true;
    return false;
  }
  bool float_na(double v) const {
    for (double f : floats) if (f == v) return true;
    return false;
  }
};

// --- enum interning ---------------------------------------------------------

struct Interner {
  std::string arena;
  std::vector<int64_t> offs{0};
  std::vector<int32_t> table;      // open addressing, -1 = empty
  std::vector<uint64_t> hashes;
  size_t mask = 0;

  Interner() { table.assign(64, -1); mask = 63; }
  static uint64_t hash(std::string_view s) {
    uint64_t h = 1469598103934665603ULL;
    for (unsigned char c : s) { h ^= c; h *= 1099511628211ULL; }
    return h ^ (h >> 29);
  }
  std::string_view at(int32_t i) const {
    return std::string_view(arena.data() + offs[i], offs[i + 1] - offs[i]);
  }
  int32_t size() const { return (int32_t)offs.size() - 1; }
  void grow() {
    std::vector<int32_t> t(table.size() * 2, -1);
    size_t m = t.size() - 1;
    for (int32_t i = 0; i < size(); ++i) {
      size_t j = hashes[i] & m;
      while (t[j] >= 0) j = (j + 1) & m;
      t[j] = i;
    }
    table.swap(t);
    mask = m;
  }
  int32_t intern(std::string_view s) {
    uint64_t h = hash(s);
    size_t j = h & mask;
    while (table[j] >= 0) {
      int32_t i = table[j];
      if (hashes[i] == h && at(i) == s) return i;
      j = (j + 1) & mask;
    }
    int32_t id = size();
    arena.append(s.data(), s.size());
    offs.push_back((int64_t)arena.size());
    hashes.push_back(h);
    table[j] = id;
    if ((size_t)size() * 2 > table.size()) grow();
    return id;
  }
};

// --- one parse ----------------------------------------------------------------

enum Kind { K_NUM = 0, K_CAT = 1, K_RAW = 2 };

struct Column {
  int kind = K_NUM;
  float* num = nullptr;            // caller buffer (K_NUM)
  int32_t* codes = nullptr;        // caller buffer (K_CAT), first-seen ids
  Interner intern;                 // K_CAT
  std::vector<int32_t> order;      // K_CAT: sorted position -> first-seen id
  std::string raw;                 // K_RAW token bytes
  std::vector<int64_t> raw_offs{0};
  std::vector<uint8_t> raw_na;
};

struct Result {
  int64_t rows = 0;
  std::string error;
  std::vector<Column> cols;
};

enum State {
  START_RECORD, START_FIELD, IN_FIELD, IN_QUOTED_FIELD,
  QUOTE_IN_QUOTED_FIELD, EAT_CRNL, EAT_CRNL_NOP, WHITESPACE_LINE
};

struct Parser {
  const char* buf;
  int64_t len;
  char sep;
  int quote;                       // -1: no quoting
  bool skip_header;
  int64_t cap;                     // rows the caller's buffers hold
  bool count_only;
  const NaSet* na;
  Result* res;

  int64_t nfields = 0;
  bool header_pending;
  int64_t header_fields = 0;
  // pandas takes the width of the first data record (or of the header
  // record, with a header) when it is wider than the column names: the
  // leading fields beyond the names become the index and are dropped
  bool first_pending = true;
  std::vector<std::string> first_toks;
  int64_t lead = 0, width = 0;
  std::string scratch;
  bool in_scratch = false;
  int64_t span_start = 0;
  bool failed = false;

  void fail(const std::string& msg) {
    if (!failed) { failed = true; res->error = msg; }
  }

  void emit(std::string_view tok) {
    int64_t j = nfields++;
    if (header_pending || count_only) return;
    if (first_pending) { first_toks.emplace_back(tok); return; }
    if (j >= lead && j - lead < (int64_t)res->cols.size() &&
        res->rows < cap)
      process(j - lead, tok);
  }

  void process(int64_t col, std::string_view tok) {
    Column& c = res->cols[col];
    int64_t r = res->rows;
    bool is_na = na->contains(tok);
    if (c.kind == K_NUM) {
      double v = NAN;
      if (!is_na) {
        if (!parse_number(tok.data(), tok.data() + tok.size(), &v)) {
          if (ieq(tok, "inf") || ieq(tok, "+inf") || ieq(tok, "infinity") ||
              ieq(tok, "+infinity")) {
            v = HUGE_VAL;
          } else if (ieq(tok, "-inf") || ieq(tok, "-infinity")) {
            v = -HUGE_VAL;
          } else {
            fail("could not convert string to float: '" + std::string(tok) +
                 "' (row " + std::to_string(r + 1) + ", column " +
                 std::to_string(col + 1) + ")");
            return;
          }
        }
        if (na->float_na(v)) v = NAN;
      }
      c.num[r] = (float)v;
    } else if (c.kind == K_CAT) {
      c.codes[r] = is_na ? -1 : c.intern.intern(tok);
    } else {
      if (!is_na) c.raw.append(tok.data(), tok.size());
      c.raw_offs.push_back((int64_t)c.raw.size());
      c.raw_na.push_back(is_na ? 1 : 0);
    }
  }

  void fill_na(int64_t col) {
    Column& c = res->cols[col];
    int64_t r = res->rows;
    if (c.kind == K_NUM) {
      c.num[r] = NAN;
    } else if (c.kind == K_CAT) {
      c.codes[r] = -1;
    } else {
      c.raw_offs.push_back((int64_t)c.raw.size());
      c.raw_na.push_back(1);
    }
  }

  void end_line() {
    int64_t ncols = (int64_t)res->cols.size();
    if (header_pending) {
      header_pending = false;
      header_fields = nfields;
      nfields = 0;
      return;
    }
    if (count_only) {
      ++res->rows;
      nfields = 0;
      return;
    }
    if (first_pending) {
      first_pending = false;
      width = std::max(skip_header ? header_fields : ncols, nfields);
      if (width < ncols) {
        fail("too many columns specified: expected " + std::to_string(ncols) +
             " and found " + std::to_string(width));
        return;
      }
      lead = width - ncols;
      if (res->rows < cap)
        for (int64_t j = lead; j < nfields && !failed; ++j)
          process(j - lead, first_toks[j]);
      first_toks.clear();
    } else if (nfields > width) {
      fail("expected " + std::to_string(width) + " fields in record " +
           std::to_string(res->rows + 1) + ", saw " + std::to_string(nfields));
      return;
    }
    if (failed) return;
    if (res->rows >= cap) {
      fail("more records than the " + std::to_string(cap) + " expected");
      return;
    }
    for (int64_t c = std::max<int64_t>(nfields - lead, 0); c < ncols; ++c)
      fill_na(c);
    ++res->rows;
    nfields = 0;
  }

  void end_field(int64_t i) {
    if (in_scratch) {
      emit(std::string_view(scratch));
      scratch.clear();
      in_scratch = false;
    } else {
      emit(std::string_view(buf + span_start, i - span_start));
    }
  }

  void run() {
    header_pending = skip_header;
    State st = START_RECORD;
    int64_t i = 0;
    if (len >= 3 && (unsigned char)buf[0] == 0xEF &&
        (unsigned char)buf[1] == 0xBB && (unsigned char)buf[2] == 0xBF)
      i = 3;                       // a UTF-8 byte-order mark
    int64_t line_start = i;
    while (i < len && !failed) {
      char c = buf[i];
      switch (st) {
        case WHITESPACE_LINE:
          if (c == '\n') { st = START_RECORD; ++i; }
          else if (c == '\r') { st = EAT_CRNL_NOP; ++i; }
          else if ((c == ' ' || c == '\t') && c != sep) { ++i; }
          else { i = line_start; st = START_FIELD; }   // back to the start
          break;
        case START_RECORD:
          line_start = i;
          if (c == '\n') { ++i; break; }               // blank line
          if (c == '\r') { st = EAT_CRNL_NOP; ++i; break; }
          if ((c == ' ' || c == '\t') && c != sep) {
            st = WHITESPACE_LINE; ++i; break;
          }
          st = START_FIELD;
          [[fallthrough]];
        case START_FIELD:
          if (c == '\n') {
            span_start = i; end_field(i); end_line(); st = START_RECORD;
          } else if (c == '\r') {
            span_start = i; end_field(i); st = EAT_CRNL;
          } else if (quote >= 0 && c == (char)quote) {
            scratch.clear(); in_scratch = true; st = IN_QUOTED_FIELD;
          } else if (c == ' ') {
            // skipinitialspace (before the delimiter test, as pandas)
          } else if (c == sep) {
            span_start = i; end_field(i);
          } else {
            span_start = i; in_scratch = false; st = IN_FIELD;
          }
          ++i;
          break;
        case IN_FIELD:
          if (!in_scratch) {       // an unquoted span: skip to its end
            while (c != '\n' && c != '\r' && c != sep && ++i < len) c = buf[i];
            if (i == len) break;
          }
          if (c == '\n') {
            end_field(i); end_line(); st = START_RECORD;
          } else if (c == '\r') {
            end_field(i); st = EAT_CRNL;
          } else if (c == sep) {
            end_field(i); st = START_FIELD;
          } else if (in_scratch) {
            scratch.push_back(c);
          }
          ++i;
          break;
        case IN_QUOTED_FIELD:
          if (c == (char)quote) st = QUOTE_IN_QUOTED_FIELD;
          else scratch.push_back(c);
          ++i;
          break;
        case QUOTE_IN_QUOTED_FIELD:
          if (c == (char)quote) {
            scratch.push_back(c); st = IN_QUOTED_FIELD;
          } else if (c == sep) {
            end_field(i); st = START_FIELD;
          } else if (c == '\n') {
            end_field(i); end_line(); st = START_RECORD;
          } else if (c == '\r') {
            end_field(i); st = EAT_CRNL;
          } else {
            scratch.push_back(c); st = IN_FIELD;      // text after the quote
          }
          ++i;
          break;
        case EAT_CRNL:
          if (c == '\n') {
            end_line(); st = START_RECORD; ++i;
          } else if (c == sep) {
            end_line(); span_start = i; end_field(i); st = START_FIELD; ++i;
          } else {
            end_line(); st = START_RECORD;            // bare \r: reread c
          }
          break;
        case EAT_CRNL_NOP:
          st = START_RECORD;
          if (c == '\n' || c == sep) ++i;
          break;
      }
    }
    if (failed) return;
    switch (st) {                  // end of the range
      case START_RECORD: case WHITESPACE_LINE: case EAT_CRNL_NOP:
        break;
      case IN_QUOTED_FIELD:
        fail("end of data inside a quoted field");
        return;
      case START_FIELD:
        span_start = len; end_field(len); end_line();
        break;
      case IN_FIELD: case QUOTE_IN_QUOTED_FIELD:
        end_field(len); end_line();
        break;
      case EAT_CRNL:
        end_line();
        break;
    }
  }
};

// --- times ----------------------------------------------------------------

// A time format: the date part (ISO dashes, 8 compact digits, or slashes
// month first / day first), the separator before the time (space class or
// 'T') and how many time fields follow (0 none, 1 H, 2 H:M, 3 H:M:S,
// 4 H:M:S.fraction). Encoded as date * 100 + tsep * 10 + parts.
enum DateStyle { D_ISO = 1, D_COMPACT = 2, D_MDY = 3, D_DMY = 4 };

struct Cursor {
  const char* p;
  const char* e;
  bool digits(int lo, int hi, int* v) {   // lo..hi digits, greedy
    int n = 0, x = 0;
    while (n < hi && p + n < e && is_digit(p[n])) { x = x * 10 + (p[n] - '0'); ++n; }
    if (n < lo) return false;
    p += n;
    *v = x;
    return true;
  }
  bool lit(char c) {
    if (p < e && *p == c) { ++p; return true; }
    return false;
  }
  bool spaces() {                           // one or more, as \s+
    const char* q = p;
    while (p < e && is_space(*p)) ++p;
    return p > q;
  }
};

bool leap(int64_t y) { return (y % 4 == 0 && y % 100 != 0) || y % 400 == 0; }
int mdays(int64_t y, int m) {
  static const int d[] = {31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31};
  return m == 2 && leap(y) ? 29 : d[m - 1];
}
int64_t days_from_civil(int64_t y, int m, int d) {
  y -= m <= 2;
  int64_t era = (y >= 0 ? y : y - 399) / 400;
  int64_t yoe = y - era * 400;
  int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

// Two-digit-first field of the compact form: month 1-12 ("1[0-2]",
// "0[1-9]" before "[1-9]"), day 1-31, as a strptime pattern tries them.
bool compact_date(const char* p, const char* e, int* m, int* d) {
  for (int mw = 2; mw >= 1; --mw) {
    if (p + mw > e) continue;
    int mv = 0;
    bool ok = true;
    for (int k = 0; k < mw; ++k) {
      if (!is_digit(p[k])) { ok = false; break; }
      mv = mv * 10 + (p[k] - '0');
    }
    if (!ok || mv < 1 || mv > 12 || (mw == 2 && p[0] != '0' && p[0] != '1'))
      continue;
    if (mw == 1 && p[0] == '0') continue;
    const char* q = p + mw;
    for (int dw = 2; dw >= 1; --dw) {
      if (q + dw != e) continue;
      int dv = 0;
      bool okd = true;
      for (int k = 0; k < dw; ++k) {
        if (!is_digit(q[k])) { okd = false; break; }
        dv = dv * 10 + (q[k] - '0');
      }
      if (!okd || dv < 1 || dv > 31 || (dw == 1 && q[0] == '0')) continue;
      *m = mv;
      *d = dv;
      return true;
    }
  }
  return false;
}

// Parse one token under `fmt`; returns false (NaT) when it does not match.
bool parse_time(const char* p, const char* e, int fmt, int64_t* ms) {
  int date = fmt / 100, tsep = (fmt / 10) % 10, parts = fmt % 10;
  Cursor c{p, e};
  int y = 0, m = 0, d = 0;
  if (date == D_COMPACT) {
    if (e - p < 6 || !c.digits(4, 4, &y)) return false;
    if (!compact_date(c.p, e, &m, &d)) return false;
    c.p = e;
  } else if (date == D_ISO) {
    if (!c.digits(4, 4, &y) || !c.lit('-') || !c.digits(1, 2, &m) ||
        !c.lit('-') || !c.digits(1, 2, &d))
      return false;
  } else {
    int a = 0, b = 0;
    if (!c.digits(1, 2, &a) || !c.lit('/') || !c.digits(1, 2, &b) ||
        !c.lit('/') || !c.digits(4, 4, &y))
      return false;
    m = date == D_MDY ? a : b;
    d = date == D_MDY ? b : a;
  }
  if (y < 1 || m < 1 || m > 12 || d < 1 || d > mdays(y, m)) return false;
  int H = 0, M = 0, S = 0, frac = 0;
  if (parts > 0) {
    if (tsep == 1 ? !c.spaces() : !c.lit('T')) return false;
    if (!c.digits(1, 2, &H) || H > 23) return false;
    if (parts >= 2 && (!c.lit(':') || !c.digits(1, 2, &M) || M > 59))
      return false;
    if (parts >= 3 && (!c.lit(':') || !c.digits(1, 2, &S) || S > 61))
      return false;
    if (parts == 4) {
      if (!c.lit('.')) return false;
      int n = 0;
      while (c.p < c.e && is_digit(*c.p) && n < 9) {
        if (n < 3) frac = frac * 10 + (*c.p - '0');
        ++n;
        ++c.p;
      }
      for (int k = n; k < 3; ++k) frac *= 10;
    }
  }
  if (c.p != e) return false;
  *ms = days_from_civil(y, m, d) * 86400000LL + H * 3600000LL + M * 60000LL +
        S * 1000LL + frac;
  return true;
}

// The format of a column, from its first non-NA token; -1 if none fits.
int guess_time_format(const char* p, const char* e) {
  int64_t ms;
  if (e - p == 8) {
    bool all = true;
    for (const char* q = p; q < e; ++q) all = all && is_digit(*q);
    if (all) return parse_time(p, e, D_COMPACT * 100, &ms) ? D_COMPACT * 100 : -1;
  }
  int dates[3] = {D_ISO, D_MDY, D_DMY};
  for (int date : dates) {
    for (int parts = 0; parts <= 4; ++parts) {
      for (int tsep = 1; tsep <= 2; ++tsep) {
        if (parts == 0 && tsep == 2) continue;
        int fmt = date * 100 + (parts ? tsep : 0) * 10 + parts;
        if (parse_time(p, e, fmt, &ms)) return fmt;
      }
    }
  }
  return -1;
}

NaSet make_na(const char* blob, const int64_t* offs, int32_t n,
              const double* floats, int32_t nf) {
  NaSet na;
  for (int32_t i = 0; i < n; ++i)
    na.add(std::string(blob + offs[i], offs[i + 1] - offs[i]));
  na.floats.assign(floats, floats + nf);
  return na;
}

}  // namespace

extern "C" {

// Parse [buf, buf + len). kinds[c]: 0 numeric (float32 into num_out[c]),
// 1 enum (int32 first-seen ids into code_out[c]), 2 raw (kept in the
// result). quote < 0 turns quoting off. With skip_header the first record
// is the header and is dropped. cap is the row capacity of the buffers;
// with count_only nothing is converted and only records are counted.
// Returns a result handle (free it with h2o_csv_free); its error is ""
// when the parse succeeded.
void* h2o_csv_parse(const char* buf, int64_t len, char sep, int quote,
                    int skip_header, int ncols, const int32_t* kinds,
                    float** num_out, int32_t** code_out, int64_t cap,
                    int count_only, const char* na_blob,
                    const int64_t* na_offs, int32_t n_na,
                    const double* na_floats, int32_t n_na_floats) {
  Result* res = new Result();
  NaSet na = make_na(na_blob, na_offs, n_na, na_floats, n_na_floats);
  res->cols.resize(ncols);
  for (int c = 0; c < ncols; ++c) {
    res->cols[c].kind = kinds[c];
    if (!count_only) {
      res->cols[c].num = num_out ? num_out[c] : nullptr;
      res->cols[c].codes = code_out ? code_out[c] : nullptr;
    }
  }
  Parser p{buf, len, sep, quote, skip_header != 0,
           count_only ? std::numeric_limits<int64_t>::max() : cap,
           count_only != 0, &na, res};
  p.run();
  if (res->error.empty() && !count_only) {
    for (auto& c : res->cols) {
      if (c.kind != K_CAT) continue;
      int32_t k = c.intern.size();
      c.order.resize(k);
      for (int32_t i = 0; i < k; ++i) c.order[i] = i;
      std::sort(c.order.begin(), c.order.end(), [&](int32_t a, int32_t b) {
        return c.intern.at(a) < c.intern.at(b);
      });
      std::vector<int32_t> rank(k);
      for (int32_t i = 0; i < k; ++i) rank[c.order[i]] = i;
      for (int64_t r = 0; r < res->rows; ++r)
        if (c.codes[r] >= 0) c.codes[r] = rank[c.codes[r]];
    }
  }
  return res;
}

int64_t h2o_csv_rows(void* h) { return static_cast<Result*>(h)->rows; }

const char* h2o_csv_error(void* h) {
  return static_cast<Result*>(h)->error.c_str();
}

// Sizes of an enum column's sorted local domain (levels, bytes) or of a
// raw column's tokens (tokens, bytes).
void h2o_csv_sizes(void* h, int col, int64_t* count, int64_t* nbytes) {
  Column& c = static_cast<Result*>(h)->cols[col];
  if (c.kind == K_CAT) {
    *count = c.intern.size();
    *nbytes = (int64_t)c.intern.arena.size();
  } else {
    *count = (int64_t)c.raw_na.size();
    *nbytes = (int64_t)c.raw.size();
  }
}

// Copy an enum column's sorted domain, or a raw column's tokens and NA
// flags, into caller buffers sized by h2o_csv_sizes (offs: count + 1).
void h2o_csv_copy(void* h, int col, char* bytes, int64_t* offs, uint8_t* na) {
  Column& c = static_cast<Result*>(h)->cols[col];
  if (c.kind == K_CAT) {
    int64_t pos = 0;
    offs[0] = 0;
    for (size_t i = 0; i < c.order.size(); ++i) {
      std::string_view s = c.intern.at(c.order[i]);
      std::memcpy(bytes + pos, s.data(), s.size());
      pos += (int64_t)s.size();
      offs[i + 1] = pos;
    }
  } else {
    std::memcpy(bytes, c.raw.data(), c.raw.size());
    std::memcpy(offs, c.raw_offs.data(), c.raw_offs.size() * sizeof(int64_t));
    std::memcpy(na, c.raw_na.data(), c.raw_na.size());
  }
}

void h2o_csv_free(void* h) { delete static_cast<Result*>(h); }

// The record ends of the chunk splitter's scan window [p, p + n): the
// offsets of the newlines with an even count of quote bytes before them,
// `parity` being that count's parity at p (quote < 0: every newline).
// Writes up to cap offsets; returns how many there are, and the window's
// quote bytes in *nquotes.
int64_t h2o_record_ends(const char* p, int64_t n, int quote, int64_t parity,
                        int64_t* out, int64_t cap, int64_t* nquotes) {
  const char* end = p + n;
  const char* nq = quote >= 0 && n > 0
                       ? static_cast<const char*>(std::memchr(p, quote, n))
                       : nullptr;
  int64_t count = 0, q = 0;
  const char* cur = p;
  auto next_quote = [&](const char* from) {
    return from < end ? static_cast<const char*>(
                            std::memchr(from, quote, end - from))
                      : nullptr;
  };
  while (cur < end) {
    const char* nl = static_cast<const char*>(std::memchr(cur, '\n', end - cur));
    if (!nl) break;
    while (nq && nq < nl) { ++q; nq = next_quote(nq + 1); }
    if (((parity + q) & 1) == 0) {
      if (count < cap) out[count] = nl - p;
      ++count;
    }
    cur = nl + 1;
  }
  while (nq) { ++q; nq = next_quote(nq + 1); }
  *nquotes = q;
  return count;
}

// The time format of a token (see guess_time_format), or -1.
int h2o_time_format(const char* tok, int64_t len) {
  return guess_time_format(tok, tok + len);
}

// Epoch milliseconds of n tokens under `fmt`, as float64 with NaN for NA
// tokens and tokens that do not match the format. fmt -2 reads each token
// in whatever supported shape it has; -1 makes every token NaN.
void h2o_parse_times(const char* bytes, const int64_t* offs,
                     const uint8_t* na, int64_t n, int fmt, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const char* p = bytes + offs[i];
    const char* e = bytes + offs[i + 1];
    int f = fmt == -2 && !na[i] ? guess_time_format(p, e) : fmt;
    int64_t ms;
    if (f >= 0 && !na[i] && parse_time(p, e, f, &ms))
      out[i] = (double)ms;
    else
      out[i] = NAN;
  }
}

}  // extern "C"
