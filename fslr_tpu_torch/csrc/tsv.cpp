// Tab-separated table reader of the port's host runtime: one pass over a
// file's bytes into cells, each column typed as stages/cluster.py's
// _parse_column types it (pd.read_csv's C or pyarrow engine), with no
// per-cell Python work.
//
// Tokenizing follows csv.reader(fh, delimiter='\t') on a file opened with
// newline='': a field that starts with '"' is quoted, runs to the next lone
// '"' and may hold tabs and line ends, '""' inside it is one '"'; a record
// ends at LF, CRLF, CR or the end of the bytes.  A file that is not a
// rectangle of such cells is refused (status 1) and read by the csv module
// instead: no bytes, a blank line, a record whose field count differs from
// the header's, a '"' inside an unquoted field or after a closing quote, an
// unterminated quote, a NUL byte, or a field longer than csv's field limit.
// Quoted fields are unescaped in place, in the caller's buffer.
//
// Each cell gets flags: an NA token, an integer, a float and a boolean
// token of the engine, by _parse_column's grammar (ASCII digits, spaces
// around a number).  A column's kind follows _parse_column's precedence:
// integers (float64 with NaN where cells are missing), else floats, else
// booleans, else strings as dictionary codes.  A column holding a form this
// file does not convert (pyarrow's hexadecimal or nan forms, an integer
// beyond int64, or one of the four non-ASCII letters that Python's
// case-insensitive regex takes for i, s or k) is kind kCells: its cells go
// back to _parse_column as dictionary codes.
//
// Host C++, no CUDA and no library beyond the C and C++ standard ones:
// io/native.py builds it with fastx.cpp into one library with g++ at first
// use and binds it with ctypes.

#include <locale.h>
#include <stdlib.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <new>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// column kinds (io/native.py's TSV_* constants)
enum Kind : int64_t {
  kInt = 0,     // int64
  kIntNa = 1,   // integers with missing cells: float64, NaN where missing
  kFloat = 2,   // float64, NaN where missing
  kBool = 3,    // bool
  kBoolNa = 4,  // 0 False, 1 True, 2 missing
  kStr = 5,     // dictionary codes of every cell
  kCells = 6,   // dictionary codes, typed by _parse_column
};

// cell flags
enum : uint8_t {
  kNa = 1,
  kIntForm = 2,     // an integer of the engine's grammar
  kFloatForm = 4,   // a float of the engine's grammar
  kTrue = 8,        // a boolean token of the engine
  kFalse = 16,
  kIntOther = 32,   // an integer this file does not convert
  kFloatOther = 64, // a float this file does not convert
  kUnsure = 128,    // a letter Python's re.I takes for an ASCII one
};

struct Cell {
  int64_t off;
  int64_t len;
};

// a column's distinct cells in code order, each after a NUL but the first
// (a table holds no NUL byte)
using Dict = std::string;

struct Table {
  const char* data = nullptr;
  int64_t status = 0;
  int64_t ncols = 0;
  int64_t nrows = 0;
  std::vector<Cell> header;
  std::vector<std::vector<Cell>> cells;     // per column, the body's
  std::vector<std::vector<uint8_t>> flags;  // per column, a cell's flags
  std::vector<std::vector<int64_t>> ints;   // per column, a cell's integer
  std::vector<int64_t> kinds;
  std::vector<Dict> dicts;      // per column, filled by fslr_tsv_fill
};

locale_t c_locale() {
  static const locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  return loc;
}

bool is_digit(char c) { return c >= '0' && c <= '9'; }

bool is_hex(char c) {
  return is_digit(c) || (c >= 'a' && c <= 'f') || (c >= 'A' && c <= 'F');
}

char lower(char c) { return c >= 'A' && c <= 'Z' ? c + 32 : c; }

// [s, e) equals the lowercase ASCII word w in any case
bool equals_ci(const char* s, const char* e, const char* w) {
  const size_t n = strlen(w);
  if (static_cast<size_t>(e - s) != n) return false;
  for (size_t i = 0; i < n; ++i)
    if (lower(s[i]) != w[i]) return false;
  return true;
}

bool equals(const char* s, const char* e, const char* w) {
  const size_t n = strlen(w);
  return static_cast<size_t>(e - s) == n && memcmp(s, w, n) == 0;
}

// pandas' default NA tokens (cluster.NA_TOKENS), exactly as written
const char* const kNaTokens[] = {
    "",    "#N/A", "#N/A N/A", "#NA",  "-1.#IND", "-1.#QNAN", "-NaN",
    "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
    "n/a", "nan", "null"};

bool is_na(const char* s, const char* e) {
  if (s == e) return true;
  if (e - s > 8) return false;
  switch (*s) {                    // the tokens' first bytes
    case '#': case '-': case '1': case '<': case 'N': case 'n':
      break;
    default:
      return false;
  }
  for (const char* t : kNaTokens)
    if (equals(s, e, t)) return true;
  return false;
}

// the bytes that end an unquoted field's scan
struct Stops {
  bool at[256] = {};
  Stops() { at['\t'] = at['\r'] = at['\n'] = at['"'] = true; }
};
const Stops kStops;

// U+0130, U+0131 (i), U+017F (s), U+212A (k) in UTF-8: re.I matches them
// to ASCII letters of _FLOAT's patterns
bool has_unsure_letter(const char* s, const char* e) {
  for (const char* p = s; p < e; ++p) {
    const auto c = static_cast<uint8_t>(*p);
    if (c < 0x80) continue;
    const ptrdiff_t left = e - p;
    const auto c1 = left > 1 ? static_cast<uint8_t>(p[1]) : 0;
    const auto c2 = left > 2 ? static_cast<uint8_t>(p[2]) : 0;
    if ((c == 0xC4 && (c1 == 0xB0 || c1 == 0xB1)) ||
        (c == 0xC5 && c1 == 0xBF) || (c == 0xE2 && c1 == 0x84 && c2 == 0xAA))
      return true;
  }
  return false;
}

// decimal digits [s, e), sign already taken; false past int64
bool int_value(const char* s, const char* e, bool negative, int64_t* out) {
  const uint64_t limit = negative ? (uint64_t{1} << 63)
                                  : (uint64_t{1} << 63) - 1;
  uint64_t v = 0;
  for (; s < e; ++s) {
    const uint64_t d = static_cast<uint64_t>(*s - '0');
    if (v > (limit - d) / 10) return false;
    v = v * 10 + d;
  }
  *out = negative ? static_cast<int64_t>(0 - v) : static_cast<int64_t>(v);
  return true;
}

// _FLOAT's decimal: ([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?
bool is_decimal(const char* p, const char* e) {
  const char* q = p;
  while (q < e && is_digit(*q)) ++q;
  if (q > p) {
    if (q < e && *q == '.') ++q;
    while (q < e && is_digit(*q)) ++q;
  } else {
    if (q == e || *q != '.') return false;
    ++q;
    const char* d = q;
    while (q < e && is_digit(*q)) ++q;
    if (q == d) return false;
  }
  if (q == e) return true;
  if (*q != 'e' && *q != 'E') return false;
  ++q;
  if (q < e && (*q == '+' || *q == '-')) ++q;
  const char* d = q;
  while (q < e && is_digit(*q)) ++q;
  return q > d && q == e;
}

// pyarrow's nan(?:\([0-9a-z_]*\))?, any case
bool is_nan_form(const char* p, const char* e) {
  if (e - p < 3 || !equals_ci(p, p + 3, "nan")) return false;
  p += 3;
  if (p == e) return true;
  if (*p != '(' || e[-1] != ')') return false;
  for (++p; p < e - 1; ++p) {
    const char c = lower(*p);
    if (!(is_digit(c) || (c >= 'a' && c <= 'z') || c == '_')) return false;
  }
  return true;
}

// A cell's flags, and in *value the integer it holds where it is one this
// file converts.
uint8_t classify(const char* s, const char* e, bool pyarrow, int64_t* value) {
  // the common cell, -?[0-9]{1,18}: no NA token, boolean only as 0 or 1
  const bool minus = s < e && *s == '-';
  const char* d = s + minus;
  if (d < e && e - d < 19) {
    const char* q = d;
    int64_t v = 0;
    for (; q < e && is_digit(*q); ++q) v = v * 10 + (*q - '0');
    if (q == e) {
      *value = minus ? -v : v;
      uint8_t f = kIntForm | kFloatForm;
      if (pyarrow && e - s == 1)
        f |= *s == '1' ? kTrue : *s == '0' ? kFalse : 0;
      return f;
    }
  }
  if (is_na(s, e)) return kNa;
  uint8_t f = 0;
  switch (*s) {                   // a boolean token's first byte
    case 'T': case 't': case 'F': case 'f':
      if (pyarrow) {
        if (equals(s, e, "True") || equals(s, e, "TRUE") ||
            equals(s, e, "true"))
          f |= kTrue;
        else if (equals(s, e, "False") || equals(s, e, "FALSE") ||
                 equals(s, e, "false"))
          f |= kFalse;
      } else {
        if (equals_ci(s, e, "true")) f |= kTrue;
        else if (equals_ci(s, e, "false")) f |= kFalse;
      }
      break;
    default:
      break;
  }
  const char* a = s;
  const char* b = e;
  while (a < b && *a == ' ') ++a;
  while (b > a && b[-1] == ' ') --b;
  if (a == b) return f;
  // the number's first byte, after its sign
  const char* p = a + (*a == '+' || *a == '-');
  if (p == b) return f;
  const auto lead = static_cast<uint8_t>(*p);
  if (lead == 'i' || lead == 'I' || lead == 0xC4 ||
      (pyarrow && (lead == 'n' || lead == 'N'))) {
    // inf, infinity or nan(...): may hold a letter re.I takes for i, s, k
    if (has_unsure_letter(p, b)) return kUnsure;
    if (equals_ci(p, b, "inf") || equals_ci(p, b, "infinity"))
      f |= kFloatForm;
    else if (pyarrow && is_nan_form(p, b))
      f |= kFloatForm | kFloatOther;
    return f;
  }
  if (!is_digit(lead) && lead != '.') return f;
  // integers: C [+-]?[0-9]+, pyarrow -?[0-9]+ or 0[xX][0-9a-fA-F]+
  if (*a != '+' || !pyarrow) {
    const char* q = p;
    while (q < b && is_digit(*q)) ++q;
    if (q > p && q == b) {
      f |= kIntForm;
      if (!int_value(p, b, *a == '-', value)) f |= kIntOther;
    }
  }
  if (pyarrow && b - a > 2 && a[0] == '0' && (a[1] == 'x' || a[1] == 'X')) {
    const char* q = a + 2;
    while (q < b && is_hex(*q)) ++q;
    if (q == b) f |= kIntForm | kIntOther;
  }
  // floats: [+-]?(decimal|inf|infinity), pyarrow also nan forms
  if (is_decimal(p, b)) f |= kFloatForm;
  return f;
}

// _parse_column's precedence over one column's cell flags
int64_t column_kind(const uint8_t* flags, int64_t n) {
  uint8_t all = 0xFF;
  uint8_t any = 0;
  int64_t full = 0;
  for (int64_t r = 0; r < n; ++r) {
    any |= flags[r];
    if (flags[r] & kNa) continue;
    ++full;
    all &= flags[r];
  }
  if (any & kUnsure) return kCells;
  const bool missing = full < n;
  if (full == 0 || (all & kIntForm)) {
    if (any & kIntOther) return kCells;
    return missing ? kIntNa : kInt;
  }
  if (all & kFloatForm) return (any & kFloatOther) ? kCells : kFloat;
  // every full cell is a boolean token
  bool bools = true;
  for (int64_t r = 0; r < n && bools; ++r)
    bools = (flags[r] & (kNa | kTrue | kFalse)) != 0;
  if (bools) return missing ? kBoolNa : kBool;
  return kStr;
}

// Splits the bytes into the header's cells and the columns' cells, and
// classifies each body cell; false when they are not a rectangle.
bool tokenize(Table* t, char* data, int64_t size, bool pyarrow,
              int64_t field_limit) {
  if (size == 0 || memchr(data, 0, size)) return false;
  char* const end = data + size;
  const int64_t lines = std::count(data, end, '\n') + 1;
  char* p = data;
  int64_t field = 0;              // of the record
  bool in_header = true;
  while (p < end) {
    if (field == 0 && (*p == '\r' || *p == '\n')) return false;  // blank
    Cell cell{p - data, 0};
    char* stop;                   // the delimiter, line end or end
    if (*p == '"') {
      char* w = p;                // unescaped in place
      char* r = p + 1;
      for (;;) {
        char* q = static_cast<char*>(memchr(r, '"', end - r));
        if (!q) return false;     // unterminated
        memmove(w, r, q - r);
        w += q - r;
        if (q + 1 < end && q[1] == '"') {
          *w++ = '"';
          r = q + 2;
          continue;
        }
        stop = q + 1;
        break;
      }
      cell.len = w - p;
      if (stop < end && *stop != '\t' && *stop != '\r' && *stop != '\n')
        return false;             // text after the closing quote
    } else {
      stop = p;
      while (stop < end && !kStops.at[static_cast<uint8_t>(*stop)]) ++stop;
      if (stop < end && *stop == '"') return false;
      cell.len = stop - p;
    }
    if (cell.len > field_limit) return false;
    bool last = true;             // the record's last field
    if (stop == end) {
      p = end;
    } else if (*stop == '\t') {
      p = stop + 1;
      last = false;
    } else {
      p = stop + 1;
      if (*stop == '\r' && p < end && *p == '\n') ++p;
    }
    for (;;) {
      if (in_header) {
        t->header.push_back(cell);
      } else {
        if (field >= t->ncols) return false;
        int64_t v = 0;
        const char* s = data + cell.off;
        t->flags[field].push_back(classify(s, s + cell.len, pyarrow, &v));
        t->ints[field].push_back(v);
        t->cells[field].push_back(cell);
      }
      ++field;
      // a tab at the very end: one more field, empty
      if (last || p < end) break;
      cell = Cell{size, 0};
      last = true;
    }
    if (last) {
      if (in_header) {
        t->ncols = field;
        t->cells.resize(field);
        t->flags.resize(field);
        t->ints.resize(field);
        for (int64_t j = 0; j < field; ++j) {
          t->cells[j].reserve(lines);
          t->flags[j].reserve(lines);
          t->ints[j].reserve(lines);
        }
        in_header = false;
      } else if (field != t->ncols) {
        return false;
      }
      field = 0;
    }
  }
  t->nrows = static_cast<int64_t>(t->cells[0].size());
  return true;
}

Table* parse(char* data, int64_t size, bool pyarrow, int64_t field_limit) {
  auto t = std::make_unique<Table>();
  t->data = data;
  if (!tokenize(t.get(), data, size, pyarrow, field_limit)) {
    t = std::make_unique<Table>();
    t->data = data;
    t->status = 1;
    return t.release();
  }
  const int64_t nc = t->ncols;
  t->kinds.resize(nc);
  t->dicts.resize(nc);
  for (int64_t j = 0; j < nc; ++j)
    t->kinds[j] = column_kind(t->flags[j].data(), t->nrows);
  return t.release();
}

Table& table(void* h) { return *static_cast<Table*>(h); }

// the trimmed text of a number cell, NUL-terminated for strtod
double float_value(const char* s, const char* e, std::string* buf) {
  while (s < e && *s == ' ') ++s;
  while (e > s && e[-1] == ' ') --e;
  buf->assign(s, e);
  return strtod_l(buf->c_str(), nullptr, c_locale());
}

// dictionary codes of a column's cells, first seen first; a run of equal
// cells (a read's rows) looks the table up once
int64_t encode(const char* data, const std::vector<Cell>& cells, Dict* d,
               int64_t* code) {
  d->clear();
  std::unordered_map<std::string_view, int64_t> codes;
  std::string_view prev;
  int64_t prev_code = -1;
  for (size_t r = 0; r < cells.size(); ++r) {
    const std::string_view v(data + cells[r].off, cells[r].len);
    if (prev_code < 0 || v != prev) {
      const auto [it, fresh] =
          codes.try_emplace(v, static_cast<int64_t>(codes.size()));
      if (fresh) {
        if (codes.size() > 1) d->push_back('\0');
        d->append(v);
      }
      prev = v;
      prev_code = it->second;
    }
    code[r] = prev_code;
  }
  return static_cast<int64_t>(codes.size());
}

int64_t fill(Table& t, int64_t j, void* out) {
  const std::vector<Cell>& cells = t.cells[j];
  const uint8_t* flags = t.flags[j].data();
  const int64_t* ints = t.ints[j].data();
  const int64_t nr = t.nrows;
  const char* data = t.data;
  std::string buf;
  switch (t.kinds[j]) {
    case kInt:
      memcpy(out, ints, nr * sizeof(int64_t));
      return 0;
    case kIntNa:
      for (int64_t r = 0; r < nr; ++r)
        static_cast<double*>(out)[r] =
            (flags[r] & kNa) ? NAN : static_cast<double>(ints[r]);
      return 0;
    case kFloat:
      for (int64_t r = 0; r < nr; ++r) {
        const char* s = data + cells[r].off;
        static_cast<double*>(out)[r] =
            (flags[r] & kNa) ? NAN : float_value(s, s + cells[r].len, &buf);
      }
      return 0;
    case kBool:
      for (int64_t r = 0; r < nr; ++r)
        static_cast<uint8_t*>(out)[r] = (flags[r] & kTrue) != 0;
      return 0;
    case kBoolNa:
      for (int64_t r = 0; r < nr; ++r)
        static_cast<uint8_t*>(out)[r] =
            (flags[r] & kNa) ? 2 : (flags[r] & kTrue) != 0;
      return 0;
    default:
      return encode(data, cells, &t.dicts[j], static_cast<int64_t*>(out));
  }
}

}  // namespace

extern "C" {

// Tokenizes and classifies size bytes at data (quoted fields unescaped in
// place: data must outlive the handle).  engine_pyarrow picks pyarrow's
// grammar, else the C engine's.  Returns an opaque handle, or null when
// memory ran out; free it with fslr_tsv_free.
void* fslr_tsv_parse(char* data, int64_t size, int64_t engine_pyarrow,
                     int64_t field_limit) {
  try {
    return parse(data, size, engine_pyarrow != 0, field_limit);
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

// 0: a table; 1: not a rectangle of cells (read it with the csv module)
int64_t fslr_tsv_status(void* h) { return table(h).status; }
int64_t fslr_tsv_ncols(void* h) { return table(h).ncols; }
int64_t fslr_tsv_nrows(void* h) { return table(h).nrows; }
int64_t fslr_tsv_kind(void* h, int64_t col) { return table(h).kinds[col]; }

// the header's cells, each after a NUL but the first
int64_t fslr_tsv_header_bytes(void* h) {
  const Table& t = table(h);
  int64_t n = t.ncols ? t.ncols - 1 : 0;
  for (const Cell& c : t.header) n += c.len;
  return n;
}

void fslr_tsv_header(void* h, char* buf) {
  const Table& t = table(h);
  for (int64_t j = 0; j < t.ncols; ++j) {
    if (j) *buf++ = '\0';
    memcpy(buf, t.data + t.header[j].off, t.header[j].len);
    buf += t.header[j].len;
  }
}

// Column col's values into out, nrows of them: int64 (kInt), float64
// (kIntNa, kFloat), uint8 (kBool, kBoolNa) or int64 dictionary codes (kStr,
// kCells; returns the number of distinct cells, -1 when memory ran out).
int64_t fslr_tsv_fill(void* h, int64_t col, void* out) {
  try {
    return fill(table(h), col, out);
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

// column col's distinct cells in code order, each after a NUL but the
// first
int64_t fslr_tsv_dict_bytes(void* h, int64_t col) {
  return static_cast<int64_t>(table(h).dicts[col].size());
}

void fslr_tsv_dict(void* h, int64_t col, char* buf) {
  const Dict& d = table(h).dicts[col];
  memcpy(buf, d.data(), d.size());
}

void fslr_tsv_free(void* h) { delete static_cast<Table*>(h); }

}  // extern "C"
