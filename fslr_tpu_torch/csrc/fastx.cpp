// FASTQ/FASTA parser of the port's host runtime: one pass over a file's
// bytes (a gzip file already inflated by the caller, io/native.py) into the
// columnar arrays of io/native.py's FastxArrays, with no per-read Python
// string work:
//   * codes, one byte a base: A=0 C=1 G=2 T=3 in either case, any other
//     symbol 4 (N);
//   * lower, 1 where the base was a lowercase letter (a tantan mask
//     survives the round trip);
//   * n + 1 offsets each into the sequence, name, quality and comment bytes.
// A header line splits after its '@' or '>' at the first space or tab into
// name and comment; a '\r' before a '\n' is no part of its line.  The
// parse stops cleanly at the first record that does not start with the
// file's marker ('@' if the file starts with it, else '>').
//
// Host C++, no CUDA and no library beyond the C++ standard one: io/native.py
// builds it with g++ at first use and binds it with ctypes.

#include <cstdint>
#include <cstring>
#include <memory>
#include <new>
#include <string>
#include <vector>

namespace {

struct Parsed {
  std::vector<uint8_t> codes;
  std::vector<uint8_t> lower;
  std::vector<int64_t> seq_off{0};
  std::string names;
  std::vector<int64_t> name_off{0};
  std::string quals;                 // empty for FASTA
  std::vector<int64_t> qual_off{0};
  std::string comments;
  std::vector<int64_t> comment_off{0};
};

struct Tables {
  uint8_t code[256];
  uint8_t lower[256];
  Tables() {
    for (int c = 0; c < 256; ++c) {
      code[c] = 4;
      lower[c] = c >= 'a' && c <= 'z';
    }
    for (int i = 0; i < 4; ++i) {
      code[static_cast<uint8_t>("ACGT"[i])] = i;
      code[static_cast<uint8_t>("acgt"[i])] = i;
    }
  }
};
const Tables kTables;

// The line that starts at s: [begin, end) without its '\n' and a '\r'
// before it; next is where the following line starts (or the buffer's end).
struct Line {
  const char* begin;
  const char* end;
  const char* next;
};

Line line_at(const char* s, const char* buf_end) {
  const char* nl = static_cast<const char*>(memchr(s, '\n', buf_end - s));
  Line l{s, nl ? nl : buf_end, nl ? nl + 1 : buf_end};
  if (l.end > l.begin && l.end[-1] == '\r') --l.end;
  return l;
}

void push_header(Parsed* p, const char* s, const char* e) {
  const char* sep = s;
  while (sep < e && *sep != ' ' && *sep != '\t') ++sep;
  p->names.append(s, sep);
  p->name_off.push_back(static_cast<int64_t>(p->names.size()));
  if (sep < e) p->comments.append(sep + 1, e);
  p->comment_off.push_back(static_cast<int64_t>(p->comments.size()));
}

void push_bases(Parsed* p, const char* s, const char* e) {
  const size_t off = p->codes.size();
  const size_t n = e - s;
  p->codes.resize(off + n);
  p->lower.resize(off + n);
  uint8_t* code = p->codes.data() + off;
  uint8_t* lower = p->lower.data() + off;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t c = static_cast<uint8_t>(s[i]);
    code[i] = kTables.code[c];
    lower[i] = kTables.lower[c];
  }
}

Parsed* parse(const char* cur, const char* end) {
  auto held = std::make_unique<Parsed>();
  Parsed* p = held.get();
  if (cur == end) return held.release();
  const char marker = *cur == '@' ? '@' : '>';
  while (cur < end && *cur == marker) {
    const Line head = line_at(cur, end);
    push_header(p, head.begin + 1, head.end);
    cur = head.next;
    if (marker == '@') {                  // sequence, '+', quality
      const Line seq = line_at(cur, end);
      push_bases(p, seq.begin, seq.end);
      const Line qual = line_at(line_at(seq.next, end).next, end);
      p->quals.append(qual.begin, qual.end);
      cur = qual.next;
    } else {                              // sequence lines up to a '>'
      while (cur < end && *cur != '>') {
        const Line seq = line_at(cur, end);
        push_bases(p, seq.begin, seq.end);
        cur = seq.next;
      }
    }
    p->seq_off.push_back(static_cast<int64_t>(p->codes.size()));
    p->qual_off.push_back(static_cast<int64_t>(p->quals.size()));
  }
  return held.release();
}

const Parsed& parsed(void* h) { return *static_cast<const Parsed*>(h); }

}  // namespace

extern "C" {

// Parses size bytes at data; returns an opaque handle, or null when memory
// ran out.  Copy the sizes and arrays out with the accessors, then free it.
void* fslr_fastx_parse(const char* data, int64_t size) {
  try {
    return parse(data, data + size);
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

int64_t fslr_fastx_n(void* h) {
  return static_cast<int64_t>(parsed(h).seq_off.size()) - 1;
}
int64_t fslr_fastx_codes_len(void* h) {
  return static_cast<int64_t>(parsed(h).codes.size());
}
int64_t fslr_fastx_names_len(void* h) {
  return static_cast<int64_t>(parsed(h).names.size());
}
int64_t fslr_fastx_quals_len(void* h) {
  return static_cast<int64_t>(parsed(h).quals.size());
}
int64_t fslr_fastx_comments_len(void* h) {
  return static_cast<int64_t>(parsed(h).comments.size());
}

void fslr_fastx_copy(void* h, uint8_t* codes, uint8_t* lower,
                     int64_t* seq_off, char* names, int64_t* name_off,
                     char* quals, int64_t* qual_off, char* comments,
                     int64_t* comment_off) {
  const Parsed& p = parsed(h);
  memcpy(codes, p.codes.data(), p.codes.size());
  memcpy(lower, p.lower.data(), p.lower.size());
  memcpy(seq_off, p.seq_off.data(), p.seq_off.size() * sizeof(int64_t));
  memcpy(names, p.names.data(), p.names.size());
  memcpy(name_off, p.name_off.data(), p.name_off.size() * sizeof(int64_t));
  memcpy(quals, p.quals.data(), p.quals.size());
  memcpy(qual_off, p.qual_off.data(), p.qual_off.size() * sizeof(int64_t));
  memcpy(comments, p.comments.data(), p.comments.size());
  memcpy(comment_off, p.comment_off.data(),
         p.comment_off.size() * sizeof(int64_t));
}

void fslr_fastx_free(void* h) { delete static_cast<Parsed*>(h); }

}  // extern "C"
