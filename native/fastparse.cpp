// fastparse — native data-loader for the profile-HMM scan engine.
//
// C ABI (ctypes-consumed) parsers for HMMER3/b ".hmm" profiles and
// protein FASTA databases, producing the dense arrays the JAX device
// paths consume. Semantics mirror the engine's Python reference parsers
// (hmm_fasta_viterbi/io/{hmmio,fastaio}.py), which in turn preserve
// the numeric conventions of the original C++ readers
// (reference data_readers/Profile_HMM.cpp: prob = expf(-strtof(tok)),
// model_length = LENG+1 dummy M0, '*' parsing as strtof 0.0 -> prob 1;
// reference data_readers/FASTA_protein_sequences.cpp: whole-sequence
// rejection on invalid symbols).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 fastparse.cpp
//
// Design notes (not a translation of the reference): one buffered read
// of the whole file, a zero-copy cursor tokenizer, and output as flat
// arrays + offset tables so Python wraps them with numpy without
// per-record objects.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kNumAmino = 20;
constexpr int kNumTransitions = 7;

// error codes shared with io/native.py
enum : int32_t {
  kOk = 0,
  kErrIo = 1,
  kErrFormat = 2,
  kErrBadArg = 3,
  kDone = 4,  // fp_parse_hmm_buf: no model records remain
};

bool read_file(const char* path, std::string& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(out.data(), 1, static_cast<size_t>(size), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(size);
}

// Cursor over the file buffer: line / token iteration without copies.
struct Cursor {
  const char* p;
  const char* end;

  bool eof() const { return p >= end; }

  // [begin, stop) of the current line; advances past the newline
  bool next_line(const char*& begin, const char*& stop) {
    if (eof()) return false;
    begin = p;
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (nl) {
      stop = nl;
      p = nl + 1;
    } else {
      stop = end;
      p = end;
    }
    if (stop > begin && stop[-1] == '\r') --stop;
    return true;
  }
};

const char* skip_ws(const char* p, const char* stop) {
  while (p < stop && (*p == ' ' || *p == '\t')) ++p;
  return p;
}

const char* token_end(const char* p, const char* stop) {
  while (p < stop && *p != ' ' && *p != '\t') ++p;
  return p;
}

// strtof-compatible: parses a leading float from [p, stop), 0.0f when
// no conversion is possible (the '*' quirk the reference enshrines)
float parse_float_token(const char* p, const char* stop) {
  // strtof needs NUL-terminated input; tokens are short, copy to stack
  char buf[64];
  size_t n = static_cast<size_t>(stop - p);
  if (n >= sizeof(buf)) n = sizeof(buf) - 1;
  memcpy(buf, p, n);
  buf[n] = '\0';
  return std::strtof(buf, nullptr);
}

// fills `values[n]` with expf(-x) for the first n float tokens at `p`
bool neg_log_probs(const char* p, const char* stop, float* values, int n) {
  for (int i = 0; i < n; ++i) {
    p = skip_ws(p, stop);
    if (p >= stop) return false;
    const char* te = token_end(p, stop);
    values[i] = std::exp(-parse_float_token(p, te));
    p = te;
  }
  return true;
}

bool line_first_token_is(const char* begin, const char* stop,
                         const char* tag, const char** rest) {
  const char* p = skip_ws(begin, stop);
  const char* te = token_end(p, stop);
  size_t n = strlen(tag);
  if (static_cast<size_t>(te - p) != n || memcmp(p, tag, n) != 0) return false;
  *rest = te;
  return true;
}

int amino_index(char c) {
  switch (c) {
    case 'A': return 0;  case 'C': return 1;  case 'D': return 2;
    case 'E': return 3;  case 'F': return 4;  case 'G': return 5;
    case 'H': return 6;  case 'I': return 7;  case 'K': return 8;
    case 'L': return 9;  case 'M': return 10; case 'N': return 11;
    case 'P': return 12; case 'Q': return 13; case 'R': return 14;
    case 'S': return 15; case 'T': return 16; case 'V': return 17;
    case 'W': return 18; case 'Y': return 19; default: return -1;
  }
}

}  // namespace

extern "C" {

struct FpFasta;
void fp_free_fasta(FpFasta* f);  // defined below; used by error paths above it

// ---------------------------------------------------------------------
// .hmm profile parsing
// ---------------------------------------------------------------------

struct FpHmm {
  int32_t model_length;  // LENG + 1 (dummy M0 at row 0)
  char name[256];
  double msv_mu, msv_lambda;
  double vit_mu, vit_lambda;
  double fwd_tau, fwd_lambda;
  float* match_emissions;   // [model_length * 20]
  float* insert_emissions;  // [model_length * 20]
  float* transitions;       // [model_length * 7]
};

static int32_t parse_hmm_span(const char* span_begin, const char* span_end,
                              FpHmm* out) {
  memset(out, 0, sizeof(*out));
  Cursor cur{span_begin, span_end};

  const char *begin, *stop, *rest;
  // NAME
  bool found = false;
  while (cur.next_line(begin, stop)) {
    if (line_first_token_is(begin, stop, "NAME", &rest)) {
      rest = skip_ws(rest, stop);
      size_t n = static_cast<size_t>(stop - rest);
      if (n >= sizeof(out->name)) n = sizeof(out->name) - 1;
      memcpy(out->name, rest, n);
      out->name[n] = '\0';
      // trim trailing whitespace
      while (n > 0 && isspace(static_cast<unsigned char>(out->name[n - 1])))
        out->name[--n] = '\0';
      found = true;
      break;
    }
  }
  if (!found) return kErrFormat;

  // LENG
  long leng = 0;
  found = false;
  while (cur.next_line(begin, stop)) {
    if (line_first_token_is(begin, stop, "LENG", &rest)) {
      rest = skip_ws(rest, stop);
      leng = std::strtol(rest, nullptr, 10);
      found = true;
      break;
    }
  }
  if (!found || leng <= 0) return kErrFormat;
  const int32_t m = static_cast<int32_t>(leng) + 1;
  out->model_length = m;

  // 3x STATS LOCAL {MSV, VITERBI, FORWARD} mu lambda
  for (int i = 0; i < 3; ++i) {
    found = false;
    while (cur.next_line(begin, stop)) {
      if (!line_first_token_is(begin, stop, "STATS", &rest)) continue;
      const char* p = skip_ws(rest, stop);          // LOCAL
      const char* te = token_end(p, stop);
      p = skip_ws(te, stop);                        // kind
      te = token_end(p, stop);
      char kind = (p < te) ? *p : '\0';
      const char* v1 = skip_ws(te, stop);
      const char* v1e = token_end(v1, stop);
      const char* v2 = skip_ws(v1e, stop);
      const char* v2e = token_end(v2, stop);
      double a = parse_float_token(v1, v1e);
      double b = parse_float_token(v2, v2e);
      if (kind == 'M') { out->msv_mu = a; out->msv_lambda = b; }
      else if (kind == 'V') { out->vit_mu = a; out->vit_lambda = b; }
      else if (kind == 'F') { out->fwd_tau = a; out->fwd_lambda = b; }
      else return kErrFormat;
      found = true;
      break;
    }
    if (!found) return kErrFormat;
  }

  out->match_emissions =
      static_cast<float*>(calloc(static_cast<size_t>(m) * kNumAmino, sizeof(float)));
  out->insert_emissions =
      static_cast<float*>(calloc(static_cast<size_t>(m) * kNumAmino, sizeof(float)));
  out->transitions =
      static_cast<float*>(calloc(static_cast<size_t>(m) * kNumTransitions, sizeof(float)));
  if (!out->match_emissions || !out->insert_emissions || !out->transitions)
    return kErrIo;

  // COMPO anchor, then node-0 insert emissions + transitions
  found = false;
  while (cur.next_line(begin, stop)) {
    if (line_first_token_is(begin, stop, "COMPO", &rest)) { found = true; break; }
  }
  if (!found) return kErrFormat;
  if (!cur.next_line(begin, stop) ||
      !neg_log_probs(begin, stop, out->insert_emissions, kNumAmino))
    return kErrFormat;
  if (!cur.next_line(begin, stop) ||
      !neg_log_probs(begin, stop, out->transitions, kNumTransitions))
    return kErrFormat;
  // match_emissions row 0 stays zero (dummy M0)

  // nodes 1..LENG: match line tagged with the node number, then insert,
  // then transitions
  char tag[16];
  for (int32_t k = 1; k < m; ++k) {
    snprintf(tag, sizeof(tag), "%d", k);
    found = false;
    while (cur.next_line(begin, stop)) {
      if (line_first_token_is(begin, stop, tag, &rest)) { found = true; break; }
    }
    if (!found) return kErrFormat;
    if (!neg_log_probs(rest, stop, out->match_emissions + k * kNumAmino, kNumAmino))
      return kErrFormat;
    if (!cur.next_line(begin, stop) ||
        !neg_log_probs(begin, stop, out->insert_emissions + k * kNumAmino, kNumAmino))
      return kErrFormat;
    if (!cur.next_line(begin, stop) ||
        !neg_log_probs(begin, stop, out->transitions + k * kNumTransitions,
                       kNumTransitions))
      return kErrFormat;
  }
  return kOk;
}

int32_t fp_parse_hmm(const char* path, FpHmm* out) {
  if (!path || !out) return kErrBadArg;
  std::string data;
  if (!read_file(path, data)) return kErrIo;
  return parse_hmm_span(data.data(), data.data() + data.size(), out);
}

// '//' at buffer start or immediately after '\n' terminates a model
// record; text after the two slashes on the same line belongs to the
// NEXT record (the reference fixtures end with '//' and no newline, so
// naive concatenation puts the next header on the terminator line).
static const char* find_record_end(const char* b, const char* e) {
  for (const char* p = b; p + 1 < e; ++p) {
    if (p[0] == '/' && p[1] == '/' && (p == b || p[-1] == '\n')) return p;
  }
  return e;
}

// Parse ONE model from buf[*pos:len); advance *pos past its '//'
// terminator (or to len). Returns kOk with a model, kDone when only
// whitespace remains, kErrFormat on a malformed record. The concatenated
// Pfam.hmm database shape — io/hmmio.py parse_hmm_multi's fast path.
int32_t fp_parse_hmm_buf(const char* buf, int64_t len, int64_t* pos,
                         FpHmm* out) {
  if (!buf || !pos || !out || *pos < 0 || *pos > len) return kErrBadArg;
  for (;;) {
    const char* b = buf + *pos;
    const char* e = buf + len;
    if (b >= e) return kDone;
    const char* rec_end = find_record_end(b, e);
    *pos = (rec_end == e) ? len : (rec_end - buf) + 2;
    const char* q = b;
    while (q < rec_end && isspace(static_cast<unsigned char>(*q))) ++q;
    if (q < rec_end) return parse_hmm_span(b, rec_end, out);
    if (rec_end == e) return kDone;  // trailing blank tail
    // blank span between terminators: keep scanning
  }
}

void fp_free_hmm(FpHmm* h) {
  if (!h) return;
  free(h->match_emissions);
  free(h->insert_emissions);
  free(h->transitions);
  h->match_emissions = h->insert_emissions = h->transitions = nullptr;
}

// ---------------------------------------------------------------------
// FASTA parsing
// ---------------------------------------------------------------------

struct FpFasta {
  int64_t num_records;    // valid records
  int64_t num_rejected;   // whole-sequence rejections (invalid symbols)
  int64_t total_tokens;
  int8_t* tokens;         // concatenated encoded residues of valid records
  int64_t* offsets;       // [num_records + 1] into tokens
  char* headers;          // NUL-joined headers of valid records
  int64_t headers_bytes;
};

int32_t fp_parse_fasta(const char* path, FpFasta* out) {
  if (!path || !out) return kErrBadArg;
  memset(out, 0, sizeof(*out));

  std::string data;
  if (!read_file(path, data)) return kErrIo;
  Cursor cur{data.data(), data.data() + data.size()};

  std::vector<int8_t> tokens;
  tokens.reserve(data.size());
  std::vector<int64_t> offsets{0};
  std::string headers;
  std::vector<int8_t> pending;       // current record's tokens
  std::string pending_header;
  bool in_record = false;
  bool pending_valid = true;

  auto flush = [&]() {
    if (!in_record) return;
    if (pending_valid) {
      tokens.insert(tokens.end(), pending.begin(), pending.end());
      offsets.push_back(static_cast<int64_t>(tokens.size()));
      headers.append(pending_header);
      headers.push_back('\0');
    } else {
      ++out->num_rejected;
    }
    pending.clear();
    pending_valid = true;
  };

  const char *begin, *stop;
  while (cur.next_line(begin, stop)) {
    if (begin < stop && *begin == '>') {
      flush();
      in_record = true;
      const char* h = begin + 1;
      while (h < stop && (*h == ' ' || *h == '\t')) ++h;
      pending_header.assign(h, static_cast<size_t>(stop - h));
      continue;
    }
    if (begin == stop) continue;  // blank line (reference UB — fixed)
    if (!in_record) return kErrFormat;  // data before first header
    // Match the Python parser (io/fastaio.py parse_fasta_text): each line is
    // stripped of leading/trailing blanks, but INTERIOR whitespace is an
    // invalid symbol that rejects the whole record.
    while (begin < stop && (*begin == ' ' || *begin == '\t')) ++begin;
    while (stop > begin && (stop[-1] == ' ' || stop[-1] == '\t')) --stop;
    for (const char* c = begin; c < stop; ++c) {
      int idx = amino_index(*c);
      if (idx < 0) {
        pending_valid = false;  // reject the whole sequence
      } else {
        pending.push_back(static_cast<int8_t>(idx));
      }
    }
  }
  flush();

  out->num_records = static_cast<int64_t>(offsets.size()) - 1;
  out->total_tokens = static_cast<int64_t>(tokens.size());
  out->headers_bytes = static_cast<int64_t>(headers.size());
  out->tokens = static_cast<int8_t*>(malloc(tokens.size() ? tokens.size() : 1));
  out->offsets = static_cast<int64_t*>(malloc(offsets.size() * sizeof(int64_t)));
  out->headers = static_cast<char*>(malloc(headers.size() ? headers.size() : 1));
  if (!out->tokens || !out->offsets || !out->headers) {
    fp_free_fasta(out);  // release whichever buffers DID allocate
    return kErrIo;
  }
  if (!tokens.empty()) memcpy(out->tokens, tokens.data(), tokens.size());
  memcpy(out->offsets, offsets.data(), offsets.size() * sizeof(int64_t));
  if (!headers.empty()) memcpy(out->headers, headers.data(), headers.size());
  return kOk;
}

void fp_free_fasta(FpFasta* f) {
  if (!f) return;
  free(f->tokens);
  free(f->offsets);
  free(f->headers);
  f->tokens = nullptr;
  f->offsets = nullptr;
  f->headers = nullptr;
}

// ---------------------------------------------------------------------
// Streaming FASTA parsing (bounded host memory)
// ---------------------------------------------------------------------
//
// Batch semantics mirror io/fastaio.py::iter_fasta_batches: each
// fp_fasta_next call returns at most `max_records` VALID records; the
// batch boundary falls on a '>' header line (which then starts the next
// batch); rejections are counted against the batch in which they were
// read. The engine's streaming scan path uses this to keep host memory
// at one batch for genome-scale databases while the device scans at
// kernel rate.

struct FpFastaStream {
  FILE* f = nullptr;
  std::string buf;            // unconsumed bytes (partial lines)
  size_t pos = 0;             // parse cursor into buf
  std::string pending_header; // record being accumulated
  std::vector<int8_t> pending;
  bool pending_valid = true;
  bool in_record = false;
  bool at_eof = false;
};

extern "C" FpFastaStream* fp_fasta_open(const char* path) {
  if (!path) return nullptr;
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new FpFastaStream();
  s->f = f;
  return s;
}

extern "C" void fp_fasta_close(FpFastaStream* s) {
  if (!s) return;
  if (s->f) std::fclose(s->f);
  delete s;
}

namespace {

// next complete line out of the stream buffer, refilling from the file
// as needed; false only at true EOF with nothing left
bool stream_next_line(FpFastaStream* s, std::string& line) {
  constexpr size_t kChunk = 1 << 20;
  for (;;) {
    size_t nl = s->buf.find('\n', s->pos);
    if (nl != std::string::npos) {
      size_t stop = nl;
      if (stop > s->pos && s->buf[stop - 1] == '\r') --stop;
      line.assign(s->buf, s->pos, stop - s->pos);
      s->pos = nl + 1;
      return true;
    }
    if (s->at_eof) {
      if (s->pos >= s->buf.size()) return false;
      size_t stop = s->buf.size();
      if (stop > s->pos && s->buf[stop - 1] == '\r') --stop;
      line.assign(s->buf, s->pos, stop - s->pos);
      s->pos = s->buf.size();
      return true;
    }
    // refill: drop consumed prefix, append one chunk
    s->buf.erase(0, s->pos);
    s->pos = 0;
    size_t old = s->buf.size();
    s->buf.resize(old + kChunk);
    size_t got = std::fread(&s->buf[old], 1, kChunk, s->f);
    s->buf.resize(old + got);
    if (got == 0) s->at_eof = true;
  }
}

}  // namespace

extern "C" int32_t fp_fasta_next(FpFastaStream* s, int64_t max_records,
                                 FpFasta* out, int32_t* done) {
  if (!s || !out || !done || max_records <= 0) return kErrBadArg;
  memset(out, 0, sizeof(*out));
  *done = 0;

  std::vector<int8_t> tokens;
  std::vector<int64_t> offsets{0};
  std::string headers;
  int64_t num_rejected = 0;

  auto flush = [&]() {
    if (!s->in_record) return;
    if (s->pending_valid) {
      tokens.insert(tokens.end(), s->pending.begin(), s->pending.end());
      offsets.push_back(static_cast<int64_t>(tokens.size()));
      headers.append(s->pending_header);
      headers.push_back('\0');
    } else {
      ++num_rejected;
    }
    s->pending.clear();
    s->pending_valid = true;
    s->in_record = false;
  };

  std::string line;
  bool batch_full = false;
  for (;;) {
    if (!stream_next_line(s, line)) {
      flush();
      *done = 1;
      break;
    }
    if (!line.empty() && line[0] == '>') {
      flush();
      if (static_cast<int64_t>(offsets.size()) - 1 >= max_records)
        batch_full = true;
      s->in_record = true;
      size_t h = 1;
      while (h < line.size() && (line[h] == ' ' || line[h] == '\t')) ++h;
      size_t e = line.size();
      while (e > h && (line[e - 1] == ' ' || line[e - 1] == '\t')) --e;
      s->pending_header.assign(line, h, e - h);
      if (batch_full) break;  // this header starts the NEXT batch
      continue;
    }
    if (line.empty()) continue;
    if (!s->in_record) return kErrFormat;  // data before first header
    // Same strip-then-reject-interior-whitespace semantics as fp_parse_fasta
    // and the Python parser (keeps --loader native/python record counts equal).
    size_t b = 0, e = line.size();
    while (b < e && (line[b] == ' ' || line[b] == '\t')) ++b;
    while (e > b && (line[e - 1] == ' ' || line[e - 1] == '\t')) --e;
    for (size_t ci = b; ci < e; ++ci) {
      int idx = amino_index(line[ci]);
      if (idx < 0) {
        s->pending_valid = false;
      } else {
        s->pending.push_back(static_cast<int8_t>(idx));
      }
    }
  }

  out->num_records = static_cast<int64_t>(offsets.size()) - 1;
  out->num_rejected = num_rejected;
  out->total_tokens = static_cast<int64_t>(tokens.size());
  out->headers_bytes = static_cast<int64_t>(headers.size());
  out->tokens = static_cast<int8_t*>(malloc(tokens.size() ? tokens.size() : 1));
  out->offsets = static_cast<int64_t*>(malloc(offsets.size() * sizeof(int64_t)));
  out->headers = static_cast<char*>(malloc(headers.size() ? headers.size() : 1));
  if (!out->tokens || !out->offsets || !out->headers) {
    fp_free_fasta(out);  // release whichever buffers DID allocate
    return kErrIo;
  }
  if (!tokens.empty()) memcpy(out->tokens, tokens.data(), tokens.size());
  memcpy(out->offsets, offsets.data(), offsets.size() * sizeof(int64_t));
  if (!headers.empty()) memcpy(out->headers, headers.data(), headers.size());
  return kOk;
}

int32_t fp_abi_version(void) { return 3; }

}  // extern "C"
