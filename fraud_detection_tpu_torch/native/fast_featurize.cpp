// Native host-side featurizer: clean -> tokenize -> stopword filter ->
// MurmurHash3_x86_32 bucket -> per-doc counts, batch-assembled into the
// padded (B, L) arrays the device program consumes.
//
// The PyTorch port's copy of fraud_detection_tpu/native/fast_featurize.cpp:
// the same code and C ABI, built by fraud_detection_tpu_torch/featurize/
// native.py into build/native/<source hash>/. It is host work, not a CUDA
// kernel: at serving rates the Python per-token loop starves the card, and
// the math here is trivial but must be BIT-EXACT with the Python reference
// implementation in featurize/{text,hashing}.py, which itself carries Spark
// parity (Tokenizer / StopWordsRemover / ml.feature.HashingTF semantics of
// the shipped dialogue_classification_model artifact).
//
// Parity contract replicated here:
//  * clean: Unicode-lowercase then keep only [a-z ]. For non-ASCII input the
//    only codepoints whose Python str.lower() yields an ASCII letter are
//    U+0130 (-> "i" + combining dot, dot stripped) and U+212A (Kelvin -> k);
//    both are special-cased, every other non-ASCII byte sequence strips.
//  * tokenize: Java String.split("\\s") semantics on the cleaned text —
//    leading/interior empty strings kept, trailing dropped, and splitting ""
//    returns [""] (the empty token is real: it flows through the stopword
//    filter and hashes into bucket murmur3("", 42) % F).
//  * stopwords: exact-match set (the Python side lowercases the list for the
//    case-insensitive default before handing it over).
//  * hash: standard MurmurHash3_x86_32 over UTF-8 bytes, seed 42, then
//    Spark's nonNegativeMod on the SIGNED hash.
//  * row assembly: unique buckets sorted ascending; if a row has more unique
//    buckets than L, keep the L highest counts (ties: lowest bucket id
//    first — numpy argsort(-val) stable-order semantics), then re-sort by id.
//
// Build (featurize/native.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -pthread fast_featurize.cpp -o libfastfeat.so

#include <algorithm>
#include <atomic>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

constexpr uint32_t C1 = 0xcc9e2d51u;
constexpr uint32_t C2 = 0x1b873593u;

inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t mix_k1(uint32_t k1) {
  k1 *= C1;
  k1 = rotl32(k1, 15);
  return k1 * C2;
}

inline uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xe6546b64u;
}

uint32_t murmur3_x86_32(const unsigned char* data, size_t len, uint32_t seed) {
  uint32_t h1 = seed;
  const size_t aligned = len & ~size_t(3);
  for (size_t i = 0; i < aligned; i += 4) {
    uint32_t k1 = uint32_t(data[i]) | (uint32_t(data[i + 1]) << 8) |
                  (uint32_t(data[i + 2]) << 16) | (uint32_t(data[i + 3]) << 24);
    h1 = mix_h1(h1, mix_k1(k1));
  }
  uint32_t k1 = 0;
  int shift = 0;
  for (size_t i = aligned; i < len; ++i) {
    k1 ^= uint32_t(data[i]) << shift;
    shift += 8;
  }
  h1 ^= mix_k1(k1);  // note: applied even when tail is empty (matches Spark)
  h1 ^= uint32_t(len);
  h1 ^= h1 >> 16;
  h1 *= 0x85ebca6bu;
  h1 ^= h1 >> 13;
  h1 *= 0xc2b2ae35u;
  h1 ^= h1 >> 16;
  return h1;
}

inline int non_negative_mod(int32_t x, int32_t mod) {
  int32_t r = x % mod;
  return r < 0 ? r + mod : r;
}

inline int hash_bucket(std::string_view term, int num_features) {
  uint32_t h = murmur3_x86_32(
      reinterpret_cast<const unsigned char*>(term.data()), term.size(), 42u);
  return non_negative_mod(static_cast<int32_t>(h), num_features);
}

struct Featurizer {
  int num_features;
  bool binary;
  bool remove_stopwords;
  std::vector<std::string> stopword_storage;          // owns the bytes
  std::unordered_set<std::string_view> stopwords;     // views into storage
  // Murmur-keyed open-addressing stopword table: tokens are murmur3-hashed
  // exactly once, and that hash serves BOTH the stopword probe and the
  // feature bucket — the std::hash pass of an unordered_set per token was
  // ~20% of single-core encode time.
  std::vector<std::pair<uint32_t, std::string_view>> stop_table;
  uint32_t stop_mask = 0;
  bool empty_is_stop = false;
  int empty_bucket = 0;  // bucket of the "" token (Java "".split -> [""])
  // per-batch scratch (kept between begin/fill calls; capacity persists
  // across batches so steady-state encodes do zero row allocations)
  std::vector<std::vector<std::pair<int, float>>> rows;  // sorted by bucket id
  int n_rows = 0;

  void build_stop_table() {
    size_t cap = 8;
    while (cap < stopwords.size() * 2 + 1) cap <<= 1;
    stop_table.assign(cap, {0u, std::string_view()});
    stop_mask = uint32_t(cap - 1);
    for (const auto& s : stopwords) {
      uint32_t h = murmur3_x86_32(
          reinterpret_cast<const unsigned char*>(s.data()), s.size(), 42u);
      uint32_t i = h & stop_mask;
      while (stop_table[i].second.data() != nullptr) i = (i + 1) & stop_mask;
      stop_table[i] = {h, s};
    }
    empty_is_stop = stopwords.count(std::string_view()) > 0;
    empty_bucket = hash_bucket(std::string_view(), num_features);
  }

  inline bool is_stop(uint32_t h, const char* data, size_t len) const {
    uint32_t i = h & stop_mask;
    while (true) {
      const auto& e = stop_table[i];
      if (e.second.data() == nullptr) return false;
      if (e.first == h && e.second.size() == len &&
          std::memcmp(e.second.data(), data, len) == 0)
        return true;
      i = (i + 1) & stop_mask;
    }
  }
};

// Epoch-stamped bucket accumulator: O(1) per token with NO per-row clearing
// (the stamp marks which rows a slot was last touched in) and no per-row
// sort at all — touched buckets are tracked in a bitmap whose set-bit scan
// yields ids in ascending order directly (157 word loads at 10k features
// beats sorting ~100 ints by ~25%). Replaces the earlier sort+run-length
// pass, which was ~40% of single-core encode time at typical (~100-300
// token) dialogue sizes. One accumulator per worker thread (~80KB at 10k
// features — L2-resident).
//
// Contract: every begin_row() is followed by exactly one emit() (emit is
// what clears the bitmap; the encode paths uphold this unconditionally).
struct StampCounter {
  std::vector<uint32_t> stamp;
  std::vector<float> count;
  std::vector<uint64_t> bits;
  int nwords = 0;
  uint32_t epoch = 0;

  void init(int n) {
    if (int(stamp.size()) != n) {
      stamp.assign(n, 0);
      count.assign(n, 0.0f);
      nwords = (n + 63) / 64;
      bits.assign(nwords, 0);
      epoch = 0;
    }
  }

  inline void begin_row() {
    if (++epoch == 0) {  // uint32 wrap: stale stamps would alias; re-zero
      std::fill(stamp.begin(), stamp.end(), 0u);
      epoch = 1;
    }
  }

  inline void add(int b) {
    if (stamp[b] != epoch) {
      stamp[b] = epoch;
      count[b] = 1.0f;
      bits[b >> 6] |= 1ull << (b & 63);
    } else {
      count[b] += 1.0f;
    }
  }

  inline void add_n(int b, int k) {
    if (stamp[b] != epoch) {
      stamp[b] = epoch;
      count[b] = float(k);
      bits[b >> 6] |= 1ull << (b & 63);
    } else {
      count[b] += float(k);
    }
  }

  // Id-sorted unique (bucket, count) row via the bitmap scan (clears the
  // bitmap as it goes). Returns the row width.
  int emit(std::vector<std::pair<int, float>>& row, bool binary) {
    row.clear();
    for (int w = 0; w < nwords; ++w) {
      uint64_t m = bits[w];
      if (!m) continue;
      bits[w] = 0;
      do {
        int b = w * 64 + __builtin_ctzll(m);
        m &= m - 1;
        row.emplace_back(b, binary ? 1.0f : count[b]);
      } while (m);
    }
    return int(row.size());
  }
};

// Streaming tokenizer: consumes cleaned input (letter runs, spaces, and the
// occasional decoded escape/UTF-8 char) and emits hashed buckets — fused
// clean -> split -> stopword -> murmur with no intermediate cleaned string.
// A token made of one already-clean [a-z] source run is hashed straight from
// the source bytes (zero copy); tokens needing case-folding or assembled
// across stripped chars materialize into `tok` via bulk appends. Replicates
// Java String.split("\\s") semantics: interior empty tokens are real
// (deferred via `pending_empty` until a later non-empty token proves them
// interior), trailing empties drop, and a fully-empty input is the single
// token [""].
struct TokenSink {
  const Featurizer* f;
  StampCounter& acc;
  std::string tok;                         // materialized token (bulk appends)
  const unsigned char* span_a = nullptr;   // pure-span token: clean source run
  const unsigned char* span_b = nullptr;
  int pending_empty = 0;
  bool seen_any = false;  // any cleaned char at all (incl. spaces)

  TokenSink(const Featurizer* f_, StampCounter& a) : f(f_), acc(a) {}

  inline bool tok_empty() const { return span_a == nullptr && tok.empty(); }

  inline void materialize() {
    if (span_a != nullptr) {
      tok.append(reinterpret_cast<const char*>(span_a), size_t(span_b - span_a));
      span_a = nullptr;
    }
  }

  // Slow-path single char (decoded escapes / special UTF-8 codepoints);
  // only cleaned chars ([a-z ]) may arrive here, same contract as before.
  inline void put(char c) {
    seen_any = true;
    if (c == ' ') {
      boundary();
    } else {
      materialize();
      tok.push_back(c);
    }
  }

  // Bulk letter run [a, b) of ASCII letters; `upper` = any of them is A-Z.
  inline void letters(const unsigned char* a, const unsigned char* b, bool upper) {
    seen_any = true;
    if (!upper && tok_empty()) {  // common case: whole run is already clean
      span_a = a;
      span_b = b;
      return;
    }
    materialize();
    size_t off = tok.size();
    tok.resize(off + size_t(b - a));
    char* d = &tok[off];
    for (const unsigned char* q = a; q < b; ++q) {
      unsigned char c = *q;
      *d++ = char(c >= 'A' && c <= 'Z' ? c - 'A' + 'a' : c);
    }
  }

  inline void boundary() {  // a (cleaned) space
    seen_any = true;
    if (tok_empty())
      ++pending_empty;
    else
      emit();
  }

  inline void flush_empties() {
    if (pending_empty) {
      if (!f->remove_stopwords || !f->empty_is_stop)
        acc.add_n(f->empty_bucket, pending_empty);
      pending_empty = 0;
    }
  }

  inline void emit() {
    flush_empties();
    const char* d;
    size_t n;
    if (span_a != nullptr) {
      d = reinterpret_cast<const char*>(span_a);
      n = size_t(span_b - span_a);
    } else {
      d = tok.data();
      n = tok.size();
    }
    uint32_t h = murmur3_x86_32(reinterpret_cast<const unsigned char*>(d), n, 42u);
    if (!f->remove_stopwords || !f->is_stop(h, d, n))
      acc.add(non_negative_mod(static_cast<int32_t>(h), f->num_features));
    tok.clear();
    span_a = nullptr;
  }

  void finish() {
    if (!tok_empty()) emit();            // final non-empty segment
    else if (!seen_any) emit();          // "" -> [""] (hash of empty token)
    pending_empty = 0;                   // trailing empties drop
  }
};

inline bool is_ascii_letter(unsigned char c) {
  unsigned char l = c | 0x20;  // folds A-Z onto a-z; nothing else lands there
  return l >= 'a' && l <= 'z';
}

// Bulk-process a plain-ASCII segment [s, e) with tight per-run loops instead
// of the per-byte sink state machine; stops early at the first non-ASCII
// byte (or backslash, when `stop_backslash` — the JSON-escape path). Returns
// where it stopped.
inline const unsigned char* ascii_segment(const unsigned char* s,
                                          const unsigned char* e,
                                          TokenSink& sink, bool stop_backslash) {
  while (s < e) {
    unsigned char c = *s;
    if (c >= 0x80 || (stop_backslash && c == '\\')) break;
    if (is_ascii_letter(c)) {
      const unsigned char* run = s;
      bool upper = (c < 'a');
      do {
        ++s;
        if (s >= e) break;
        c = *s;
        upper |= (is_ascii_letter(c) && c < 'a');
      } while (is_ascii_letter(c));
      sink.letters(run, s, upper);
    } else if (c == ' ') {
      sink.boundary();
      ++s;
    } else {
      ++s;  // strips to nothing (digits, punctuation, control chars)
    }
  }
  return s;
}

// Fused clean+tokenize+hash over raw UTF-8 (the plain-text encode path).
void encode_text_utf8(const Featurizer* f, const char* text, StampCounter& acc,
                      std::vector<std::pair<int, float>>& row) {
  acc.begin_row();
  TokenSink sink(f, acc);
  const unsigned char* p = reinterpret_cast<const unsigned char*>(text);
  const unsigned char* end = p + std::strlen(text);
  while (p < end) {
    unsigned char c = *p;
    if (c < 0x80) {
      p = ascii_segment(p, end, sink, /*stop_backslash=*/false);
    } else {
      // decode one UTF-8 sequence (permissive; invalid bytes skipped)
      uint32_t cp = 0;
      int extra = 0;
      if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; extra = 1; }
      else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; extra = 2; }
      else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; extra = 3; }
      else { ++p; continue; }
      ++p;
      bool ok = true;
      for (int i = 0; i < extra; ++i) {
        if ((*p & 0xC0) != 0x80) { ok = false; break; }
        cp = (cp << 6) | (*p & 0x3F);
        ++p;
      }
      if (!ok) continue;
      if (cp == 0x0130) sink.put('i');       // İ -> i + U+0307(stripped)
      else if (cp == 0x212A) sink.put('k');  // Kelvin sign -> k
      // all other non-ASCII codepoints lowercase outside [a-z ] and strip
    }
  }
  sink.finish();
  acc.emit(row, f->binary);
}

// ---------------------------------------------------------------------------
// Raw-JSON fast path: scan a whole Kafka message's JSON bytes, pull out the
// target string field, and clean+tokenize it in the same pass — so the serving
// engine never runs Python json.loads / json.dumps per message. The scanner
// matches CPython json.loads semantics (strict UTF-8, control-char rejection,
// escape validation, last-duplicate-key-wins, NaN/Infinity literals) so that
// a message it accepts is exactly one the Python slow path would accept; any
// message it REJECTS is re-checked by the engine with json.loads, keeping
// behavior identical even on inputs this scanner is stricter about.
// ---------------------------------------------------------------------------

struct JsonScanner {
  const unsigned char* base;
  const unsigned char* p;
  const unsigned char* end;
  static constexpr int kMaxDepth = 512;  // stricter than CPython's recursion
                                         // limit; deeper inputs fall back to
                                         // the Python decode path

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }

  bool lit(const char* s, size_t n) {
    if (size_t(end - p) < n || std::memcmp(p, s, n) != 0) return false;
    p += n;
    return true;
  }

  static bool hex4(const unsigned char* q, uint32_t* out) {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) {
      unsigned char c = q[i];
      uint32_t d;
      if (c >= '0' && c <= '9') d = c - '0';
      else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
      else return false;
      v = (v << 4) | d;
    }
    *out = v;
    return true;
  }

  // Strict UTF-8 validation (overlongs, surrogates, > U+10FFFF rejected —
  // the same inputs Python's bytes.decode("utf-8") rejects before json even
  // parses). Advances past one multi-byte sequence.
  bool skip_valid_utf8() {
    unsigned char c = *p;
    if (c < 0xC2) return false;  // stray continuation or overlong C0/C1 lead
    int need;
    unsigned char lo = 0x80, hi = 0xBF;
    if (c < 0xE0) need = 1;
    else if (c < 0xF0) {
      need = 2;
      if (c == 0xE0) lo = 0xA0;             // overlong
      else if (c == 0xED) hi = 0x9F;        // surrogates
    } else if (c < 0xF5) {
      need = 3;
      if (c == 0xF0) lo = 0x90;             // overlong
      else if (c == 0xF4) hi = 0x8F;        // > U+10FFFF
    } else {
      return false;
    }
    if (end - p <= need) return false;
    if (p[1] < lo || p[1] > hi) return false;
    for (int i = 2; i <= need; ++i)
      if ((p[i] & 0xC0) != 0x80) return false;
    p += need + 1;
    return true;
  }

  // Validate+skip a string starting at '"'. On success `*content_start` /
  // `*content_end` hold the offsets of the raw (still-escaped) contents.
  bool scan_string(int* content_start, int* content_end) {
    if (p >= end || *p != '"') return false;
    ++p;
    *content_start = int(p - base);
    while (p < end) {
      unsigned char c = *p;
      if (c == '"') {
        *content_end = int(p - base);
        ++p;
        return true;
      }
      if (c == '\\') {
        ++p;
        if (p >= end) return false;
        unsigned char e = *p;
        if (e == '"' || e == '\\' || e == '/' || e == 'b' || e == 'f' ||
            e == 'n' || e == 'r' || e == 't') {
          ++p;
        } else if (e == 'u') {
          ++p;
          uint32_t cp;
          if (end - p < 4 || !hex4(p, &cp)) return false;
          p += 4;
        } else {
          return false;
        }
      } else if (c < 0x20) {
        return false;  // raw control char (json.loads strict mode rejects)
      } else if (c < 0x80) {
        ++p;
      } else if (!skip_valid_utf8()) {
        return false;
      }
    }
    return false;  // unterminated
  }

  bool number() {
    if (p < end && *p == '-') ++p;
    if (p >= end) return false;
    if (*p == '0') {
      ++p;
    } else if (*p >= '1' && *p <= '9') {
      while (p < end && *p >= '0' && *p <= '9') ++p;
    } else {
      return false;
    }
    if (p < end && *p == '.') {
      ++p;
      if (p >= end || *p < '0' || *p > '9') return false;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
      ++p;
      if (p < end && (*p == '+' || *p == '-')) ++p;
      if (p >= end || *p < '0' || *p > '9') return false;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    return true;
  }

  bool object(int depth) {
    if (depth > kMaxDepth) return false;
    ++p;  // '{'
    ws();
    if (p < end && *p == '}') { ++p; return true; }
    while (true) {
      ws();
      int s, e;
      if (!scan_string(&s, &e)) return false;
      ws();
      if (p >= end || *p != ':') return false;
      ++p;
      if (!value(depth)) return false;
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      if (p < end && *p == '}') { ++p; return true; }
      return false;
    }
  }

  bool array(int depth) {
    if (depth > kMaxDepth) return false;
    ++p;  // '['
    ws();
    if (p < end && *p == ']') { ++p; return true; }
    while (true) {
      if (!value(depth)) return false;
      ws();
      if (p < end && *p == ',') { ++p; continue; }
      if (p < end && *p == ']') { ++p; return true; }
      return false;
    }
  }

  bool value(int depth) {
    ws();
    if (p >= end) return false;
    switch (*p) {
      case '"': { int s, e; return scan_string(&s, &e); }
      case '{': return object(depth + 1);
      case '[': return array(depth + 1);
      case 't': return lit("true", 4);
      case 'f': return lit("false", 5);
      case 'n': return lit("null", 4);
      case 'N': return lit("NaN", 3);          // json.loads accepts these
      case 'I': return lit("Infinity", 8);
      case '-':
        if (end - p >= 9 && std::memcmp(p, "-Infinity", 9) == 0) { p += 9; return true; }
        return number();
      default: return number();
    }
  }
};

// Decode the (validated) raw contents of a JSON string literal straight into
// the fused tokenizer — escapes like \n, \", \\ all clean to nothing; \uXXXX
// goes through the same codepoint rule as raw UTF-8. No intermediate decoded
// or cleaned string is ever materialized.
void decode_clean_json(const unsigned char* s, const unsigned char* e, TokenSink& sink) {
  while (s < e) {
    unsigned char c = *s;
    if (c == '\\') {
      unsigned char esc = s[1];
      s += 2;
      if (esc == 'u') {
        uint32_t cp = 0;
        JsonScanner::hex4(s, &cp);
        s += 4;
        if (cp >= 0xD800 && cp <= 0xDBFF && e - s >= 6 && s[0] == '\\' && s[1] == 'u') {
          uint32_t lo2 = 0;
          if (JsonScanner::hex4(s + 2, &lo2) && lo2 >= 0xDC00 && lo2 <= 0xDFFF) {
            cp = 0x10000 + ((cp - 0xD800) << 10) + (lo2 - 0xDC00);
            s += 6;
          }
          // lone high surrogate: falls through as cp in D800-DBFF -> strips,
          // exactly like the surrogate char json.loads produces
        }
        if (cp < 0x80) {
          unsigned char a = (unsigned char)cp;
          if (a >= 'A' && a <= 'Z') a = a - 'A' + 'a';
          if ((a >= 'a' && a <= 'z') || a == ' ') sink.put(char(a));
        } else if (cp == 0x0130) sink.put('i');
        else if (cp == 0x212A) sink.put('k');
      }
      // " \\ / b f n r t : none land in [a-z ] after cleaning -> emit nothing
    } else if (c < 0x80) {
      s = ascii_segment(s, e, sink, /*stop_backslash=*/true);
    } else {
      // already validated UTF-8: decode the codepoint permissively
      uint32_t cp = 0;
      int extra = 0;
      if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; extra = 1; }
      else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; extra = 2; }
      else { cp = c & 0x07; extra = 3; }
      ++s;
      for (int i = 0; i < extra && s < e; ++i, ++s) cp = (cp << 6) | (*s & 0x3F);
      if (cp == 0x0130) sink.put('i');
      else if (cp == 0x212A) sink.put('k');
      // cp < 0x80 impossible here (multi-byte lead); others strip
    }
  }
}

// Parse one message. Returns 1 and fills span_start/span_len (raw string
// literal INCLUDING quotes) + the tokenized row when the top level is a JSON
// object whose last `key` entry is a string; 0 otherwise (any malformation —
// the engine re-checks 0s with Python json.loads for exact-semantics routing).
int parse_json_message(const Featurizer* f, const unsigned char* base, int len,
                       std::string_view key, int32_t* span_start,
                       int32_t* span_len, StampCounter& acc,
                       std::vector<std::pair<int, float>>& row) {
  JsonScanner sc{base, base, base + len};
  sc.ws();
  if (sc.p >= sc.end || *sc.p != '{') return 0;
  ++sc.p;
  sc.ws();
  bool found = false, found_str = false;
  int fs = 0, fe = 0;  // raw contents offsets of the last matching value
  if (sc.p < sc.end && *sc.p == '}') {
    ++sc.p;
  } else {
    while (true) {
      sc.ws();
      int ks, ke;
      if (!sc.scan_string(&ks, &ke)) return 0;
      // Keys are matched on raw bytes; an escape-written key (e.g. "text")
      // decodes to a byte string this comparison can't see, so a duplicate of
      // the text field could win under json.loads last-duplicate-wins while we
      // match the literal spelling. Any escaped key disqualifies the message
      // to the exact-semantics (json.loads) slow path.
      if (std::memchr(base + ks, '\\', size_t(ke - ks)) != nullptr) return 0;
      bool is_key = size_t(ke - ks) == key.size() &&
                    std::memcmp(base + ks, key.data(), key.size()) == 0;
      sc.ws();
      if (sc.p >= sc.end || *sc.p != ':') return 0;
      ++sc.p;
      if (is_key) {
        sc.ws();
        if (sc.p < sc.end && *sc.p == '"') {
          int vs, ve;
          if (!sc.scan_string(&vs, &ve)) return 0;
          found = true;
          found_str = true;
          fs = vs;
          fe = ve;
        } else {
          if (!sc.value(1)) return 0;
          found = true;
          found_str = false;  // duplicate keys: LAST one wins (json.loads)
        }
      } else {
        if (!sc.value(1)) return 0;
      }
      sc.ws();
      if (sc.p < sc.end && *sc.p == ',') { ++sc.p; continue; }
      if (sc.p < sc.end && *sc.p == '}') { ++sc.p; break; }
      return 0;
    }
  }
  sc.ws();
  if (sc.p != sc.end) return 0;  // trailing garbage
  if (!found || !found_str) return 0;
  *span_start = fs - 1;        // include the opening quote
  *span_len = (fe - fs) + 2;   // ... and the closing one
  acc.begin_row();
  TokenSink sink(f, acc);
  decode_clean_json(base + fs, base + fe, sink);
  sink.finish();
  acc.emit(row, f->binary);
  return 1;
}

// Split [0, n) across worker threads; each shard returns its max row width
// and the overall max is returned. Docs are independent, so the batch
// parallelizes trivially (the caller holds the GIL-released ctypes call —
// this is where the host-side throughput headroom lives, SURVEY.md §7 hard
// part 3).
template <typename Fn>
int run_sharded(int n, Fn&& encode_range) {
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = std::min<int>(hw ? hw : 1, 8);
  // Thread spawn costs ~10s of microseconds each; only worth it for real batches.
  if (n_threads <= 1 || n < 256) return encode_range(0, n);

  std::atomic<int> width{0};
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  const int per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int lo = t * per;
    const int hi = std::min(n, lo + per);
    if (lo >= hi) break;
    workers.emplace_back([&width, &encode_range, lo, hi] {
      int w = encode_range(lo, hi);
      int cur = width.load(std::memory_order_relaxed);
      while (w > cur &&
             !width.compare_exchange_weak(cur, w, std::memory_order_relaxed)) {
      }
    });
  }
  for (auto& w : workers) w.join();
  return width.load(std::memory_order_relaxed);
}

// Shared fill core: drain a row store into padded (n_rows, L) output arrays,
// truncating over-long rows by the parity-critical keep-top-L rule. Used by
// the handle-state fills below AND the stateless shard fills (which write a
// row-slice of a larger caller-owned array — same rule, same bytes).
template <typename IdT, typename CtT, typename IdCast, typename CtCast>
void fill_row_store(const std::vector<std::vector<std::pair<int, float>>>& rows,
                    int n_avail, IdT* ids, CtT* counts, int n_rows, int L,
                    IdCast id_cast, CtCast ct_cast) {
  std::memset(ids, 0, sizeof(IdT) * size_t(n_rows) * L);
  std::memset(counts, 0, sizeof(CtT) * size_t(n_rows) * L);
  const int n = std::min<int>(n_avail, n_rows);
  std::vector<std::pair<int, float>> kept;
  for (int d = 0; d < n; ++d) {
    auto* row = &rows[d];
    if (int(row->size()) > L) {
      // keep the L highest counts; ties resolved toward the lower bucket id
      // (numpy stable argsort(-val) over id-sorted input), then re-sort by id
      kept.assign(row->begin(), row->end());
      std::stable_sort(kept.begin(), kept.end(),
                       [](const auto& a, const auto& b) { return a.second > b.second; });
      kept.resize(L);
      std::sort(kept.begin(), kept.end());
      row = &kept;
    }
    IdT* idp = ids + size_t(d) * L;
    CtT* ctp = counts + size_t(d) * L;
    for (size_t j = 0; j < row->size(); ++j) {
      idp[j] = id_cast((*row)[j].first);
      ctp[j] = ct_cast((*row)[j].second);
    }
  }
}

template <typename IdT, typename CtT, typename IdCast, typename CtCast>
void fill_rows(Featurizer* f, IdT* ids, CtT* counts, int n_rows, int L,
               IdCast id_cast, CtCast ct_cast) {
  fill_row_store(f->rows, f->n_rows, ids, counts, n_rows, L, id_cast, ct_cast);
  f->n_rows = 0;  // rows keep their capacity for the next batch
}

// One caller-owned shard of a batch: row state for the stateless shard API
// below. The Featurizer handle is strictly READ-ONLY during shard calls
// (config + stop tables), so any number of shards may encode concurrently
// over one handle — this is the batch-shard entry point the Python
// thread-pool featurizer (featurize/parallel.py) drives, one GIL-releasing
// ctypes call per shard per phase.
struct ShardState {
  std::vector<std::vector<std::pair<int, float>>> rows;
};

}  // namespace

extern "C" {

void* ftok_create(const char** stopwords, int n_stop, int num_features,
                  int binary, int remove_stopwords) {
  auto* f = new Featurizer;
  f->num_features = num_features;
  f->binary = binary != 0;
  f->remove_stopwords = remove_stopwords != 0;
  f->stopword_storage.reserve(n_stop);  // no reallocation: views stay valid
  for (int i = 0; i < n_stop; ++i) {
    f->stopword_storage.emplace_back(stopwords[i]);
    f->stopwords.insert(std::string_view(f->stopword_storage.back()));
  }
  f->build_stop_table();
  return f;
}

void ftok_destroy(void* h) { delete static_cast<Featurizer*>(h); }

int ftok_hash_bucket(void* h, const char* term) {
  return hash_bucket(term, static_cast<Featurizer*>(h)->num_features);
}

// Tokenize+hash the batch into handle state; returns max unique-bucket width.
// Docs are independent, so the batch is split across worker threads (the
// caller holds the GIL-released ctypes call; this is where the host-side
// throughput headroom lives — SURVEY.md §7 hard part 3).
int ftok_encode_begin(void* h, const char** texts, int n_texts) {
  auto* f = static_cast<Featurizer*>(h);
  // rows keep their per-doc capacity across batches: steady-state encodes do
  // zero row allocations (assign() would free every vector each call).
  if (int(f->rows.size()) < n_texts) f->rows.resize(n_texts);
  f->n_rows = n_texts;

  auto encode_range = [f, texts](int lo, int hi) -> int {
    StampCounter acc;  // per-worker: no shared mutable state across shards
    acc.init(f->num_features);
    int width = 0;
    for (int d = lo; d < hi; ++d) {
      encode_text_utf8(f, texts[d], acc, f->rows[d]);
      width = std::max(width, int(f->rows[d].size()));
    }
    return width;
  };
  return run_sharded(n_texts, encode_range);
}

// Raw-JSON batch encode: per message, parse the JSON object, pull the string
// value of `key` (utf8, key_len bytes), clean+tokenize+hash it into the
// handle's row state (same state ftok_encode_fill reads). Outputs per
// message: status[i] (1 = encoded, 0 = malformed / key missing / non-string
// — those rows are all-padding) and the raw string literal's span in
// msgs[i] (INCLUDING both quotes) for zero-copy splicing into output JSON.
// Returns the max unique-bucket width over successfully encoded rows.
int ftok_encode_json_begin(void* h, const char** msgs, const int32_t* lens,
                           int n_msgs, const char* key, int key_len,
                           int32_t* status, int32_t* span_start,
                           int32_t* span_len) {
  auto* f = static_cast<Featurizer*>(h);
  if (int(f->rows.size()) < n_msgs) f->rows.resize(n_msgs);
  f->n_rows = n_msgs;
  std::string_view key_view(key, key_len);

  auto encode_range = [&](int lo, int hi) -> int {
    StampCounter acc;  // per-worker: no shared mutable state across shards
    acc.init(f->num_features);
    int width = 0;
    for (int d = lo; d < hi; ++d) {
      span_start[d] = 0;
      span_len[d] = 0;
      f->rows[d].clear();
      status[d] = parse_json_message(
          f, reinterpret_cast<const unsigned char*>(msgs[d]), lens[d], key_view,
          span_start + d, span_len + d, acc, f->rows[d]);
      if (status[d]) width = std::max(width, int(f->rows[d].size()));
    }
    return width;
  };
  return run_sharded(n_msgs, encode_range);
}

// Fill padded (rows, L) arrays from handle state. The truncate-to-L rule is
// parity-critical (keep the L highest counts; ties toward the lower bucket
// id — numpy stable argsort(-val) over id-sorted input — then re-sort by id)
// and shared by both output-dtype variants below.
void ftok_encode_fill(void* h, int32_t* ids, float* counts, int n_rows, int L) {
  fill_rows(static_cast<Featurizer*>(h), ids, counts, n_rows, L,
            [](int b) { return int32_t(b); },
            [](float v) { return v; });
}

// Same fill but emitting the device wire dtypes directly — int16 ids
// (callers gate on num_features <= 32767) and uint16 counts (clipped) —
// skipping the Python-side astype+copy of two (B, L) arrays.
void ftok_encode_fill16(void* h, int16_t* ids, uint16_t* counts, int n_rows, int L) {
  fill_rows(static_cast<Featurizer*>(h), ids, counts, n_rows, L,
            [](int b) { return int16_t(b); },
            [](float v) { return uint16_t(v > 65535.0f ? 65535u : uint32_t(v)); });
}

// ---------------------------------------------------------------------------
// Stateless batch-shard API. ftok_encode_begin/fill keep their row state on
// the handle (one in-flight batch per handle, caller-locked); these instead
// return an opaque shard object, so N Python worker threads can encode N
// shards of one batch CONCURRENTLY over a single handle:
//   phase 1: shard = ftok_shard_begin(h, texts, n)   (parallel; returns width)
//   barrier: L = pad(max shard widths)
//   phase 2: ftok_shard_fill16(shard, ids+lo*L, counts+lo*L, n, L) (parallel —
//            each shard writes its own row-slice of the caller's arrays)
//   ftok_shard_destroy(shard)
// Each phase is one GIL-releasing ctypes call, which is what makes the
// Python-side thread pool an actual parallelism win.
// ---------------------------------------------------------------------------

void* ftok_shard_begin(void* h, const char** texts, int n_texts,
                       int32_t* width_out) {
  auto* f = static_cast<Featurizer*>(h);
  auto* s = new ShardState;
  s->rows.resize(size_t(std::max(n_texts, 0)));
  StampCounter acc;  // per-shard: no shared mutable state with other shards
  acc.init(f->num_features);
  int width = 0;
  for (int d = 0; d < n_texts; ++d) {
    encode_text_utf8(f, texts[d], acc, s->rows[d]);
    width = std::max(width, int(s->rows[d].size()));
  }
  *width_out = width;
  return s;
}

void ftok_shard_fill(void* sh, int32_t* ids, float* counts, int n_rows, int L) {
  auto* s = static_cast<ShardState*>(sh);
  fill_row_store(s->rows, int(s->rows.size()), ids, counts, n_rows, L,
                 [](int b) { return int32_t(b); },
                 [](float v) { return v; });
}

void ftok_shard_fill16(void* sh, int16_t* ids, uint16_t* counts, int n_rows,
                       int L) {
  auto* s = static_cast<ShardState*>(sh);
  fill_row_store(s->rows, int(s->rows.size()), ids, counts, n_rows, L,
                 [](int b) { return int16_t(b); },
                 [](float v) { return uint16_t(v > 65535.0f ? 65535u : uint32_t(v)); });
}

void ftok_shard_destroy(void* sh) { delete static_cast<ShardState*>(sh); }

// Raw-JSON shard twin of ftok_shard_begin: parse+extract+tokenize one shard
// of a message batch into an opaque shard object, writing that shard's
// status/span entries into the CALLER's (disjoint) array slices. The handle
// is read-only here, so N Python worker threads fan a batch out over one
// handle exactly like the text shards — and because the caller marshals ONE
// char*[] for the whole batch and passes sub-pointers, the full array stays
// valid as the splice context for ftok_build_frames afterwards
// (featurize/parallel.py encode_json_sharded_native).
void* ftok_shard_json_begin(void* h, const char** msgs, const int32_t* lens,
                            int n_msgs, const char* key, int key_len,
                            int32_t* status, int32_t* span_start,
                            int32_t* span_len, int32_t* width_out) {
  auto* f = static_cast<Featurizer*>(h);
  auto* s = new ShardState;
  s->rows.resize(size_t(std::max(n_msgs, 0)));
  std::string_view key_view(key, size_t(key_len));
  StampCounter acc;  // per-shard: no shared mutable state with other shards
  acc.init(f->num_features);
  int width = 0;
  for (int d = 0; d < n_msgs; ++d) {
    span_start[d] = 0;
    span_len[d] = 0;
    s->rows[d].clear();
    status[d] = parse_json_message(
        f, reinterpret_cast<const unsigned char*>(msgs[d]), lens[d], key_view,
        span_start + d, span_len + d, acc, s->rows[d]);
    if (status[d]) width = std::max(width, int(s->rows[d].size()));
  }
  *width_out = width;
  return s;
}

// %.6f, locale-independent and hard-bounded: a co-loaded library calling
// setlocale must not turn the decimal point into a comma, and out-of-[0,1]
// inputs whose fixed rendering exceeds the caller's size estimate must fail
// cleanly (nullptr) instead of overrunning. Float to_chars needs libstdc++
// 11+; older C++17 toolchains take the bounded snprintf + comma-patch path
// so the on-demand build never regresses to import failure.
static inline char* format_fixed6(char* p, char* lim, double v) {
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  auto cr = std::to_chars(p, lim, v, std::chars_format::fixed, 6);
  if (cr.ec != std::errc()) return nullptr;
  return cr.ptr;
#else
  long long rem = lim - p;
  if (rem <= 1) return nullptr;
  int n = std::snprintf(p, size_t(rem), "%.6f", v);
  if (n < 0 || n >= rem) return nullptr;  // truncated: caller returns -1
  for (char* q = p; q < p + n; ++q)
    if (*q == ',') *q = '.';  // LC_NUMERIC-proof
  return p + n;
#endif
}

// Assemble the engine's classified-output wire frames for a whole batch in
// one pass (stateless — no handle). Frame layout must stay byte-identical to
// the engine's Python template path (stream/engine.py _OUT_TEMPLATE):
//   {"prediction": %d, "label": %s, "confidence": %.6f, "original_text": %s}
// The text is each message's own raw string literal INCLUDING quotes —
// spliced straight out of the message buffer (msgs[i] + span_start[i],
// span_len[i] bytes; the spans ftok_encode_json_begin reported), never
// re-encoded. The caller passes the SAME msgs array it encoded with, so no
// per-message marshalling happens on this call. labels[i] indexes
// label_jsons; rows with labels[i] < 0 or >= n_labels emit an EMPTY frame
// (ends[i] == ends[i-1]) and the caller routes them through its Python
// fallback. Returns total bytes written, or -1 if `cap` is too small.
long long ftok_build_frames(const char** msgs, const int32_t* span_start,
                            const int32_t* span_len, const int32_t* labels,
                            const double* confs, const char** label_jsons,
                            const int32_t* label_json_lens, int n_labels,
                            int n, char* out, long long cap, int64_t* ends) {
  static const char kPred[] = "{\"prediction\": ";
  static const char kLabel[] = ", \"label\": ";
  static const char kConf[] = ", \"confidence\": ";
  static const char kText[] = ", \"original_text\": ";
  char* p = out;
  char* lim = out + cap;
  for (int i = 0; i < n; ++i) {
    int lab = labels[i];
    if (lab < 0 || lab >= n_labels) {  // caller's Python path owns this row
      ends[i] = p - out;
      continue;
    }
    // worst case: prefixes+braces ~70B, label json, %.6f of a double in
    // [0, 1e6) <= 14B, int label <= 11B, text literal
    long long need = 96 + label_json_lens[lab] + span_len[i];
    if (p + need > lim) return -1;
    std::memcpy(p, kPred, sizeof(kPred) - 1); p += sizeof(kPred) - 1;
    p = std::to_chars(p, lim, lab).ptr;
    std::memcpy(p, kLabel, sizeof(kLabel) - 1); p += sizeof(kLabel) - 1;
    std::memcpy(p, label_jsons[lab], size_t(label_json_lens[lab]));
    p += label_json_lens[lab];
    std::memcpy(p, kConf, sizeof(kConf) - 1); p += sizeof(kConf) - 1;
    p = format_fixed6(p, lim, confs[i]);
    if (p == nullptr) return -1;
    // Re-check: an out-of-range confidence can out-grow the 14-byte
    // allowance inside `need` (to_chars above only bounded itself).
    if (p + (long long)(sizeof(kText) - 1) + span_len[i] + 1 > lim) return -1;
    std::memcpy(p, kText, sizeof(kText) - 1); p += sizeof(kText) - 1;
    std::memcpy(p, msgs[i] + span_start[i], size_t(span_len[i]));
    p += span_len[i];
    *p++ = '}';
    ends[i] = p - out;
  }
  return p - out;
}

}  // extern "C"
