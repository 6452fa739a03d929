// Fast document tokenizer — the index-build hot loop in native code.
//
// Semantics match utils/text.py:_tokenize_document_py ("simple_en_v1",
// reference nlp/12_product_prep.py:75-78): lowercase, tokens are
// [a-z0-9]+(?:'[a-z0-9]+)? runs, drop the document stoplist and 1-char
// tokens, cap the token count. ASCII-only by contract: the Python wrapper
// routes non-ASCII texts to the Python fallback (Unicode lowercasing can
// manufacture ASCII letters, e.g. the Kelvin sign, which a byte-level
// scanner cannot reproduce).
//
// Interface (extern "C", ctypes-friendly):
//   rrt_tokenize(text, len, out, out_cap, max_tokens) -> n_tokens
//     writes '\n'-separated tokens into `out` (always NUL-terminated);
//     returns -1 if `out` is too small.
//   rrt_tokenize_batch(...) amortizes the FFI crossing over many documents.
//
// Build: make -C review_recommender_tpu/native   (produces librrt_native.so)

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxTokenLen = 64;  // longer runs are split naturally

// Document stoplist (utils/text.py DOC_STOP_WORDS). Perfect lookup via
// length-bucketed linear scan — the list is tiny and L1-resident.
const char* const kStops[] = {
    "a", "an", "and", "the", "is", "are", "am", "be", "been", "to", "for",
    "of", "in", "on", "at", "by", "it", "its", "this", "that", "with",
    "from", "as", "or", "if", "but", "than", "then", "so", "i", "you",
    "he", "she", "we", "they", "my", "your", "our", "their", "me", "him",
    "her", "us", "them", "was", "were", "will", "would", "should", "could",
    "may", "might", "can", "cannot", "cant", "won't",
};
constexpr int kNumStops = sizeof(kStops) / sizeof(kStops[0]);

bool is_stop(const char* tok, int len) {
  for (int i = 0; i < kNumStops; ++i) {
    const char* s = kStops[i];
    int j = 0;
    for (; j < len && s[j]; ++j) {
      if (s[j] != tok[j]) break;
    }
    if (j == len && s[j] == '\0') return true;
  }
  return false;
}

inline bool is_alnum_lower(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
}

inline unsigned char to_lower(unsigned char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<unsigned char>(c + 32) : c;
}

}  // namespace

extern "C" {

// Returns number of tokens written (or -1 if out buffer too small).
// Tokens stream straight into `out` (no intermediate buffer), so token
// length is unbounded — matching the Python regex exactly.
int64_t rrt_tokenize(const char* text, int64_t len, char* out,
                     int64_t out_cap, int64_t max_tokens) {
  int64_t n_tokens = 0;
  int64_t out_pos = 0;
  int64_t i = 0;

  while (i < len && n_tokens < max_tokens) {
    unsigned char c = to_lower(static_cast<unsigned char>(text[i]));
    if (!is_alnum_lower(c)) {
      ++i;
      continue;
    }
    const int64_t tok_start = out_pos;
    // [a-z0-9]+ run
    while (i < len) {
      c = to_lower(static_cast<unsigned char>(text[i]));
      if (!is_alnum_lower(c)) break;
      if (out_pos >= out_cap) return -1;
      out[out_pos++] = static_cast<char>(c);
      ++i;
    }
    // optional ('[a-z0-9]+) tail, only if followed by an alnum
    if (i + 1 < len && text[i] == '\'') {
      unsigned char nxt = to_lower(static_cast<unsigned char>(text[i + 1]));
      if (is_alnum_lower(nxt)) {
        if (out_pos >= out_cap) return -1;
        out[out_pos++] = '\'';
        ++i;
        while (i < len) {
          c = to_lower(static_cast<unsigned char>(text[i]));
          if (!is_alnum_lower(c)) break;
          if (out_pos >= out_cap) return -1;
          out[out_pos++] = static_cast<char>(c);
          ++i;
        }
      }
    }
    const int64_t tlen = out_pos - tok_start;
    if (tlen <= 1 ||
        (tlen < kMaxTokenLen &&
         is_stop(out + tok_start, static_cast<int>(tlen)))) {
      out_pos = tok_start;  // rollback
      continue;
    }
    if (out_pos >= out_cap) return -1;
    out[out_pos++] = '\n';
    ++n_tokens;
  }
  out[out_pos < out_cap ? out_pos : out_cap - 1] = '\0';
  return n_tokens;
}

// Batch variant: texts are concatenated, offsets has n_docs+1 entries.
// Output tokens are '\n'-separated; doc boundaries at out_counts[d] tokens.
// Returns total tokens, or -1 on buffer overflow.
int64_t rrt_tokenize_batch(const char* blob, const int64_t* offsets,
                           int64_t n_docs, char* out, int64_t out_cap,
                           int64_t max_tokens_per_doc, int64_t* out_counts) {
  int64_t total = 0;
  int64_t out_pos = 0;
  for (int64_t d = 0; d < n_docs; ++d) {
    const char* text = blob + offsets[d];
    int64_t len = offsets[d + 1] - offsets[d];
    int64_t n = rrt_tokenize(text, len, out + out_pos, out_cap - out_pos,
                             max_tokens_per_doc);
    if (n < 0) return -1;
    // advance past what rrt_tokenize wrote (tokens + newlines)
    int64_t written = 0;
    for (int64_t t = 0, p = out_pos; t < n; ++t) {
      while (out[p] != '\n') { ++p; ++written; }
      ++p; ++written;
    }
    out_pos += written;
    out_counts[d] = n;
    total += n;
  }
  if (out_pos < out_cap) out[out_pos] = '\0';
  return total;
}

// Substring scan over a '\n'-separated vocabulary blob: writes the int32
// term ids (1-based, id = line index + 1) of terms CONTAINING `needle` into
// out_ids. Returns the hit count (or -1 if out_cap exceeded). This is the
// featurizer's dynamic-gate expansion hot loop
// (engine/featurize.py:_expand_token — np.char.find over the vocab).
int64_t rrt_substring_scan(const char* blob, int64_t blob_len,
                           const char* needle, int64_t needle_len,
                           int32_t* out_ids, int64_t out_cap) {
  if (needle_len <= 0) return 0;
  int64_t count = 0;
  int32_t term_id = 1;
  const char* p = blob;
  const char* end = blob + blob_len;
  const char first = needle[0];
  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* term_end = nl ? nl : end;
    const int64_t tlen = term_end - p;
    if (tlen >= needle_len) {
      const char* limit = term_end - needle_len;
      for (const char* q = p; q <= limit; ++q) {
        if (*q == first &&
            std::memcmp(q, needle, static_cast<size_t>(needle_len)) == 0) {
          if (count >= out_cap) return -1;
          out_ids[count++] = term_id;
          break;
        }
      }
    }
    ++term_id;
    p = term_end + 1;
  }
  return count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full postings build: tokenize + vocab assignment + per-doc (term id, tf)
// packing in one native pass — the index-build hot loop
// (index/build.py:build_product_index) without materializing any Python
// strings. Vocab ids are assigned in first-global-occurrence order and
// per-doc term lists keep first-occurrence order then stable-sort by tf
// descending before the cap — bit-identical to the Python reference path.
// ---------------------------------------------------------------------------

#include <algorithm>
#include <string>
#include <vector>

namespace {

struct VocabTable {
  // open addressing, FNV-1a, power-of-two capacity
  std::vector<int64_t> slots;     // index into terms_, -1 empty
  std::vector<std::string> terms;
  explicit VocabTable(int64_t cap_hint) {
    int64_t cap = 1024;
    while (cap < cap_hint * 2) cap <<= 1;
    slots.assign(static_cast<size_t>(cap), -1);
  }
  static uint64_t hash(const char* s, int64_t n) {
    uint64_t h = 0xcbf29ce484222325ULL;
    for (int64_t i = 0; i < n; ++i) {
      h ^= static_cast<unsigned char>(s[i]);
      h *= 0x100000001b3ULL;
    }
    return h;
  }
  void maybe_grow() {
    if (terms.size() * 2 < slots.size()) return;
    std::vector<int64_t> ns(slots.size() * 2, -1);
    uint64_t mask = ns.size() - 1;
    for (int64_t idx : slots) {
      if (idx < 0) continue;
      const std::string& t = terms[static_cast<size_t>(idx)];
      uint64_t p = hash(t.data(), static_cast<int64_t>(t.size())) & mask;
      while (ns[p] >= 0) p = (p + 1) & mask;
      ns[p] = idx;
    }
    slots.swap(ns);
  }
  // returns 0-based term index, creating if absent
  int64_t get_or_add(const char* s, int64_t n) {
    maybe_grow();
    uint64_t mask = slots.size() - 1;
    uint64_t p = hash(s, n) & mask;
    while (slots[p] >= 0) {
      const std::string& t = terms[static_cast<size_t>(slots[p])];
      if (static_cast<int64_t>(t.size()) == n &&
          std::memcmp(t.data(), s, static_cast<size_t>(n)) == 0)
        return slots[p];
      p = (p + 1) & mask;
    }
    slots[p] = static_cast<int64_t>(terms.size());
    terms.emplace_back(s, static_cast<size_t>(n));
    return slots[p];
  }
};

}  // namespace

extern "C" {

// Returns vocab size (>=0) or -1 on vocab_out overflow.
// doc_terms/doc_tf are (n_docs, doc_terms_cap) row-major, pre-zeroed or not
// (fully overwritten: PAD id 0 / tf 0 in unused lanes).
// df_out must hold vocab_cap+1 int32 (index 0 = PAD, stays 0).
// vocab_out receives '\n'-joined terms in id order (id = line index + 1).
int64_t rrt_build_postings(const char* blob, const int64_t* offsets,
                           int64_t n_docs, int64_t max_tokens_per_doc,
                           int64_t doc_terms_cap, int32_t* doc_terms,
                           float* doc_tf, float* doc_len, int32_t* df_out,
                           char* vocab_out, int64_t vocab_out_cap,
                           int64_t vocab_cap, int64_t* n_truncated) {
  VocabTable vocab(1 << 16);
  std::vector<float> df;  // per-term doc frequency (0-based term index)
  std::vector<int64_t> last_doc;  // last doc that touched term (for df)
  std::vector<int64_t> tok_buf;   // token term-indices for current doc
  std::string scratch;
  int64_t truncated = 0;

  // per-doc: first-occurrence order unique list with counts
  std::vector<int64_t> uniq_terms;
  std::vector<float> uniq_tf;
  std::vector<int64_t> term_slot;  // term index -> position in uniq (or -1)

  for (int64_t d = 0; d < n_docs; ++d) {
    const char* text = blob + offsets[d];
    const int64_t len = offsets[d + 1] - offsets[d];

    // tokenize into scratch, reusing rrt_tokenize's scanner
    scratch.resize(static_cast<size_t>(len) + 2);
    int64_t n_toks = rrt_tokenize(text, len, scratch.data(),
                                  static_cast<int64_t>(scratch.size()),
                                  max_tokens_per_doc);
    doc_len[d] = static_cast<float>(n_toks);

    uniq_terms.clear();
    uniq_tf.clear();
    const char* p = scratch.data();
    for (int64_t t = 0; t < n_toks; ++t) {
      const char* e = p;
      while (*e != '\n') ++e;
      int64_t ti = vocab.get_or_add(p, e - p);
      p = e + 1;
      if (ti >= static_cast<int64_t>(term_slot.size())) {
        term_slot.resize(static_cast<size_t>(ti) + 1, -1);
        df.resize(static_cast<size_t>(ti) + 1, 0.f);
        last_doc.resize(static_cast<size_t>(ti) + 1, -1);
      }
      if (term_slot[ti] < 0 || last_doc[ti] != d) {
        // first occurrence in this doc
        if (last_doc[ti] != d) {
          term_slot[ti] = static_cast<int64_t>(uniq_terms.size());
          uniq_terms.push_back(ti);
          uniq_tf.push_back(1.f);
          df[ti] += 1.f;
          last_doc[ti] = d;
        }
      } else {
        uniq_tf[static_cast<size_t>(term_slot[ti])] += 1.f;
      }
    }

    // stable sort by tf desc (matches np.argsort(-tf, kind="stable"))
    const int64_t u = static_cast<int64_t>(uniq_terms.size());
    std::vector<int64_t> order(static_cast<size_t>(u));
    for (int64_t j = 0; j < u; ++j) order[static_cast<size_t>(j)] = j;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return uniq_tf[static_cast<size_t>(a)] > uniq_tf[static_cast<size_t>(b)];
    });
    int64_t keep = u;
    if (keep > doc_terms_cap) {
      keep = doc_terms_cap;
      ++truncated;
    }
    int32_t* row_t = doc_terms + d * doc_terms_cap;
    float* row_f = doc_tf + d * doc_terms_cap;
    for (int64_t j = 0; j < keep; ++j) {
      int64_t o = order[static_cast<size_t>(j)];
      row_t[j] = static_cast<int32_t>(uniq_terms[static_cast<size_t>(o)] + 1);
      row_f[j] = uniq_tf[static_cast<size_t>(o)];
    }
    for (int64_t j = keep; j < doc_terms_cap; ++j) {
      row_t[j] = 0;
      row_f[j] = 0.f;
    }
  }

  const int64_t v = static_cast<int64_t>(vocab.terms.size());
  if (v > vocab_cap) return -1;
  df_out[0] = 0;
  for (int64_t t = 0; t < v; ++t)
    df_out[t + 1] = static_cast<int32_t>(df[static_cast<size_t>(t)]);

  int64_t pos = 0;
  for (int64_t t = 0; t < v; ++t) {
    const std::string& s = vocab.terms[static_cast<size_t>(t)];
    if (pos + static_cast<int64_t>(s.size()) + 1 > vocab_out_cap) return -1;
    std::memcpy(vocab_out + pos, s.data(), s.size());
    pos += static_cast<int64_t>(s.size());
    vocab_out[pos++] = '\n';
  }
  if (pos < vocab_out_cap) vocab_out[pos] = '\0';
  if (n_truncated) *n_truncated = truncated;
  return v;
}

}  // extern "C"
