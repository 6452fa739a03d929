// Native query featurizer: the full host hot path of a query — tokenize,
// vocab/idf lookup, gate-group construction, dynamic-token vocab expansion,
// and packing into the single f32 feature buffer the device consumes —
// in ONE FFI crossing per query (or one per batch).
//
// Semantics are bit-identical to engine/featurize.py:QueryFeaturizer.featurize
// + QueryFeatures.pack (which in turn reproduce the reference's
// utils.py:57-86 tokenize_query/build_gate_groups):
//   - tokenize_query: [a-z0-9]+(?:'[a-z0-9]+)? runs over the lowercased
//     query, minus the 16-word query stoplist (all lengths kept).
//   - gate groups: color groups whose any-member substring-matches the
//     lowercased query (in table order), then per-token synonym groups or
//     >=4-char singletons; dedup by set equality; capped at 6.
//   - dynamic tokens expand to vocab term ids containing the token as a
//     substring, stable-sorted by document frequency descending when over
//     the cap (matching np.argsort(-df, kind="stable")), cached per handle.
//   - packed layout: q_terms(Q) | q_idf(Q) | phrase_mask(6*G) |
//     group_term_ids(6*T, -1 pad) | group_valid(6), all f32.
//
// The attribute tables (GATE_PHRASES / SYNONYMS / COLORS / stopwords) are
// passed in serialized at handle-creation time so Python's tables remain the
// single source of truth — no parity drift between languages.
//
// ASCII-only by contract; the Python wrapper routes non-ASCII queries to the
// Python fallback (same policy as the document tokenizer).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

inline unsigned char lower_ascii(unsigned char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<unsigned char>(c + 32) : c;
}

inline bool is_alnum_lower(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
}

std::vector<std::string> split(const char* blob, int64_t len, char sep) {
  std::vector<std::string> out;
  const char* p = blob;
  const char* end = blob + len;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, sep, static_cast<size_t>(end - p)));
    const char* e = nl ? nl : end;
    out.emplace_back(p, static_cast<size_t>(e - p));
    p = e + 1;
  }
  // trailing separator produces no empty tail entry (matches "\n".join)
  if (!out.empty() && out.back().empty()) out.pop_back();
  return out;
}

bool contains(const std::string& hay, const std::string& needle) {
  return hay.find(needle) != std::string::npos;
}

struct Group {
  std::vector<std::string> members;         // serialized order
  std::vector<std::string> sorted_members;  // canonical form for set-equality
  void canonicalize() {
    sorted_members = members;
    std::sort(sorted_members.begin(), sorted_members.end());
    sorted_members.erase(
        std::unique(sorted_members.begin(), sorted_members.end()),
        sorted_members.end());
  }
  bool operator==(const Group& o) const {
    return sorted_members == o.sorted_members;
  }
};

struct Featurizer {
  // vocab
  std::unordered_map<std::string, int32_t> vocab;  // term -> 1-based id
  std::string vocab_blob;                          // '\n'-joined, scan order
  std::vector<int32_t> df;                         // (V+1)
  std::vector<float> idf;                          // (V+1)
  // gate tables
  std::vector<std::string> phrases;                      // pid order
  std::unordered_map<std::string, int32_t> phrase_id;    // phrase -> pid
  std::vector<Group> color_groups;                       // table order
  std::unordered_map<std::string, int32_t> synonym_of;   // token -> index
  std::vector<Group> synonym_groups;
  std::unordered_set<std::string> stopwords;
  // caps
  int64_t q_cap = 32;
  int64_t t_cap = 64;
  static constexpr int64_t kGroupsCap = 6;
  // dynamic-expansion cache
  std::unordered_map<std::string, std::vector<int32_t>> expand_cache;
  // trigram inverted index over vocab terms: 3 packed bytes -> ascending
  // term-id posting list. Turns expand_token from an O(vocab blob) scan
  // (~0.25 ms at 30k terms) into a rarest-trigram candidate probe + verify
  // (~a few us) — the cold-featurize host bottleneck at high QPS.
  std::unordered_map<int32_t, std::vector<int32_t>> tri_index;
  std::vector<std::pair<uint32_t, uint32_t>> term_span;  // (off, len) per id-1

  static int32_t tri_key(const char* p) {
    return (static_cast<int32_t>(static_cast<unsigned char>(p[0])) << 16) |
           (static_cast<int32_t>(static_cast<unsigned char>(p[1])) << 8) |
           static_cast<int32_t>(static_cast<unsigned char>(p[2]));
  }

  void build_tri_index() {
    term_span.clear();
    const char* base = vocab_blob.data();
    const char* p = base;
    const char* end = base + vocab_blob.size();
    while (p < end) {
      const char* nl = static_cast<const char*>(
          std::memchr(p, '\n', static_cast<size_t>(end - p)));
      const char* te = nl ? nl : end;
      term_span.emplace_back(static_cast<uint32_t>(p - base),
                             static_cast<uint32_t>(te - p));
      p = te + 1;
    }
    std::vector<int32_t> seen;  // distinct trigram keys of current term
    for (size_t t = 0; t < term_span.size(); ++t) {
      const char* s = base + term_span[t].first;
      const int64_t len = term_span[t].second;
      seen.clear();
      for (int64_t i = 0; i + 3 <= len; ++i) {
        const int32_t k = tri_key(s + i);
        if (std::find(seen.begin(), seen.end(), k) == seen.end()) {
          seen.push_back(k);
          tri_index[k].push_back(static_cast<int32_t>(t) + 1);
        }
      }
    }
  }

  int64_t n_phrases() const { return static_cast<int64_t>(phrases.size()); }
  int64_t packed_len() const {
    return 2 * q_cap + kGroupsCap * n_phrases() + kGroupsCap * t_cap +
           kGroupsCap;
  }

  // tokenize_query semantics (utils/text.py:84-87): token runs over the
  // pre-lowercased query, minus query stopwords, all lengths kept, no cap.
  void tokenize_query(const std::string& q, std::vector<std::string>* out) {
    out->clear();
    const char* s = q.data();
    const int64_t len = static_cast<int64_t>(q.size());
    int64_t i = 0;
    std::string tok;
    while (i < len) {
      if (!is_alnum_lower(static_cast<unsigned char>(s[i]))) {
        ++i;
        continue;
      }
      tok.clear();
      while (i < len && is_alnum_lower(static_cast<unsigned char>(s[i])))
        tok.push_back(s[i++]);
      if (i + 1 < len && s[i] == '\'' &&
          is_alnum_lower(static_cast<unsigned char>(s[i + 1]))) {
        tok.push_back('\'');
        ++i;
        while (i < len && is_alnum_lower(static_cast<unsigned char>(s[i])))
          tok.push_back(s[i++]);
      }
      if (!stopwords.count(tok)) out->push_back(tok);
    }
  }

  // engine/featurize.py:_expand_token — vocab ids containing `token` as a
  // substring; stable df-desc order applied only when over the cap.
  static bool contains_n(const char* hay, int64_t hlen, const char* needle,
                         int64_t nlen) {
    if (hlen < nlen) return false;
    const char first = needle[0];
    const char* limit = hay + hlen - nlen;
    for (const char* q = hay; q <= limit; ++q) {
      if (*q == first &&
          std::memcmp(q, needle, static_cast<size_t>(nlen)) == 0)
        return true;
    }
    return false;
  }

  const std::vector<int32_t>& expand_token(const std::string& token) {
    auto it = expand_cache.find(token);
    if (it != expand_cache.end()) return it->second;
    std::vector<int32_t> ids;
    const int64_t nlen = static_cast<int64_t>(token.size());
    if (nlen >= 3 && !term_span.empty()) {
      // rarest-trigram probe: any term containing `token` contains every
      // trigram of `token`, so the shortest posting list bounds the
      // candidates; verify each by exact substring. Posting lists are
      // id-ascending, so ids comes out in the same (scan) order.
      const std::vector<int32_t>* best = nullptr;
      bool impossible = false;
      for (int64_t i = 0; i + 3 <= nlen; ++i) {
        auto ti = tri_index.find(tri_key(token.data() + i));
        if (ti == tri_index.end()) {
          impossible = true;
          break;
        }
        if (best == nullptr || ti->second.size() < best->size())
          best = &ti->second;
      }
      if (!impossible && best != nullptr) {
        const char* base = vocab_blob.data();
        for (int32_t id : *best) {
          const auto& span = term_span[static_cast<size_t>(id - 1)];
          if (contains_n(base + span.first, span.second, token.data(), nlen))
            ids.push_back(id);
        }
      }
    } else if (nlen > 0) {
      // tokens shorter than a trigram: linear scan (rare — dynamic gate
      // tokens are >= 4 chars; only unusual synonym members land here)
      const char* p = vocab_blob.data();
      const char* end = p + vocab_blob.size();
      int32_t term_id = 1;
      while (p < end) {
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* te = nl ? nl : end;
        if (contains_n(p, te - p, token.data(), nlen)) ids.push_back(term_id);
        ++term_id;
        p = te + 1;
      }
    }
    if (static_cast<int64_t>(ids.size()) > t_cap) {
      std::stable_sort(ids.begin(), ids.end(), [&](int32_t a, int32_t b) {
        return df[static_cast<size_t>(a)] > df[static_cast<size_t>(b)];
      });
      ids.resize(static_cast<size_t>(t_cap));
    }
    if (expand_cache.size() >= 65536) expand_cache.clear();
    return expand_cache.emplace(token, std::move(ids)).first->second;
  }

  // One query -> packed f32 features. Returns packed_len().
  int64_t featurize(const char* query, int64_t qlen, float* out) {
    // lowercase copy (ASCII by contract)
    std::string q(static_cast<size_t>(qlen), '\0');
    for (int64_t i = 0; i < qlen; ++i)
      q[static_cast<size_t>(i)] =
          static_cast<char>(lower_ascii(static_cast<unsigned char>(query[i])));

    std::vector<std::string> tokens;
    tokenize_query(q, &tokens);

    const int64_t G = n_phrases();
    const int64_t L = packed_len();
    std::memset(out, 0, static_cast<size_t>(L) * sizeof(float));
    float* q_terms = out;
    float* q_idf = out + q_cap;
    float* phrase_mask = out + 2 * q_cap;                 // (6, G)
    float* term_ids = phrase_mask + kGroupsCap * G;       // (6, T)
    float* valid = term_ids + kGroupsCap * t_cap;         // (6,)
    for (int64_t i = 0; i < kGroupsCap * t_cap; ++i) term_ids[i] = -1.0f;

    // --- BM25 term ids (duplicates preserved) ---
    const int64_t nq = std::min<int64_t>(q_cap,
                                         static_cast<int64_t>(tokens.size()));
    for (int64_t i = 0; i < nq; ++i) {
      auto it = vocab.find(tokens[static_cast<size_t>(i)]);
      if (it != vocab.end()) {
        q_terms[i] = static_cast<float>(it->second);
        q_idf[i] = idf[static_cast<size_t>(it->second)];
      }
    }

    // --- gate groups (utils.py:62-86 order: colors, then tokens) ---
    std::vector<const Group*> groups;
    std::vector<Group> singletons;  // stable storage for {token} groups
    singletons.reserve(tokens.size());
    for (const Group& cg : color_groups) {
      for (const std::string& w : cg.members) {
        if (contains(q, w)) {
          groups.push_back(&cg);
          break;
        }
      }
    }
    for (const std::string& tok : tokens) {
      auto it = synonym_of.find(tok);
      if (it != synonym_of.end()) {
        groups.push_back(&synonym_groups[static_cast<size_t>(it->second)]);
      } else if (tok.size() >= 4) {
        singletons.push_back(Group{{tok}, {tok}});
        groups.push_back(&singletons.back());
      }
    }
    // dedup by set equality, order-preserving, cap 6
    std::vector<const Group*> uniq;
    for (const Group* g : groups) {
      bool dup = false;
      for (const Group* u : uniq)
        if (*u == *g) {
          dup = true;
          break;
        }
      if (!dup) uniq.push_back(g);
    }
    if (static_cast<int64_t>(uniq.size()) > kGroupsCap)
      uniq.resize(static_cast<size_t>(kGroupsCap));

    for (size_t gi = 0; gi < uniq.size(); ++gi) {
      valid[gi] = 1.0f;
      int64_t n_dyn = 0;
      float* row = term_ids + static_cast<int64_t>(gi) * t_cap;
      for (const std::string& member : uniq[gi]->members) {
        auto pit = phrase_id.find(member);
        if (pit != phrase_id.end()) {
          phrase_mask[static_cast<int64_t>(gi) * G + pit->second] = 1.0f;
        } else {
          for (int32_t id : expand_token(member)) {
            if (n_dyn >= t_cap) break;
            row[n_dyn++] = static_cast<float>(id);
          }
        }
      }
    }
    return L;
  }
};

}  // namespace

extern "C" {

void* rrt_featurizer_create(
    const char* vocab_blob, int64_t vocab_len, const int32_t* df,
    const float* idf, int64_t v_plus_1, const char* phrases_blob,
    int64_t phrases_len, const char* colors_blob, int64_t colors_len,
    const char* synonyms_blob, int64_t synonyms_len,
    const char* stopwords_blob, int64_t stopwords_len, int64_t q_cap,
    int64_t t_cap) {
  auto* f = new Featurizer();
  f->q_cap = q_cap;
  f->t_cap = t_cap;
  f->vocab_blob.assign(vocab_blob, static_cast<size_t>(vocab_len));
  {
    auto terms = split(vocab_blob, vocab_len, '\n');
    f->vocab.reserve(terms.size() * 2);
    int32_t id = 1;
    for (auto& t : terms) f->vocab.emplace(std::move(t), id++);
  }
  f->build_tri_index();
  f->df.assign(df, df + v_plus_1);
  f->idf.assign(idf, idf + v_plus_1);
  f->phrases = split(phrases_blob, phrases_len, '\n');
  for (size_t i = 0; i < f->phrases.size(); ++i)
    f->phrase_id.emplace(f->phrases[i], static_cast<int32_t>(i));
  for (const std::string& line : split(colors_blob, colors_len, '\n')) {
    Group g;
    g.members = split(line.data(), static_cast<int64_t>(line.size()), '\t');
    g.canonicalize();
    f->color_groups.push_back(std::move(g));
  }
  for (const std::string& line : split(synonyms_blob, synonyms_len, '\n')) {
    auto parts = split(line.data(), static_cast<int64_t>(line.size()), '\t');
    if (parts.empty()) continue;
    Group g;
    g.members.assign(parts.begin() + 1, parts.end());
    g.canonicalize();
    f->synonym_of.emplace(parts[0],
                          static_cast<int32_t>(f->synonym_groups.size()));
    f->synonym_groups.push_back(std::move(g));
  }
  for (auto& s : split(stopwords_blob, stopwords_len, '\n'))
    f->stopwords.insert(std::move(s));
  return f;
}

void rrt_featurizer_destroy(void* h) { delete static_cast<Featurizer*>(h); }

int64_t rrt_featurizer_packed_len(void* h) {
  return static_cast<Featurizer*>(h)->packed_len();
}

// out must hold packed_len() floats. Returns packed_len.
int64_t rrt_featurize(void* h, const char* query, int64_t qlen, float* out) {
  return static_cast<Featurizer*>(h)->featurize(query, qlen, out);
}

// Dynamic-gate token expansion via the trigram index (Python featurize
// path reuses it instead of the linear blob scan). out must hold at least
// t_cap int32s; returns the id count (always <= t_cap).
int64_t rrt_featurizer_expand(void* h, const char* token, int64_t tlen,
                              int32_t* out, int64_t cap) {
  auto* f = static_cast<Featurizer*>(h);
  const std::vector<int32_t>& ids =
      f->expand_token(std::string(token, static_cast<size_t>(tlen)));
  const int64_t n = std::min<int64_t>(static_cast<int64_t>(ids.size()), cap);
  std::memcpy(out, ids.data(), static_cast<size_t>(n) * sizeof(int32_t));
  return n;
}

// Batch: queries concatenated, offsets has n+1 entries; out holds
// n * packed_len() floats (row-major). Returns n.
int64_t rrt_featurize_batch(void* h, const char* blob, const int64_t* offsets,
                            int64_t n, float* out) {
  auto* f = static_cast<Featurizer*>(h);
  const int64_t L = f->packed_len();
  for (int64_t i = 0; i < n; ++i)
    f->featurize(blob + offsets[i], offsets[i + 1] - offsets[i], out + i * L);
  return n;
}

}  // extern "C"
