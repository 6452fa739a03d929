"""Edge cases of the BM25 scan kernels' query-term lookup, shared by the
card tests (tests/test_torch_gpu.py: kernel against plain version) and the
CPU parity tests (tests/test_torch_bm25.py: plain version against the
Pallas kernels in interpret mode).

Each case is (N, L) postings and a (Q,) query as numpy arrays, with
integer tf (so every per-slot sum is exact and the scores are bit-equal):

  same_term      every query slot holds the same term
  q1             one query slot; N = 777 (not a multiple of 4)
  q64_distinct   64 distinct query terms (the kernels' largest Q)
  hash_collide   query ids that share a bucket of the kernels' 512-entry
                 table under its first hash multiplier, and ids that differ
                 by multiples of the table size
  term_max_tf255 term ids up to 2^24 - 1 and tf 255 on every lane (the
                 packed word's sign bit on every lane)
  all_lanes_hit  one document whose every lane holds a query term (terms
                 repeat within it, so its per-slot sums add several tf)
  n3_l1          N = 3, L = 1
  l0             L = 0: no lanes, every tf_q is 0
"""
import numpy as np

# csrc/bm25_full.cu: kTableBits and the first of kHashMult
TABLE_BITS = 9
FIRST_HASH_MULT = 0x9E3779B1

CASES = ["same_term", "q1", "q64_distinct", "hash_collide", "term_max_tf255",
         "all_lanes_hit", "n3_l1", "l0"]


def _bucket(ids):
    return ((np.asarray(ids, np.uint64) * FIRST_HASH_MULT) & 0xFFFFFFFF) >> (32 - TABLE_BITS)


def _colliding_ids(base: int, count: int, limit: int = 200_000) -> np.ndarray:
    """`count` ids below `limit` in the bucket of `base`, base first."""
    ids = np.arange(1, limit, dtype=np.int64)
    same = ids[_bucket(ids) == _bucket(base)]
    return np.concatenate([[base], same[same != base][:count - 1]]).astype(np.int32)


def bm25_edge_case(name: str, min_q: int = 0):
    """(terms (N, L) i32, tf (N, L) f32, doc_len (N,) f32, q_terms (Q,) i32,
    q_idf (Q,) f32, avgdl f32) for one of CASES. With min_q > Q the query
    is lengthened to min_q slots drawn from the postings' terms (repeats of
    earlier slots and PAD among them), past one kernel launch's 64."""
    rng = np.random.default_rng(CASES.index(name) + 17)
    n, l, q, vocab = {"same_term": (1000, 64, 32, 400), "q1": (777, 33, 1, 400),
                      "q64_distinct": (4096, 64, 64, 400), "hash_collide": (1000, 64, 32, 0),
                      "term_max_tf255": (513, 16, 8, 0), "all_lanes_hit": (777, 48, 12, 400),
                      "n3_l1": (3, 1, 8, 400), "l0": (100, 0, 4, 400)}[name]
    terms = rng.integers(1, max(vocab, 2), (n, l)).astype(np.int32)
    tf = rng.integers(1, 6, (n, l)).astype(np.float32)
    qt = rng.integers(1, max(vocab, 2), q).astype(np.int32)
    if name == "same_term":
        qt[:] = terms[0, 0]
    elif name == "q1":
        qt[0] = terms[0, 0]
    elif name == "q64_distinct":
        qt = rng.permutation(np.arange(1, vocab))[:q].astype(np.int32)
    elif name == "hash_collide":
        ids = np.concatenate([_colliding_ids(1234, q // 2),
                              5 + (1 << TABLE_BITS) * np.arange(q // 2)]).astype(np.int32)
        qt = ids[rng.permutation(q)]
        terms = rng.choice(np.concatenate([ids, ids + 1]), (n, l)).astype(np.int32)
    elif name == "term_max_tf255":
        top = (1 << 24) - 1
        terms = rng.integers(top - 40, top + 1, (n, l)).astype(np.int32)
        tf[:] = 255.0
        qt = np.array([top, top - 1, top - 7, top, 3, top - 20, top - 40, top - 2], np.int32)
    elif name == "n3_l1":
        qt[0] = terms[0, 0]
    if l > 4 and name != "term_max_tf255":  # PAD tails (term 0, tf 0); a PAD query slot
        terms[:, l - l // 4:] = 0
        tf[:, l - l // 4:] = 0
        if q > 2 and name in ("all_lanes_hit", "n3_l1"):
            qt[-1] = 0
    if name == "all_lanes_hit":
        terms[5] = qt[np.arange(l) % q]
        tf[5] = rng.integers(1, 6, l)
    if min_q > q:
        qt = np.concatenate([qt, rng.choice(terms.ravel() if l else qt, min_q - q)])
        qt = qt.astype(np.int32)
    qi = rng.uniform(0.5, 3, qt.shape[0]).astype(np.float32)
    qi[qt == 0] = 0.0
    dl = tf.sum(1).astype(np.float32)
    avgdl = np.float32(dl.mean()) if l else np.float32(1.0)
    return terms, tf, dl, qt, qi, avgdl


def pack(terms, tf, n_pad=None):
    """The packed (L, n_pad) words (tf << 24) | term, zero-padded columns;
    unlike pack_postings it takes L = 0."""
    n, l = terms.shape
    words = (tf.astype(np.int64) << 24 | terms).astype(np.uint32).view(np.int32)
    out = np.zeros((l, n_pad or n), np.int32)
    out[:, :n] = words.T
    return out
