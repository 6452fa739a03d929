"""Host-side query featurization: strings -> fixed-shape integer features.

A jax-free copy of `review_recommender_tpu/engine/featurize.py:35-221`
(`QueryFeatures`, `packed_len`, `QueryFeaturizer` with `featurize_packed`
and `featurize_packed_batch`). Two routes, chosen by the caller:

  native (default)  the port's C++ featurizer (native/featurizer.cc, its
                    own copy of the JAX package's source): one FFI crossing
                    per query or per batch, and the trigram-index probe for
                    the gate's vocabulary expansion
  python            `featurize` + `QueryFeatures.pack`, the plain version

As in the JAX package, the native route hands a non-ASCII query, or any
query while ENABLE_BM25 is off, to the Python code (the handle bakes idf
in, and a byte scanner cannot see what Unicode lowercasing makes). The
library builds or the constructor raises: nothing falls back to the
Python route. `unpack_features` is the torch counterpart of the
device-side inverse of `QueryFeatures.pack`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Set

import numpy as np
import torch

from review_recommender_tpu_torch.config import config
from review_recommender_tpu_torch.index.schema import ProductIndex
from review_recommender_tpu_torch.utils.text import (
    GATE_PHRASE_ID,
    GATE_PHRASES,
    build_gate_groups,
    tokenize_query,
)

GROUPS_CAP = 6


@dataclasses.dataclass
class QueryFeatures:
    q_terms: np.ndarray  # (Q,) int32, 0 pad
    q_idf: np.ndarray  # (Q,) f32
    group_phrase_mask: np.ndarray  # (6, G_phrases) bool
    group_term_ids: np.ndarray  # (6, T_cap) int32, -1 pad
    group_valid: np.ndarray  # (6,) bool
    tokens: List[str]
    groups: List[Set[str]]

    def pack(self) -> np.ndarray:
        """All features in one f32 vector (one host->device copy). Term ids
        are exact in f32 below 2^24."""
        return np.concatenate([
            self.q_terms.astype(np.float32),
            self.q_idf,
            self.group_phrase_mask.astype(np.float32).ravel(),
            self.group_term_ids.astype(np.float32).ravel(),
            self.group_valid.astype(np.float32),
        ])


def packed_len(query_terms_cap: int, gate_terms_cap: int) -> int:
    g = len(GATE_PHRASES)
    return (2 * query_terms_cap + GROUPS_CAP * g
            + GROUPS_CAP * gate_terms_cap + GROUPS_CAP)


def unpack_features(packed: torch.Tensor, query_terms_cap: int, gate_terms_cap: int):
    """Inverse of QueryFeatures.pack on a (..., packed_len) f32 tensor; leading
    axes are a batch of queries. Returns (q_terms i32, q_idf f32, gp_mask
    bool, gt_ids i32, g_valid bool), each with the same leading axes."""
    q = query_terms_cap
    g = len(GATE_PHRASES)
    t = gate_terms_cap
    lead = packed.shape[:-1]
    off = 0
    q_terms = packed[..., off : off + q].to(torch.int32); off += q
    q_idf = packed[..., off : off + q]; off += q
    gp = packed[..., off : off + GROUPS_CAP * g].reshape(*lead, GROUPS_CAP, g) > 0
    off += GROUPS_CAP * g
    gt = packed[..., off : off + GROUPS_CAP * t].reshape(*lead, GROUPS_CAP, t).to(torch.int32)
    off += GROUPS_CAP * t
    gv = packed[..., off : off + GROUPS_CAP] > 0
    return q_terms, q_idf, gp, gt, gv


class QueryFeaturizer:
    def __init__(self, index: ProductIndex, query_terms_cap: int = 32,
                 gate_terms_cap: int = 64, native: bool = True):
        self.index = index
        self.query_terms_cap = query_terms_cap
        self.gate_terms_cap = gate_terms_cap
        # per-instance expansion cache (an lru_cache on the method would pin
        # the index alive in a process-global table)
        self._expand_cache: dict = {}
        self._expand_cache_cap = 65536
        terms = sorted(index.vocab.items(), key=lambda kv: kv[1])
        self._vocab_terms = np.array([t for t, _ in terms], dtype=np.str_)
        self._vocab_ids = np.array([i for _, i in terms], dtype=np.int32)
        self._native = None
        self._vocab_blob = None
        if native:
            from review_recommender_tpu_torch.native import NativeQueryFeaturizer

            # the blob's line i is term id i + 1: the ids must be 1..V
            if not np.array_equal(self._vocab_ids, np.arange(1, len(terms) + 1)):
                raise ValueError("the native featurizer needs vocabulary ids 1..V in order")
            self._vocab_blob = ("\n".join(t for t, _ in terms) + "\n").encode()
            nat = NativeQueryFeaturizer(self._vocab_blob, index.df, index.idf,
                                        query_terms_cap, gate_terms_cap)
            want = packed_len(query_terms_cap, gate_terms_cap)
            if nat.packed_len != want:
                raise RuntimeError(f"native featurizer packs {nat.packed_len} floats a query, "
                                   f"the Python route {want}")
            self._native = nat

    @property
    def route(self) -> str:
        """"native" or "python": which featurizer this instance runs."""
        return "python" if self._native is None else "native"

    def _expand_token(self, token: str) -> np.ndarray:
        """Vocabulary ids whose term contains `token`, most frequent (by
        document frequency) first when more than gate_terms_cap match."""
        hit = self._expand_cache.get(token)
        if hit is not None:
            return hit
        if len(self._vocab_terms) == 0:
            return np.zeros(0, np.int32)
        if self._native is not None and token.isascii():
            ids = self._native.expand_token(token)  # trigram probe, already df-capped
        else:
            if self._native is not None:
                from review_recommender_tpu_torch.native import substring_scan_native

                ids = substring_scan_native(self._vocab_blob, token)
            else:
                ids = self._vocab_ids[np.char.find(self._vocab_terms, token) >= 0]
            if len(ids) > self.gate_terms_cap:
                dfs = self.index.df[ids]
                order = np.argsort(-dfs, kind="stable")[: self.gate_terms_cap]
                ids = ids[order]
            ids = ids.astype(np.int32)
        if len(self._expand_cache) >= self._expand_cache_cap:
            self._expand_cache.clear()
        self._expand_cache[token] = ids
        return ids

    def featurize_packed(self, query: str) -> np.ndarray:
        """Query string -> the packed (packed_len,) f32 feature buffer."""
        if self._native is not None and query.isascii() and config.ENABLE_BM25:
            return self._native.featurize_packed(query)
        return self.featurize(query).pack()

    def featurize_packed_batch(self, queries) -> np.ndarray:
        """Batch of queries -> (B, packed_len) f32, one FFI crossing on the
        native route."""
        if (self._native is not None and config.ENABLE_BM25
                and all(q.isascii() for q in queries)):
            return self._native.featurize_packed_batch(queries)
        return np.stack([self.featurize_packed(q) for q in queries])

    def featurize(self, query: str) -> QueryFeatures:
        tokens = tokenize_query(query)

        # BM25 term ids, duplicates kept; ENABLE_BM25=false zero-fills them
        Q = self.query_terms_cap
        q_terms = np.zeros(Q, dtype=np.int32)
        q_idf = np.zeros(Q, dtype=np.float32)
        if config.ENABLE_BM25:
            for i, tok in enumerate(tokens[:Q]):
                tid = self.index.vocab.get(tok, 0)
                q_terms[i] = tid
                q_idf[i] = self.index.idf[tid] if tid else 0.0

        groups = build_gate_groups(query)
        G = len(GATE_PHRASES)
        phrase_mask = np.zeros((GROUPS_CAP, G), dtype=bool)
        term_ids = np.full((GROUPS_CAP, self.gate_terms_cap), -1, dtype=np.int32)
        valid = np.zeros(GROUPS_CAP, dtype=bool)
        for gi, group in enumerate(groups[:GROUPS_CAP]):
            valid[gi] = True
            dyn: List[np.ndarray] = []
            for member in group:
                pid = GATE_PHRASE_ID.get(member)
                if pid is not None:
                    phrase_mask[gi, pid] = True
                else:
                    dyn.append(self._expand_token(member))
            if dyn:
                ids = np.concatenate(dyn)[: self.gate_terms_cap]
                term_ids[gi, : len(ids)] = ids

        return QueryFeatures(
            q_terms=q_terms,
            q_idf=q_idf,
            group_phrase_mask=phrase_mask,
            group_term_ids=term_ids,
            group_valid=valid,
            tokens=tokens,
            groups=groups,
        )
