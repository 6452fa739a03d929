"""Index bundle schema: numpy dataclasses and their device placement.

Copies the dataclasses of `review_recommender_tpu/index/schema.py`
(`ProductIndex`, `ReviewIndex`, `IndexBundle`, same fields) without the
module-level `jax.numpy` import; placement returns torch tensors on an
explicit device. Array inventory (N_pad rows, L = terms cap, G = gate
phrases): emb (N_pad, D), n_reviews/avg_stars/doc_len (N_pad,) f32 (stars
may be NaN), doc_terms (N_pad, L) i32 (0 = PAD), doc_tf (N_pad, L) f32,
gate_bits (N_pad, G) bool, valid (N_pad,) bool, optional doc_bm25
(N_pad, L) f32 eager BM25 contributions, optional doc_tokens (N_pad, S_d)
i32 and doc_token_len (N_pad,) i32 (the rerank lane's pre-tokenized
documents, index/build.py:attach_rerank_tokens). Reviews (M_pad rows):
rev_emb (M_pad, D), rev_product (M_pad,) i32 (the product row; n_docs =
the discard bucket), rev_valid (M_pad,) bool. An int8 engine places
emb_q (N_pad, D) int8 and emb_scale (N_pad,) f32 in place of emb.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from review_recommender_tpu_torch.utils.text import GATE_PHRASES

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1
PAD_TERM_ID = 0


def pad_rows(n: int, multiple: int) -> int:
    """Round n up to a multiple (>= multiple so tiny corpora still tile)."""
    m = max(int(multiple), 1)
    return max(((n + m - 1) // m) * m, m)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass
class ProductIndex:
    """Corpus arrays (numpy on the host) + host metadata."""

    emb: np.ndarray
    n_reviews: np.ndarray
    avg_stars: np.ndarray
    doc_terms: np.ndarray
    doc_tf: np.ndarray
    doc_len: np.ndarray
    gate_bits: np.ndarray
    valid: np.ndarray
    skus: List[str]
    agg_texts: Sequence[str]
    vocab: Dict[str, int]
    idf: np.ndarray  # (V+1,) f32, idf[0] = 0 for PAD
    df: np.ndarray  # (V+1,) i32
    avgdl: float
    n_docs: int
    doc_tokens: Optional[np.ndarray] = None
    doc_token_len: Optional[np.ndarray] = None
    doc_bm25: Optional[np.ndarray] = None
    last_ts: Optional[List[str]] = None

    @property
    def n_padded(self) -> int:
        return int(self.emb.shape[0])

    @property
    def dim(self) -> int:
        return int(self.emb.shape[1])

    @property
    def terms_cap(self) -> int:
        return int(self.doc_terms.shape[1])

    def device_arrays(self, device: torch.device, emb_dtype: torch.dtype = torch.bfloat16,
                      quantize_int8: bool = False) -> dict:
        """The tensors the query path reads. With `doc_bm25` present the
        eager contributions replace doc_tf/doc_len; quantize_int8 places
        the per-row int8 corpus ("emb_q" int8 + "emb_scale" f32,
        ops/dense.py:quantize_corpus_int8) in place of "emb"."""
        put = lambda a, dt: torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)
        if quantize_int8:
            from review_recommender_tpu_torch.ops.dense import quantize_corpus_int8

            q, scale = quantize_corpus_int8(self.emb)
            emb_entries = {"emb_q": put(q, torch.int8), "emb_scale": put(scale, torch.float32)}
        else:
            emb_entries = {"emb": put(self.emb, emb_dtype)}
        out = {
            **emb_entries,
            "n_reviews": put(self.n_reviews, torch.float32),
            "avg_stars": put(self.avg_stars, torch.float32),
            "doc_terms": put(self.doc_terms, torch.int32),
            "gate_bits": put(self.gate_bits, torch.bool),
            "valid": put(self.valid, torch.bool),
        }
        if self.doc_bm25 is not None:
            out["doc_bm25"] = put(self.doc_bm25, torch.float32)
        else:
            out["doc_tf"] = put(self.doc_tf, torch.float32)
            out["doc_len"] = put(self.doc_len, torch.float32)
        if self.doc_tokens is not None:
            out["doc_tokens"] = put(self.doc_tokens, torch.int32)
            out["doc_token_len"] = put(self.doc_token_len, torch.int32)
        return out

    def device_footprint(self, emb_dtype: torch.dtype = torch.bfloat16,
                         quantize_int8: bool = False) -> Dict[str, int]:
        """Bytes each tensor of device_arrays occupies, from host shapes."""
        n_pad = self.n_padded
        out: Dict[str, int] = {}
        if quantize_int8:
            out["emb_q"] = n_pad * self.dim
            out["emb_scale"] = n_pad * 4
        else:
            out["emb"] = n_pad * self.dim * _itemsize(emb_dtype)
        out["n_reviews"] = n_pad * 4
        out["avg_stars"] = n_pad * 4
        out["doc_terms"] = n_pad * self.terms_cap * 4
        out["gate_bits"] = n_pad * len(GATE_PHRASES)
        out["valid"] = n_pad
        if self.doc_bm25 is not None:
            out["doc_bm25"] = n_pad * self.terms_cap * 4
        else:
            out["doc_tf"] = n_pad * self.terms_cap * 4
            out["doc_len"] = n_pad * 4
        if self.doc_tokens is not None:
            out["doc_tokens"] = n_pad * self.doc_tokens.shape[1] * 4
            out["doc_token_len"] = n_pad * 4
        return out

    def validate(self) -> None:
        n_pad = self.n_padded
        checks = [
            (self.n_docs <= n_pad, "n_docs exceeds the padded rows"),
            (self.doc_terms.shape == self.doc_tf.shape, "doc_terms/doc_tf shapes differ"),
            (self.doc_terms.shape[0] == n_pad, "doc_terms rows != n_padded"),
            (self.gate_bits.shape == (n_pad, len(GATE_PHRASES)), "gate_bits shape"),
            (len(self.skus) == self.n_docs, "len(skus) != n_docs"),
            (len(self.agg_texts) == self.n_docs, "len(agg_texts) != n_docs"),
            (self.idf.shape[0] == len(self.vocab) + 1, "idf length != vocab + 1"),
            (int(self.valid.sum()) == self.n_docs, "valid rows != n_docs"),
        ]
        for name in ("n_reviews", "avg_stars", "doc_len", "valid"):
            checks.append((getattr(self, name).shape == (n_pad,), f"{name} shape"))
        if (self.doc_tokens is None) != (self.doc_token_len is None):
            checks.append((False, "doc_tokens and doc_token_len come together"))
        elif self.doc_tokens is not None:
            checks.append((self.doc_tokens.ndim == 2 and self.doc_tokens.shape[0] == n_pad,
                           "doc_tokens shape"))
            checks.append((self.doc_token_len.shape == (n_pad,), "doc_token_len shape"))
            checks.append((bool((self.doc_token_len >= 0).all())
                           and int(self.doc_token_len.max(initial=0)) <= self.doc_tokens.shape[1],
                           "doc_token_len outside 0..doc_tokens width"))
        for ok, msg in checks:
            if not ok:
                raise ValueError(f"invalid ProductIndex: {msg}")


@dataclasses.dataclass
class ReviewIndex:
    """Per-review embeddings and host metadata for the snippet lane: the
    device scores every review against the query and keeps each product's
    best (ops/segment.py); the host recovers the text shown for it from
    rev_texts/rev_stars (engine/snippets.py). rev_emb stays on the host in
    f32 for that recovery; device_arrays places its device copy."""

    rev_emb: np.ndarray  # (M_pad, D) f32, unit rows
    rev_product: np.ndarray  # (M_pad,) i32 product row, n_docs = discard bucket
    rev_valid: np.ndarray  # (M_pad,) bool
    rev_texts: Sequence[str]
    rev_stars: np.ndarray  # (M,) f32, NaN allowed
    n_reviews_total: int

    @property
    def m_padded(self) -> int:
        return int(self.rev_emb.shape[0])

    def device_arrays(self, device: torch.device,
                      emb_dtype: torch.dtype = torch.bfloat16) -> dict:
        """The tensors the snippet lane reads, on `device`."""
        put = lambda a, dt: torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)
        return {
            "rev_emb": put(self.rev_emb, emb_dtype),
            "rev_product": put(self.rev_product, torch.int32),
            "rev_valid": put(self.rev_valid, torch.bool),
        }

    def device_footprint(self, emb_dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
        m_pad = self.m_padded
        dim = int(self.rev_emb.shape[1])
        return {
            "rev_emb": m_pad * dim * _itemsize(emb_dtype),
            "rev_product": m_pad * 4,
            "rev_valid": m_pad,
        }


@dataclasses.dataclass
class IndexBundle:
    """The product index and an optional review index."""

    products: ProductIndex
    reviews: Optional[ReviewIndex] = None
    version: int = SCHEMA_VERSION
    meta: dict = dataclasses.field(default_factory=dict)

    def device_footprint(self, emb_dtype: torch.dtype = torch.bfloat16,
                         quantize_int8: bool = False) -> Dict[str, int]:
        out = self.products.device_footprint(emb_dtype, quantize_int8)
        if self.reviews is not None:
            out.update(self.reviews.device_footprint(emb_dtype))
        return out


def footprint_total(bundle: IndexBundle, emb_dtype: torch.dtype = torch.bfloat16,
                    quantize_int8: bool = False, striped: bool = False, ivf: bool = False,
                    ivf_centroids: int = 0,
                    ivf_block_rows: int = 0) -> tuple[Dict[str, int], int]:
    """(per-array bytes, total bytes). The striped pool keeps the flat
    corpus and its (s, G, D) slices, so it adds one more corpus (int8 rows
    and scales for an int8 engine). The IVF pool adds its block tensor and
    bookkeeping, "ivf_bound": their true worst case at the centroid and
    block sizes the build will choose (ops/ivf.py:ivf_footprint_bound;
    the JAX package's flat 1.25x of the corpus can be exceeded)."""
    fp = bundle.device_footprint(emb_dtype, quantize_int8)
    total = sum(fp.values())
    if striped:
        total += fp.get("emb", fp.get("emb_q", 0) + fp.get("emb_scale", 0))
    if ivf:
        from review_recommender_tpu_torch.ops.ivf import ivf_footprint_bound

        fp["ivf_bound"] = ivf_footprint_bound(
            bundle.products.n_docs, bundle.products.dim, _itemsize(emb_dtype),
            ivf_centroids, ivf_block_rows)
        total += fp["ivf_bound"]
    return fp, total


def device_memory_limit(device: torch.device) -> Optional[int]:
    """Total memory of a CUDA device in bytes; None for the CPU."""
    if device.type != "cuda":
        return None
    _free, total = torch.cuda.mem_get_info(device)
    return int(total)


def _device_loads(total_bytes: int, device) -> Dict[torch.device, int]:
    """Bytes each device holds: `device` is one device, or the shard devices
    of a sharded engine (repeats allowed). A shard holds 1/n of the
    row-sharded bytes and a device the sum of its shards, so four shards on
    one card are held to the whole footprint."""
    devices = [device] if isinstance(device, (str, torch.device)) else list(device)
    counts = collections.Counter(torch.device(d) for d in devices)
    return {dev: int(total_bytes) * c // len(devices) for dev, c in counts.items()}


def check_hbm_fit(total_bytes: int, device, warn_frac: float = 0.8,
                  limit_bytes: Optional[int] = None) -> Dict:
    """Fit report of a footprint against device memory: {total_bytes,
    per_device_bytes, limit_bytes, frac, fits, warn, n_shards}, read at the
    most loaded device (_device_loads); callers decide. `device` is a
    device or a list of shard devices (JAX: total / n_shards per device)."""
    loads = _device_loads(total_bytes, device)
    rows = []
    for dev, load in loads.items():
        limit = device_memory_limit(dev) if limit_bytes is None else int(limit_bytes)
        rows.append((load / limit if limit else None, load, limit))
    frac, per_dev, limit = max(rows, key=lambda r: (r[0] or 0.0, r[1]))
    return {
        "total_bytes": int(total_bytes),
        "per_device_bytes": per_dev,
        "limit_bytes": limit,
        "frac": frac,
        "fits": frac is None or frac <= 1.0,
        "warn": frac is not None and frac > warn_frac,
        "n_shards": 1 if isinstance(device, (str, torch.device)) else len(list(device)),
    }


def enforce_hbm_fit(bundle: IndexBundle, device,
                    emb_dtype: torch.dtype = torch.bfloat16, quantize_int8: bool = False,
                    striped: bool = False, ivf: bool = False, ivf_centroids: int = 0,
                    ivf_block_rows: int = 0) -> Dict:
    """Refuse (RuntimeError) to place a bundle that cannot fit the device,
    or the most loaded of a sharded engine's shard devices (check_hbm_fit);
    warn above 80%. RRT_IGNORE_HBM_CHECK=true downgrades the refusal to a
    warning, as in the JAX package."""
    fp, total = footprint_total(bundle, emb_dtype, quantize_int8, striped, ivf,
                                ivf_centroids, ivf_block_rows)
    rep = check_hbm_fit(total, device)
    gib = rep["per_device_bytes"] / 2**30
    if not rep["fits"]:
        msg = (f"index bundle needs {gib:.2f} GiB on a device that has "
               f"{rep['limit_bytes'] / 2**30:.2f} GiB (largest arrays: "
               f"{sorted(fp, key=fp.get, reverse=True)[:3]})")
        if os.getenv("RRT_IGNORE_HBM_CHECK", "").lower() == "true":
            logger.warning("%s (RRT_IGNORE_HBM_CHECK=true: continuing)", msg)
        else:
            raise RuntimeError(msg)
    elif rep["warn"]:
        logger.warning("index bundle uses %.2f GiB (%.0f%% of device memory)",
                       gib, 100 * rep["frac"])
    return rep
