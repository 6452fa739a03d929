"""Serving wrappers: text -> tower forward with bucketed shapes.

Counterpart of `review_recommender_tpu/models/encoder.py:56-215`: the same
sequence and batch buckets, the same stable length sort into chunks, and
the same padding, so both packages feed their towers identical (batch, seq)
blocks. Forwards run under `torch.inference_mode()`; outputs are f32 numpy.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from review_recommender_tpu_torch.device import resolve_device
from review_recommender_tpu_torch.models.bert import (
    BertConfig,
    BiEncoderModel,
    CrossEncoderModel,
    init_state_dict,
)
from review_recommender_tpu_torch.models.tokenizer import (
    HashTokenizer,
    encode_seqs,
    pack_seqs,
    pad_bucket,
)

SEQ_BUCKETS = (16, 32, 64, 128, 256, 512)
BATCH_BUCKETS = (1, 8, 16, 32, 64, 128, 256)


def _batch_bucket(n: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return ((n + BATCH_BUCKETS[-1] - 1) // BATCH_BUCKETS[-1]) * BATCH_BUCKETS[-1]


def _bucketed_chunks(seqs, batch_size: int):
    """(original indices, items) chunks with items length-sorted (stable), so
    each chunk packs to the smallest viable sequence bucket."""
    order = sorted(range(len(seqs)), key=lambda i: len(seqs[i][0]))
    for lo in range(0, len(order), batch_size):
        sel = order[lo : lo + batch_size]
        yield sel, [seqs[i] for i in sel]


def build_model(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
                device: torch.device) -> torch.nn.Module:
    """Allocate `model`'s parameters on `device` (no default init) and copy
    `state_dict` in; copy_ casts each tensor to its parameter's dtype."""
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


class _Tower:
    """Shared bucketing and forward of the two wrappers."""

    model: torch.nn.Module

    def __init__(self, cfg: BertConfig, tokenizer, device, max_len: int):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        # positions past the table would index out of range
        self.max_len = min(max_len, cfg.max_position)

    def set_attn_impl(self, impl: str) -> None:
        self.model.encoder.set_attn_impl(impl)

    def _run(self, seqs, batch_size: int, n_out: int, width: Optional[int]) -> np.ndarray:
        out = np.zeros((n_out, width) if width else n_out, np.float32)
        for sel, chunk in _bucketed_chunks(seqs, batch_size):
            ids, mask, tt = pack_seqs(self.tokenizer, chunk)
            seq = min(pad_bucket(ids.shape[1], SEQ_BUCKETS), self.max_len)
            bsz = _batch_bucket(len(chunk))
            blocks = [np.zeros((bsz, seq), np.int32) for _ in range(3)]
            w = min(ids.shape[1], seq)
            for dst, src in zip(blocks, (ids, mask, tt)):
                dst[: len(chunk), :w] = src[:, :w]
            ids_t, mask_t, tt_t = (torch.from_numpy(a).to(self.device) for a in blocks)
            with torch.inference_mode():
                res = self.model(ids_t, mask_t, tt_t)
            out[sel] = res[: len(chunk)].to(torch.float32).cpu().numpy()
        return out


class BiEncoder(_Tower):
    """Query/document embedding tower (bge-small semantics: CLS + L2-norm)."""

    def __init__(self, cfg: BertConfig, state_dict, tokenizer, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16, pooling: str = "cls",
                 max_len: int = 512, attn_impl: str = "auto"):
        super().__init__(cfg, tokenizer, device, max_len)
        with torch.device("meta"):
            model = BiEncoderModel(cfg, dtype=dtype, pooling=pooling, attn_impl=attn_impl)
        self.model = build_model(model, state_dict, self.device)

    @classmethod
    def random_init(cls, cfg: Optional[BertConfig] = None, tokenizer=None,
                    seed: int = 0, device="cuda", **kw):
        """Randomly initialised tower (tests, synthetic runs)."""
        device = resolve_device(device)  # before the weights are drawn
        cfg = cfg or BertConfig.bge_small()
        sd = init_state_dict(cfg, "biencoder", seed)
        return cls(cfg, sd, tokenizer or HashTokenizer(cfg.vocab_size), device=device, **kw)

    @classmethod
    def random_for_dim(cls, dim: int, seed: int = 0, **kw):
        """Random tower whose output dim matches an index: the full bge-small
        geometry at 384, else a proportional 4-layer tower."""
        if dim == 384:
            return cls.random_init(BertConfig.bge_small(), seed=seed, **kw)
        heads = max(1, dim // 32)
        while dim % heads:
            heads -= 1
        cfg = BertConfig(
            vocab_size=30522, hidden_size=dim, num_layers=4, num_heads=heads,
            intermediate_size=4 * dim, max_position=512,
        )
        return cls.random_init(cfg, seed=seed, **kw)

    def encode(self, texts: Sequence[str], batch_size: int = 256) -> np.ndarray:
        """Texts -> (N, H) f32 L2-normalised embeddings."""
        if not len(texts):
            return np.zeros((0, self.cfg.hidden_size), np.float32)
        seqs = encode_seqs(self.tokenizer, list(texts), max_len=self.max_len)
        return self._run(seqs, batch_size, len(texts), self.cfg.hidden_size)

    def __call__(self, text: str) -> np.ndarray:
        """Single-query hook for SearchEngine(query_encoder=...)."""
        return self.encode([text])[0]


class CrossEncoder(_Tower):
    """(query, doc) relevance scorer (ms-marco MiniLM head)."""

    def __init__(self, cfg: BertConfig, state_dict, tokenizer, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16, max_len: int = 512,
                 batch_size: int = 64, attn_impl: str = "auto"):
        super().__init__(cfg, tokenizer, device, max_len)
        self.batch_size = batch_size
        with torch.device("meta"):
            model = CrossEncoderModel(cfg, dtype=dtype, attn_impl=attn_impl)
        self.model = build_model(model, state_dict, self.device)

    @classmethod
    def random_init(cls, cfg: Optional[BertConfig] = None, tokenizer=None,
                    seed: int = 0, device="cuda", **kw):
        device = resolve_device(device)  # before the weights are drawn
        cfg = cfg or BertConfig.minilm_l6_cross()
        sd = init_state_dict(cfg, "crossencoder", seed)
        return cls(cfg, sd, tokenizer or HashTokenizer(cfg.vocab_size), device=device, **kw)

    def score_pairs(self, queries: Sequence[str], docs: Sequence[str]) -> np.ndarray:
        """(query, doc) pairs -> (N,) f32 logits."""
        if len(queries) != len(docs):
            raise ValueError(f"{len(queries)} queries vs {len(docs)} docs")
        if not len(docs):
            return np.zeros(0, np.float32)
        seqs = encode_seqs(self.tokenizer, list(queries), pairs=list(docs),
                           max_len=self.max_len)
        return self._run(seqs, self.batch_size, len(docs), None)

    def __call__(self, query: str, texts: Sequence[str]) -> np.ndarray:
        """Hook for SearchEngine(cross_encoder=...): one query, many docs
        (texts arrive cut to 2000 characters by the engine)."""
        return self.score_pairs([query] * len(texts), texts)
