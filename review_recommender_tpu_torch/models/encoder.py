"""Serving wrappers: text -> tower forward with bucketed shapes.

Counterpart of `review_recommender_tpu/models/encoder.py:56-215`: the same
sequence and batch buckets, the same stable length sort into chunks, and
the same padding, so both packages feed their towers identical (batch, seq)
blocks. Forwards run under `torch.inference_mode()`; outputs are f32 numpy.

`BiEncoder(devices=[...])` is the data-parallel encoder of offline encode
jobs, the counterpart of the JAX `BiEncoder(mesh=...)` (`:59-98`): the
weights are copied once to each distinct device, each batch bucket is
rounded up to a multiple of len(devices) (JAX `:139-141`) and cut into
equal slices, slice j runs on devices[j] (the attention kernel on CUDA),
and the results meet on the lead device, devices[0]. A device may
repeat (four slices on one card).
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from review_recommender_tpu_torch.device import resolve_device, resolve_devices
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


def _batch_bucket(n: int, multiple: int = 1) -> int:
    """The batch bucket of n rows, rounded up to a multiple of `multiple`
    (the data-parallel encoder's device count)."""
    for b in BATCH_BUCKETS:
        if n <= b:
            break
    else:
        b = ((n + BATCH_BUCKETS[-1] - 1) // BATCH_BUCKETS[-1]) * BATCH_BUCKETS[-1]
    return -(-b // multiple) * multiple


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

    def __init__(self, cfg: BertConfig, tokenizer, device, max_len: int, devices=None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.devices = ([resolve_device(device)] if devices is None
                        else resolve_devices(list(devices)))
        self.device = self.devices[0]
        # positions past the table would index out of range
        self.max_len = min(max_len, cfg.max_position)

    def _build(self, model: torch.nn.Module, state_dict) -> None:
        """One copy of the weights on each distinct device; self.model is
        the lead device's."""
        self.models = {}
        for dev in self.devices:
            if dev not in self.models:
                self.models[dev] = build_model(copy.deepcopy(model), state_dict, dev)
        self.model = self.models[self.device]

    def set_attn_impl(self, impl: str) -> None:
        for model in self.models.values():
            model.encoder.set_attn_impl(impl)

    def _run(self, seqs, batch_size: int, n_out: int, width: Optional[int]) -> np.ndarray:
        out = np.zeros((n_out, width) if width else n_out, np.float32)
        n_dev = len(self.devices)
        for sel, chunk in _bucketed_chunks(seqs, batch_size):
            ids, mask, tt = pack_seqs(self.tokenizer, chunk)
            seq = min(pad_bucket(ids.shape[1], SEQ_BUCKETS), self.max_len)
            bsz = _batch_bucket(len(chunk), n_dev)
            blocks = [np.zeros((bsz, seq), np.int32) for _ in range(3)]
            w = min(ids.shape[1], seq)
            for dst, src in zip(blocks, (ids, mask, tt)):
                dst[: len(chunk), :w] = src[:, :w]
            per, parts = bsz // n_dev, []
            with torch.inference_mode():
                for j, dev in enumerate(self.devices):
                    args = (torch.from_numpy(a[j * per:(j + 1) * per]).to(dev) for a in blocks)
                    parts.append(self.models[dev](*args))
                res = parts[0] if n_dev == 1 else torch.cat([t.to(self.device) for t in parts])
            out[sel] = res[: len(chunk)].to(torch.float32).cpu().numpy()
        return out


class BiEncoder(_Tower):
    """Query/document embedding tower (bge-small semantics: CLS + L2-norm)."""

    def __init__(self, cfg: BertConfig, state_dict, tokenizer, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16, pooling: str = "cls",
                 max_len: int = 512, attn_impl: str = "auto", devices=None):
        """devices: None (one `device`) or a list; with a list, every batch
        splits over it (the module docstring) and `device` is not read."""
        super().__init__(cfg, tokenizer, device, max_len, devices)
        with torch.device("meta"):
            model = BiEncoderModel(cfg, dtype=dtype, pooling=pooling, attn_impl=attn_impl)
        self._build(model, state_dict)

    @classmethod
    def random_init(cls, cfg: Optional[BertConfig] = None, tokenizer=None,
                    seed: int = 0, device="cuda", **kw):
        """Randomly initialised tower (tests, synthetic runs)."""
        if kw.get("devices") is None:
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
        self._build(model, state_dict)

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
