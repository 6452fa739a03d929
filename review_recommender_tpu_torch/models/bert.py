"""BERT-family towers as nn.Modules: the bi-encoder (bge-small geometry,
CLS pooling + L2 norm) and the cross-encoder (MiniLM-L6 geometry, tanh
pooler + one logit).

Counterpart of `review_recommender_tpu/models/bert.py:33-227`, with the same
dtype boundaries as the flax modules:

  - embeddings are summed and layer-normed in f32, then cast to `dtype`;
  - the attention and FFN Linear layers compute in `dtype` from weights
    stored in `param_dtype` (default: `dtype`). Serving stores them in
    `dtype`, cast once at load, so a forward adds no cast; training stores
    f32 masters (`param_dtype=torch.float32`) and casts weight and bias to
    `dtype` inside each forward, the product flax's Dense computes with its
    f32 params;
  - `remat=True` recomputes each layer's activations in the backward
    (torch.utils.checkpoint per layer, flax's nn.remat);
  - both residual LayerNorms take (x + h) in `dtype`, rounded to
    `cfg.ln_dtype`, and reduce and apply scale and bias in f32, as flax's
    LayerNorm(dtype=ln_dtype, param_dtype=f32) does; the result is rounded
    to ln_dtype, then cast to `dtype`. "float32" (the default) is the JAX
    package's HF-parity setting, "bfloat16" its serving knob;
  - GELU is the tanh approximation (flax.linen.gelu's default), not erf;
  - pooler and classifier are f32; the bi-encoder output is L2-normalised
    in f32.

flax's LayerNorm takes the variance as E[x^2] - E[x]^2; torch's layer_norm
uses a two-pass variance. At f32 and unit-scale activations the two differ
by ~1e-7 relative per LayerNorm; the parity tests hold towers to 1e-4.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from review_recommender_tpu_torch.ops.attention import multihead_attention

ACT = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    pad_token_id: int = 0
    ln_dtype: str = "float32"

    @classmethod
    def bge_small(cls) -> "BertConfig":
        return cls()

    @classmethod
    def minilm_l6_cross(cls) -> "BertConfig":
        return cls(num_layers=6)

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "BertConfig":
        """Small config for tests."""
        return cls(
            vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64,
        )


LN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def ln_dtype_of(cfg: "BertConfig") -> torch.dtype:
    """The residual LayerNorms' dtype; any other name than the two raises,
    as the JAX layer does (a typo would silently change the numerics)."""
    if cfg.ln_dtype not in LN_DTYPES:
        raise ValueError(f"ln_dtype={cfg.ln_dtype!r} (expected 'float32'/'bfloat16') "
                         "— a typo here would silently degrade LayerNorm numerics")
    return LN_DTYPES[cfg.ln_dtype]


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax's Dense(dtype=dtype): weight and bias cast to `dtype`, the
    product in `dtype` (no-op casts where they are stored in it)."""
    return F.linear(x, weight.to(dtype), bias.to(dtype))


def residual_layer_norm(x: torch.Tensor, h: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, eps: float, ln_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm(x + h) as BertLayer takes it: the sum in x's dtype, rounded
    to ln_dtype, statistics, scale and bias in f32, the result rounded to
    ln_dtype and returned in x's dtype."""
    y = (x + h).to(ln_dtype).to(torch.float32)
    return F.layer_norm(y, (y.shape[-1],), weight, bias, eps).to(ln_dtype).to(x.dtype)


class Dense(nn.Linear):
    """nn.Linear computing in `dtype` from parameters stored in
    `param_dtype`; the casts are no-ops where the two agree."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(n_in, n_out, dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype, attn_impl: str = "auto",
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.attn_impl = attn_impl
        self.query = Dense(h, h, dtype, param_dtype)
        self.key = Dense(h, h, dtype, param_dtype)
        self.value = Dense(h, h, dtype, param_dtype)
        self.output_dense = Dense(h, h, dtype, param_dtype)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        ctx = multihead_attention(self.query(x), self.key(x), self.value(x),
                                  key_bias, self.num_heads, impl=self.attn_impl)
        return self.output_dense(ctx)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype, attn_impl: str = "auto",
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.dtype = dtype
        self.ln_dtype = ln_dtype_of(cfg)
        self.eps = eps
        self.act = ACT[cfg.hidden_act]
        self.attention = SelfAttention(cfg, dtype, attn_impl, param_dtype)
        self.attention_layer_norm = nn.LayerNorm(h, eps=eps, dtype=torch.float32)
        self.intermediate = Dense(h, cfg.intermediate_size, dtype, param_dtype)
        self.output = Dense(cfg.intermediate_size, h, dtype, param_dtype)
        self.output_layer_norm = nn.LayerNorm(h, eps=eps, dtype=torch.float32)

    def _ln(self, ln: nn.LayerNorm, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return residual_layer_norm(x, h, ln.weight, ln.bias, self.eps, self.ln_dtype)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        x = self._ln(self.attention_layer_norm, x, self.attention(x, attn_bias))
        h = self.output(self.act(self.intermediate(x)))
        return self._ln(self.output_layer_norm, x, h)


def key_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """The additive f32 bias over KEY positions: 0 keep, -1e30 drop."""
    return torch.where(attention_mask.bool(), 0.0, -1e30).to(torch.float32)


class BertEncoder(nn.Module):
    """Token ids -> per-token hidden states (B, S, H) in `dtype`."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", param_dtype: Optional[torch.dtype] = None,
                 remat: bool = False):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, dtype=torch.float32)
        self.position_embeddings = nn.Embedding(cfg.max_position, h, dtype=torch.float32)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h, dtype=torch.float32)
        self.embeddings_layer_norm = nn.LayerNorm(h, eps=cfg.layer_norm_eps, dtype=torch.float32)
        self.layers = nn.ModuleList(
            BertLayer(cfg, dtype, attn_impl, param_dtype) for _ in range(cfg.num_layers))

    def set_attn_impl(self, impl: str) -> None:
        for m in self.modules():
            if isinstance(m, SelfAttention):
                m.attn_impl = impl

    def embed(self, param: Callable[[str], torch.Tensor], word: torch.Tensor,
              token_type_ids: Optional[torch.Tensor]) -> torch.Tensor:
        """The looked-up word embeddings (B, S, H) f32 plus positions and
        token types, layer-normed in f32, in `dtype`; `param` gives each of
        this module's other parameters by name."""
        if token_type_ids is None:
            token_type_ids = torch.zeros(word.shape[:2], dtype=torch.int64, device=word.device)
        positions = torch.arange(word.shape[1], device=word.device)
        x = (word + F.embedding(positions, param("position_embeddings.weight"))[None]
             + F.embedding(token_type_ids, param("token_type_embeddings.weight")))
        return F.layer_norm(x, (x.shape[-1],), param("embeddings_layer_norm.weight"),
                            param("embeddings_layer_norm.bias"), self.cfg.layer_norm_eps
                            ).to(self.dtype)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embed(self.get_parameter, self.word_embeddings(input_ids), token_type_ids)
        attn_bias = key_bias(attention_mask)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, attn_bias, use_reentrant=False)
            else:
                x = layer(x, attn_bias)
        return x


class BiEncoderModel(nn.Module):
    """Sentence embedding tower: CLS (or mean) pooling + L2 norm in f32."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.bfloat16,
                 pooling: str = "cls", attn_impl: str = "auto",
                 param_dtype: Optional[torch.dtype] = None, remat: bool = False):
        super().__init__()
        if pooling not in ("cls", "mean"):
            raise ValueError(f"pooling must be 'cls' or 'mean', got {pooling!r}")
        self.pooling = pooling
        self.encoder = BertEncoder(cfg, dtype, attn_impl, param_dtype, remat)

    def head(self, param, hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """f32 hidden states -> the pooled, L2-normalised embedding (no
        parameters; `param` is the other heads' signature)."""
        if self.pooling == "cls":
            pooled = hidden[:, 0, :]
        else:
            m = attention_mask[:, :, None].to(torch.float32)
            pooled = (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
        norm = torch.sqrt((pooled * pooled).sum(dim=-1, keepdim=True))
        return pooled / torch.clamp(norm, min=1e-12)

    def forward(self, input_ids, attention_mask, token_type_ids=None) -> torch.Tensor:
        hidden = self.encoder(input_ids, attention_mask, token_type_ids).to(torch.float32)
        return self.head(self.get_parameter, hidden, attention_mask)


class CrossEncoderModel(nn.Module):
    """(query, doc) relevance: BERT -> tanh pooler -> 1 logit, head in f32."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = BertEncoder(cfg, dtype, attn_impl, param_dtype)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, dtype=torch.float32)
        self.classifier = nn.Linear(cfg.hidden_size, 1, dtype=torch.float32)

    def head(self, param, hidden: torch.Tensor, attention_mask=None) -> torch.Tensor:
        """f32 hidden states -> one logit a row, from the pooler and
        classifier parameters that `param` gives by name."""
        pooled = torch.tanh(F.linear(hidden[:, 0, :], param("pooler.weight"),
                                     param("pooler.bias")))
        return F.linear(pooled, param("classifier.weight"), param("classifier.bias"))[:, 0]

    def forward(self, input_ids, attention_mask, token_type_ids=None) -> torch.Tensor:
        hidden = self.encoder(input_ids, attention_mask, token_type_ids).to(torch.float32)
        return self.head(self.get_parameter, hidden, attention_mask)


def init_state_dict(cfg: BertConfig, kind: str, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random f32 CPU weights from a seeded torch.Generator, in the layout of
    `params_from_flax` (kind "mlm": the trunk and train/mlm.py's head):
    Linear weights normal(0, 1/fan_in) (lecun), biases 0, embeddings
    normal(0, 1/H), LayerNorm scale 1 and bias 0 (flax's default
    initialisers, untruncated)."""
    if kind not in ("biencoder", "crossencoder", "mlm"):
        raise ValueError(f"kind must be 'biencoder', 'crossencoder' or 'mlm', got {kind!r}")
    g = torch.Generator().manual_seed(int(seed))
    h, ff = cfg.hidden_size, cfg.intermediate_size
    normal = lambda *shape, std: torch.randn(*shape, generator=g) * std
    sd: Dict[str, torch.Tensor] = {}

    def linear(name, n_in, n_out):
        sd[f"{name}.weight"] = normal(n_out, n_in, std=1.0 / math.sqrt(n_in))
        sd[f"{name}.bias"] = torch.zeros(n_out)

    def layer_norm(name):
        sd[f"{name}.weight"] = torch.ones(h)
        sd[f"{name}.bias"] = torch.zeros(h)

    for name, n in (("word_embeddings", cfg.vocab_size),
                    ("position_embeddings", cfg.max_position),
                    ("token_type_embeddings", cfg.type_vocab_size)):
        sd[f"encoder.{name}.weight"] = normal(n, h, std=1.0 / math.sqrt(h))
    layer_norm("encoder.embeddings_layer_norm")
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}."
        for name in ("query", "key", "value", "output_dense"):
            linear(p + "attention." + name, h, h)
        layer_norm(p + "attention_layer_norm")
        linear(p + "intermediate", h, ff)
        linear(p + "output", ff, h)
        layer_norm(p + "output_layer_norm")
    if kind == "crossencoder":
        linear("pooler", h, h)
        linear("classifier", h, 1)
    if kind == "mlm":
        linear("mlm_transform", h, h)
        layer_norm("mlm_ln")
        linear("mlm_decoder", h, cfg.vocab_size)
    return sd
