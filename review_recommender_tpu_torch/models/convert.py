"""HF checkpoints and flax parameter trees -> the port's state_dict.

`convert_biencoder` / `convert_crossencoder` / `config_from_hf` are the
counterparts of `review_recommender_tpu/models/convert.py:46-132`: an HF
state dict (names -> arrays; a `bert.` prefix dropped, an absent pooler
ignored by the bi-encoder and a KeyError for the cross-encoder, as there)
becomes the flax parameter tree of the JAX towers, with numpy leaves:

  embeddings.{word,position,token_type}_embeddings.weight
                                            encoder/*_embeddings/embedding
  embeddings.LayerNorm                      encoder/embeddings_layer_norm
  encoder.layer.I.attention.self.{query,key,value}
                                            encoder/layer_I/attention/*
  encoder.layer.I.attention.output.dense    encoder/layer_I/attention/output_dense
  encoder.layer.I.attention.output.LayerNorm
                                            encoder/layer_I/attention_layer_norm
  encoder.layer.I.{intermediate,output}.dense
                                            encoder/layer_I/{intermediate,output}
  encoder.layer.I.output.LayerNorm          encoder/layer_I/output_layer_norm
  pooler.dense, classifier (cross-encoder)  pooler, classifier

(torch Linear (out, in) -> flax Dense kernel (in, out)). `params_from_flax`
then maps that tree onto the port's modules: the parameters of the JAX towers (`review_recommender_tpu/models/
bert.py`), given as numpy arrays (`jax.tree.map(np.asarray, params)`), onto
the nn.Modules of models/bert.py:

  encoder/word_embeddings/embedding         encoder.word_embeddings.weight
  encoder/{position,token_type}_embeddings  encoder.*_embeddings.weight
  encoder/embeddings_layer_norm/{scale,bias} encoder.embeddings_layer_norm.{weight,bias}
  encoder/layer_I/attention/{query,key,value,output_dense}/{kernel,bias}
                                            encoder.layers.I.attention.*.{weight=kernel.T,bias}
  encoder/layer_I/{attention,output}_layer_norm
                                            encoder.layers.I.*_layer_norm.{weight,bias}
  encoder/layer_I/{intermediate,output}     encoder.layers.I.{intermediate,output}
  pooler, classifier (cross-encoder)        pooler, classifier (f32)
  mlm_transform, mlm_ln, mlm_decoder (kind "mlm", train/mlm.py's head)
                                            the same names (f32)

flax Dense kernels are (in, out); torch Linear weights are (out, in). The
attention and FFN Linear weights are cast to `dtype` here (f32 by
default, a serving wrapper's load casts them once to its compute dtype);
embeddings, LayerNorms and the heads stay f32, as in the flax modules.
`flax_from_params` is the way back: a state_dict (the trainers' f32
parameters, or their gradients) -> the flax tree with f32 numpy leaves,
which save_native_tower writes and the JAX loaders read.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from review_recommender_tpu_torch.models.bert import BertConfig

KINDS = ("biencoder", "crossencoder", "mlm")
# the heads outside the trunk: Dense layers, and LayerNorms (scale/bias)
_HEADS = {"biencoder": ((), ()), "crossencoder": (("pooler", "classifier"), ()),
          "mlm": (("mlm_transform", "mlm_decoder"), ("mlm_ln",))}


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _np(t) -> np.ndarray:
    """Tensor-like -> float32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().to(torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)


def _strip_prefix(sd: Mapping[str, object]) -> Dict[str, object]:
    """Drop a leading 'bert.' (BertForSequenceClassification) prefix."""
    return {(k[5:] if k.startswith("bert.") else k): v for k, v in sd.items()}


def _layer_params(sd: Mapping[str, object], i: int) -> dict:
    p = f"encoder.layer.{i}."
    dense = lambda name: {"kernel": _np(sd[p + name + ".weight"]).T,
                          "bias": _np(sd[p + name + ".bias"])}
    ln = lambda name: {"scale": _np(sd[p + name + ".weight"]),
                       "bias": _np(sd[p + name + ".bias"])}
    return {
        "attention": {
            "query": dense("attention.self.query"),
            "key": dense("attention.self.key"),
            "value": dense("attention.self.value"),
            "output_dense": dense("attention.output.dense"),
        },
        "attention_layer_norm": ln("attention.output.LayerNorm"),
        "intermediate": dense("intermediate.dense"),
        "output": dense("output.dense"),
        "output_layer_norm": ln("output.LayerNorm"),
    }


def convert_bert_encoder(sd: Mapping[str, object], cfg: BertConfig) -> dict:
    """HF BertModel state dict -> the flax tree under "encoder"."""
    sd = _strip_prefix(sd)
    enc = {
        name: {"embedding": _np(sd[f"embeddings.{name}.weight"])}
        for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")
    }
    enc["embeddings_layer_norm"] = {"scale": _np(sd["embeddings.LayerNorm.weight"]),
                                    "bias": _np(sd["embeddings.LayerNorm.bias"])}
    for i in range(cfg.num_layers):
        enc[f"layer_{i}"] = _layer_params(sd, i)
    return enc


def convert_biencoder(sd: Mapping[str, object], cfg: BertConfig) -> dict:
    """HF BertModel state dict -> the bi-encoder's flax tree."""
    return {"encoder": convert_bert_encoder(sd, cfg)}


def convert_crossencoder(sd: Mapping[str, object], cfg: BertConfig) -> dict:
    """HF BertForSequenceClassification state dict -> the cross-encoder's
    flax tree (pooler and one-logit classifier)."""
    stripped = _strip_prefix(sd)
    return {
        "encoder": convert_bert_encoder(sd, cfg),
        "pooler": {"kernel": _np(stripped["pooler.dense.weight"]).T,
                   "bias": _np(stripped["pooler.dense.bias"])},
        "classifier": {"kernel": _np(stripped["classifier.weight"]).T,
                       "bias": _np(stripped["classifier.bias"])},
    }


def config_from_hf(hf_config) -> BertConfig:
    """A transformers BertConfig (or any object with its fields) ->
    BertConfig."""
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        hidden_act=hf_config.hidden_act,
        pad_token_id=hf_config.pad_token_id,
    )


def params_from_flax(params: Mapping, cfg: BertConfig, kind: str,
                     dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The flax tree under "params" (numpy leaves) -> a CPU state_dict."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    enc = params["encoder"]
    sd: Dict[str, torch.Tensor] = {}

    def dense(dst, src, dt):
        sd[f"{dst}.weight"] = _t(np.asarray(src["kernel"]).T, dt)
        sd[f"{dst}.bias"] = _t(src["bias"], dt)

    def layer_norm(dst, src):
        sd[f"{dst}.weight"] = _t(src["scale"])
        sd[f"{dst}.bias"] = _t(src["bias"])

    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"encoder.{name}.weight"] = _t(enc[name]["embedding"])
    layer_norm("encoder.embeddings_layer_norm", enc["embeddings_layer_norm"])
    for i in range(cfg.num_layers):
        src = enc[f"layer_{i}"]
        p = f"encoder.layers.{i}."
        for name in ("query", "key", "value", "output_dense"):
            dense(p + "attention." + name, src["attention"][name], dtype)
        layer_norm(p + "attention_layer_norm", src["attention_layer_norm"])
        dense(p + "intermediate", src["intermediate"], dtype)
        dense(p + "output", src["output"], dtype)
        layer_norm(p + "output_layer_norm", src["output_layer_norm"])
    dense_heads, ln_heads = _HEADS[kind]
    for name in dense_heads:
        dense(name, params[name], torch.float32)
    for name in ln_heads:
        layer_norm(name, params[name])
    return sd


def flax_from_params(sd: Mapping[str, torch.Tensor], cfg: BertConfig, kind: str) -> dict:
    """A state_dict in params_from_flax's layout -> the flax tree, f32 numpy."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    arr = lambda name: np.array(_np(sd[name]))  # a copy, never a view of a live tensor
    dense = lambda name: {"kernel": arr(f"{name}.weight").T.copy(), "bias": arr(f"{name}.bias")}
    ln = lambda name: {"scale": arr(f"{name}.weight"), "bias": arr(f"{name}.bias")}
    enc = {name: {"embedding": arr(f"encoder.{name}.weight")}
           for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    enc["embeddings_layer_norm"] = ln("encoder.embeddings_layer_norm")
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}."
        enc[f"layer_{i}"] = {
            "attention": {name: dense(p + "attention." + name)
                          for name in ("query", "key", "value", "output_dense")},
            "attention_layer_norm": ln(p + "attention_layer_norm"),
            "intermediate": dense(p + "intermediate"),
            "output": dense(p + "output"),
            "output_layer_norm": ln(p + "output_layer_norm"),
        }
    tree = {"encoder": enc}
    dense_heads, ln_heads = _HEADS[kind]
    tree.update({name: dense(name) for name in dense_heads})
    tree.update({name: ln(name) for name in ln_heads})
    return tree
