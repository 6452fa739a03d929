"""flax parameter tree -> the port's state_dict.

Maps the parameters of the JAX towers (`review_recommender_tpu/models/
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

flax Dense kernels are (in, out); torch Linear weights are (out, in). The
attention and FFN Linear weights are cast to the compute dtype here, once,
where flax casts them on every call; embeddings, LayerNorms and the
cross-encoder head stay f32, as in the flax modules.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from review_recommender_tpu_torch.models.bert import BertConfig

KINDS = ("biencoder", "crossencoder")


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


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
    if kind == "crossencoder":
        dense("pooler", params["pooler"], torch.float32)
        dense("classifier", params["classifier"], torch.float32)
    return sd
