"""Contrastive bi-encoder training: symmetric in-batch-negative InfoNCE,
on one device or over a dp x tp mesh.

Counterpart of `review_recommender_tpu/train/contrastive.py`: TrainConfig,
ContrastiveTrainer (loss `:149-159`, train_step, train_step_async, save,
restore), make_pair_batch, and the tp layout TP_RULES, param_specs and
shard_params (defined in parallel/tp_bert.py, in torch orientation). The
tower computes in `dtype` (bf16 by default, as in JAX) from f32 master
weights; on a CUDA device its attention is the fused kernel forward with
the backward kernel (ops/attention.py:MhaKernelFn, csrc/mha_bwd.cu).

With `mesh=TrainMesh(devices, dp, tp)` (parallel/mesh.py) each dp row
encodes its slice of the queries and documents on its tp cells, and the
(B, H) embeddings of every row are gathered to the lead device, where the
(B, B) logits of the global batch give the loss, as JAX's all-gather over
dp does. Unlike JAX, which pins XLA attention on a mesh (GSPMD cannot
partition a pallas_call over the tp-sharded heads), each cell runs the
attention kernel over its own heads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from review_recommender_tpu_torch.models.bert import BertConfig, BiEncoderModel
from review_recommender_tpu_torch.models.tokenizer import encode_batch
from review_recommender_tpu_torch.parallel.tp_bert import (  # noqa: F401
    TP_RULES,
    param_specs,
    shard_params,
)
from review_recommender_tpu_torch.train.optim import Trainer


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    temperature: float = 0.05  # bge-style InfoNCE temperature
    max_grad_norm: float = 1.0
    remat: bool = False  # recompute each layer's activations in the backward
    seed: int = 0
    #: when total_steps > 0, learning_rate is the PEAK of a linear warmup +
    #: cosine decay (train/optim.py:make_lr)
    total_steps: int = 0
    warmup_steps: int = 0


class ContrastiveTrainer(Trainer):
    """InfoNCE trainer for the BiEncoderModel tower; `params` is a full
    state_dict (f32 on any device); `mesh` a TrainMesh or None."""

    metric = "in_batch_acc"

    def __init__(self, cfg: BertConfig, params, *, train_cfg: Optional[TrainConfig] = None,
                 mesh=None, dtype: torch.dtype = torch.bfloat16, pooling: str = "cls",
                 device="cuda"):
        self.cfg = cfg
        tc = train_cfg or TrainConfig()
        with torch.device("meta"):
            model = BiEncoderModel(cfg, dtype=dtype, pooling=pooling,
                                   param_dtype=torch.float32, remat=tc.remat)
        super().__init__(model, params, tc, device, mesh)

    def _outputs(self, tower, q_ids, q_mask, d_ids, d_mask):
        return tower(q_ids, q_mask), tower(d_ids, d_mask)  # (B, H), L2-normalised in f32

    def _loss_from(self, zq, zd):
        logits = (zq @ zd.T) / self.tc.temperature  # (B, B)
        labels = torch.arange(logits.shape[0], device=logits.device)
        loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
        acc = (logits.argmax(dim=1) == labels).to(torch.float32).mean()
        return loss, acc


def make_pair_batch(tokenizer, queries, docs, max_len=128, pad_to=None):
    """Tokenize a (query, positive) pair batch -> padded int32 arrays."""
    q_ids, q_mask, _ = encode_batch(tokenizer, queries, max_len=max_len, pad_to=pad_to)
    d_ids, d_mask, _ = encode_batch(tokenizer, docs, max_len=max_len, pad_to=pad_to)
    return q_ids, q_mask, d_ids, d_mask
