"""Contrastive bi-encoder training: symmetric in-batch-negative InfoNCE.

Counterpart of `review_recommender_tpu/train/contrastive.py` on one
device: TrainConfig, ContrastiveTrainer (loss `:176-186`, train_step,
train_step_async, save, restore) and make_pair_batch. The tower computes
in `dtype` (bf16 by default, as in JAX) from f32 master weights; on a CUDA
device its attention is the fused kernel forward with the recompute
backward (ops/attention.py). The mesh (param_specs, shard_params, mesh=)
is ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from review_recommender_tpu_torch.models.bert import BertConfig, BiEncoderModel
from review_recommender_tpu_torch.models.tokenizer import encode_batch
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
    state_dict (f32 on any device)."""

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

    def _loss(self, q_ids, q_mask, d_ids, d_mask):
        zq = self.model(q_ids, q_mask)  # (B, H), L2-normalised in f32
        zd = self.model(d_ids, d_mask)
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
