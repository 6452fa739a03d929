"""Pointwise cross-encoder training: sigmoid BCE over (query, doc, label)
triples.

Counterpart of `review_recommender_tpu/train/cross_encoder.py`:
CrossTrainConfig, CrossEncoderTrainer (BCE on the one relevance logit,
accuracy of the logit's sign; with `mesh=` each dp row scores its slice on
its tp cells and the (B,) logits are gathered to the lead device, as in
JAX `:90-96`), warm_start_from_biencoder (the
trunk of a bi-encoder or an MLM model grafted in, `:147-181`),
make_triple_batch and train_crossencoder (its shuffle stream and resume
skip as in JAX). A from-scratch cross-encoder needs a pretrained trunk to
leave the label base rate (train/mlm.py).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from review_recommender_tpu_torch.models.bert import BertConfig, CrossEncoderModel
from review_recommender_tpu_torch.models.tokenizer import encode_batch
from review_recommender_tpu_torch.train.optim import Trainer, materialize

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CrossTrainConfig:
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    seed: int = 0
    #: warmup + cosine when set (train/optim.py:make_lr)
    total_steps: int = 0
    warmup_steps: int = 0


class CrossEncoderTrainer(Trainer):
    """BCE trainer for the CrossEncoderModel pair scorer; `params` is a
    full state_dict (f32 on any device); `mesh` a TrainMesh or None."""

    metric = "acc"

    def __init__(self, cfg: BertConfig, params, *,
                 train_cfg: Optional[CrossTrainConfig] = None, mesh=None,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.cfg = cfg
        with torch.device("meta"):
            model = CrossEncoderModel(cfg, dtype=dtype, param_dtype=torch.float32)
        super().__init__(model, params, train_cfg or CrossTrainConfig(), device, mesh)

    def _outputs(self, tower, ids, mask, ttype, labels):
        return tower(ids, mask, ttype), labels

    def _loss_from(self, logits, labels):
        labels = labels.to(torch.float32)
        loss = F.binary_cross_entropy_with_logits(logits, labels)
        acc = ((logits > 0) == (labels > 0.5)).to(torch.float32).mean()
        return loss, acc


def warm_start_from_biencoder(xe_params: Mapping[str, torch.Tensor],
                              bi_params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The cross-encoder state_dict with its trunk (every "encoder." entry)
    taken from a bi-encoder's or MLM model's state_dict; the pooler and
    classifier keep their init. The two trunks must have the same entries;
    a shape may differ only in size along its axes (max_position), where
    the overlapping leading rows are copied and the rest keeps its init.
    Returns new tensors; neither input is changed."""
    trunk = lambda sd: {k for k in sd if k.startswith("encoder.")}
    if trunk(xe_params) != trunk(bi_params):
        raise ValueError("the two trunks do not have the same parameters: "
                         f"{sorted(trunk(xe_params) ^ trunk(bi_params))[:4]}")
    out = dict(xe_params)
    for name in trunk(xe_params):
        s, d = bi_params[name].detach(), xe_params[name].detach()
        s = s.to(d.device, d.dtype)
        if s.shape == d.shape:
            out[name] = s.clone()
            continue
        if s.dim() != d.dim():
            raise ValueError(f"{name}: cannot graft {tuple(s.shape)} into {tuple(d.shape)}")
        sl = tuple(slice(0, min(a, b)) for a, b in zip(s.shape, d.shape))
        d = d.clone()
        d[sl] = s[sl]
        out[name] = d
    return out


def make_triple_batch(tokenizer, queries, docs, labels, max_len=128, pad_to=None):
    """Tokenize (query, doc) pairs with labels -> padded int32 arrays and a
    float32 label vector; [CLS] q [SEP] d [SEP] with token types."""
    ids, mask, ttype = encode_batch(tokenizer, queries, pairs=docs, max_len=max_len,
                                    pad_to=pad_to)
    return ids, mask, ttype, np.asarray(labels, np.float32)


def train_crossencoder(trainer: CrossEncoderTrainer, triples, tokenizer, *,
                       batch_size: int = 32, epochs: int = 1, max_len: int = 128,
                       seed: int = 0, checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 0, log_every: int = 50):
    """Epoch loop over (query, doc, label) triples: shuffled, fixed pad
    width, the first trainer.step batches skipped (a restored checkpoint
    continues the killed run's stream); checkpoint_every > 0 saves every N
    steps, and a final save happens when checkpoint_path is set. Returns
    the per-step metrics."""
    rng = np.random.default_rng(seed)
    history = []
    n = len(triples)
    produced = 0
    for _ in range(epochs):
        order = rng.permutation(n)
        for lo in range(0, n, batch_size):
            sel = order[lo : lo + batch_size]
            if len(sel) < batch_size:
                break
            produced += 1
            if produced <= trainer.step:
                continue
            qs = [triples[i][0] for i in sel]
            ds = [triples[i][1] for i in sel]
            ys = [triples[i][2] for i in sel]
            batch = make_triple_batch(tokenizer, qs, ds, ys, max_len=max_len, pad_to=max_len)
            m = trainer.train_step_async(*batch)  # no per-step device sync
            history.append(m)
            if log_every and m["step"] % log_every == 0:
                logger.info("step %d loss %.4f acc %.3f", m["step"], float(m["loss"]),
                            float(m["acc"]))
            if (checkpoint_path is not None and checkpoint_every
                    and m["step"] % checkpoint_every == 0):
                trainer.save(checkpoint_path)
    history = materialize(history)
    if checkpoint_path is not None:
        trainer.save(checkpoint_path)
    return history
