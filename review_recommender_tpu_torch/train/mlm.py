"""Masked-language-model pretraining of the BERT trunk.

Counterpart of `review_recommender_tpu/train/mlm.py`: MLMModel (the trunk, a dense transform with tanh GELU, a LayerNorm and an
untied vocab decoder, the head in f32), init_mlm, MLMTrainConfig,
make_mlm_batch (host masking: of the sampled positions 80% [MASK], 10% a
random id, 10% kept; the same arrays as JAX for the same
numpy Generator), MLMTrainer (masked-position cross-entropy; with
`mesh=` each dp row sends its three sums to the lead device, which
combines them as JAX `:145-151` does over the global batch) and
pretrain_mlm (each step's texts and mask drawn from default_rng((seed,
step)), so a restored trainer continues the killed run's stream). A
from-scratch cross-encoder learns only from a trunk pretrained this way
(train/cross_encoder.py:warm_start_from_biencoder takes its "encoder."
entries).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from review_recommender_tpu_torch.models.bert import ACT, BertConfig, BertEncoder, init_state_dict
from review_recommender_tpu_torch.models.tokenizer import encode_batch
from review_recommender_tpu_torch.train.optim import Trainer, materialize

logger = logging.getLogger(__name__)


class MLMModel(nn.Module):
    """BertEncoder trunk + transform + untied vocab decoder -> f32 logits."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "auto", param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        h = cfg.hidden_size
        self.encoder = BertEncoder(cfg, dtype, attn_impl, param_dtype)
        self.mlm_transform = nn.Linear(h, h, dtype=torch.float32)
        self.mlm_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps, dtype=torch.float32)
        self.mlm_decoder = nn.Linear(h, cfg.vocab_size, dtype=torch.float32)

    def head(self, param, hidden: torch.Tensor, attention_mask=None) -> torch.Tensor:
        """f32 hidden states -> f32 vocab logits, from the head's parameters
        that `param` gives by name."""
        h = ACT["gelu"](F.linear(hidden, param("mlm_transform.weight"),
                                 param("mlm_transform.bias")))
        h = F.layer_norm(h, (h.shape[-1],), param("mlm_ln.weight"), param("mlm_ln.bias"),
                         self.mlm_ln.eps)
        return F.linear(h, param("mlm_decoder.weight"), param("mlm_decoder.bias"))

    def forward(self, input_ids, attention_mask, token_type_ids=None) -> torch.Tensor:
        hidden = self.encoder(input_ids, attention_mask, token_type_ids).to(torch.float32)
        return self.head(self.get_parameter, hidden, attention_mask)


def init_mlm(cfg: BertConfig, seed: int = 0, dtype: torch.dtype = torch.bfloat16):
    """(MLMModel on the meta device, its f32 state_dict), as the JAX
    init_mlm returns (module, params): random weights from init_state_dict
    (flax's initialisers, a torch Generator's numbers, which differ from
    jax.random's)."""
    with torch.device("meta"):
        model = MLMModel(cfg, dtype=dtype)
    return model, init_state_dict(cfg, "mlm", seed)


@dataclasses.dataclass
class MLMTrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    mask_prob: float = 0.15
    seed: int = 0
    total_steps: int = 0
    warmup_steps: int = 0


def make_mlm_batch(tokenizer, texts: Sequence[str], *, max_len: int,
                   rng: np.random.Generator, mask_prob: float = 0.15):
    """Host-side BERT masking -> (input_ids, attention_mask, labels,
    label_weights); weights are 1.0 exactly at masked positions, and
    CLS/SEP/PAD are never masked. Every row with a maskable token gets at
    least one masked position."""
    ids, attn, _tt = encode_batch(tokenizer, list(texts), max_len=max_len, pad_to=max_len)
    labels = ids.copy()
    special = (ids == tokenizer.cls_id) | (ids == tokenizer.sep_id) | (attn == 0)
    pick = (rng.random(ids.shape) < mask_prob) & ~special
    maskable = ~special
    for i in np.nonzero(pick.sum(axis=1) == 0)[0]:
        cand = np.nonzero(maskable[i])[0]
        if len(cand):
            pick[i, cand[int(rng.integers(len(cand)))]] = True
    action = rng.random(ids.shape)
    vocab_size = getattr(tokenizer, "vocab_size", None) or len(tokenizer.vocab)
    rand_ids = rng.integers(5, vocab_size, size=ids.shape).astype(ids.dtype)
    masked = np.where(action < 0.8, tokenizer.mask_id, np.where(action < 0.9, rand_ids, ids))
    input_ids = np.where(pick, masked, ids)
    weights = pick.astype(np.float32)
    return input_ids, attn, labels, weights


class MLMTrainer(Trainer):
    """Masked-token cross-entropy trainer for the MLMModel; `params` is a
    full state_dict (f32 on any device); `mesh` a TrainMesh or None."""

    metric = "masked_acc"

    def __init__(self, cfg: BertConfig, params, *, train_cfg: Optional[MLMTrainConfig] = None,
                 mesh=None, dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.cfg = cfg
        with torch.device("meta"):
            model = MLMModel(cfg, dtype=dtype, param_dtype=torch.float32)
        super().__init__(model, params, train_cfg or MLMTrainConfig(), device, mesh)

    def _outputs(self, tower, ids, mask, labels, weights):
        """The slice's sum(ce * w), sum(correct * w) and sum(w), each (1,):
        its (B, S, V) logits never leave its device."""
        logits = tower(ids, mask)
        labels = labels.to(torch.int64)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                             reduction="none").reshape(labels.shape)
        correct = (logits.argmax(dim=-1) == labels).to(torch.float32)
        return (ce * weights).sum()[None], (correct * weights).sum()[None], weights.sum()[None]

    def _loss_from(self, ce, correct, weights):
        denom = torch.clamp(weights.sum(), min=1.0)
        return ce.sum() / denom, correct.sum() / denom


def pretrain_mlm(trainer: MLMTrainer, texts: Sequence[str], tokenizer, *,
                 batch_size: int = 64, steps: int = 1000, max_len: int = 96,
                 seed: int = 0, log_every: int = 100,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0) -> List[Dict]:
    """Epochless pretraining from trainer.step to `steps`: each step draws
    its texts and mask from default_rng((seed, step)); checkpoint_every > 0
    saves every N steps, and a final save happens when checkpoint_path is
    set. Returns the per-step metrics."""
    history: List[Dict] = []
    n = len(texts)
    for step_i in range(trainer.step, steps):
        srng = np.random.default_rng((seed, step_i))
        sel = srng.integers(n, size=batch_size)
        batch = make_mlm_batch(tokenizer, [texts[int(i)] for i in sel], max_len=max_len,
                               rng=srng, mask_prob=trainer.tc.mask_prob)
        m = trainer.train_step_async(*batch)  # no per-step device sync
        history.append(m)
        if log_every and m["step"] % log_every == 0:
            logger.info("mlm step %d loss %.4f masked_acc %.3f", m["step"], float(m["loss"]),
                        float(m["masked_acc"]))
        if (checkpoint_path is not None and checkpoint_every
                and m["step"] % checkpoint_every == 0):
            trainer.save(checkpoint_path)
    history = materialize(history)
    if checkpoint_path is not None:
        trainer.save(checkpoint_path)
    return history
