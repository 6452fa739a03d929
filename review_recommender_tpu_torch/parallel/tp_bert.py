"""Megatron tensor parallelism for the three towers over a TrainMesh.

Counterpart of the JAX trainers' tp layout (`review_recommender_tpu/
train/contrastive.py:70-103`: TP_RULES, param_specs, shard_params, which
train/contrastive.py re-exports from here) and of what GSPMD makes of a
jitted step over a ("dp", "tp") mesh, written out for one controller:

  TP_RULES      regexes over the port's state_dict names, each with the
                split dim in torch orientation. A flax Dense kernel is
                (in, out) and nn.Linear.weight (out, in), so JAX's
                P(None, "tp") on a q/k/v/intermediate kernel splits torch
                dim 0, P("tp") its bias dim 0, and P("tp", None) on
                output_dense / layer_N/output torch dim 1; the vocab-sharded
                word embeddings split dim 0 in both. Everything else is
                replicated: LayerNorms, positions, token types, the
                row-parallel biases, the cross-encoder's pooler and
                classifier and the MLM head.
  shard_params  the masters: tp rank r's shards on mesh.home(r), the
                replicated tensors on the lead device. q/k/v and
                output_dense split by whole heads (torch.tensor_split over
                heads, so ranks may hold unequal head counts, or none), the
                FFN by intermediate columns, the embeddings by vocab rows.
                A dim that tp does not divide raises, as JAX's device_put
                of the same NamedSharding does.
  TPModel       the forward of dp row i on its tp cells:
                  vocab-parallel lookup: each rank looks up the ids in its
                    row range and zeroes the rest; the partials are summed
                    on the row's lead cell (exact: one is non-zero a token)
                  column-parallel q/k/v, attention over the rank's own heads
                    (the kernel on CUDA, the plain version on the CPU:
                    ops/attention.py), a row-parallel output_dense whose
                    partials are summed in f32 on the lead cell, then the
                    replicated bias, the residual and the LayerNorm there
                  the same column -> row pattern for the FFN
                  the tower's head on the lead cell (models/bert.py,
                    train/mlm.py)

The partial products are f32 (bf16 operands upcast: their products are
exact in f32), so the tp sum adds no bf16 rounding that the one-device
matmul does not have. Every master reaches a cell through a
differentiable `.to(device)`: gradients from all dp rows accumulate on
the masters, which is JAX's gradient all-reduce over dp. Nothing updates
a copy in place, and a copy that crosses devices is ordered by torch's
device-to-device copy, which waits on both devices' current streams; on
one device (or the CPU) every copy returns the master itself.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from review_recommender_tpu_torch.models.bert import (
    ACT,
    dense,
    key_bias,
    ln_dtype_of,
    residual_layer_norm,
)
from review_recommender_tpu_torch.ops.attention import multihead_attention
from review_recommender_tpu_torch.parallel.mesh import TrainMesh

# (state_dict name regex, split dim in torch orientation); first match wins
TP_RULES: Tuple[Tuple[str, int], ...] = (
    (r"attention\.(query|key|value)\.weight$", 0),
    (r"attention\.(query|key|value)\.bias$", 0),
    (r"attention\.output_dense\.weight$", 1),
    (r"\.intermediate\.weight$", 0),
    (r"\.intermediate\.bias$", 0),
    (r"layers\.\d+\.output\.weight$", 1),
    (r"word_embeddings\.weight$", 0),  # vocab-sharded
)
# the splits that follow whole heads
_BY_HEADS = re.compile(r"attention\.(query|key|value|output_dense)\.")

Shards = Dict[str, List[torch.Tensor]]


def param_specs(params: Mapping[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """name -> the dim TP_RULES split, or None where the tensor is
    replicated."""

    def spec_for(name):
        for pat, dim in TP_RULES:
            if re.search(pat, name):
                return dim
        return None

    return {name: spec_for(name) for name in params}


def split_param(name: str, t: torch.Tensor, dim: int, tp: int,
                num_heads: int) -> Tuple[torch.Tensor, ...]:
    """`t` cut along `dim` into tp views, rank order: by whole heads for
    q/k/v and output_dense (the first num_heads % tp ranks take one head
    more), else into tp equal parts."""
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"{name}: dimension {dim} of size {n} does not split over tp={tp} "
                         f"(shape {tuple(t.shape)})")
    if not _BY_HEADS.search(name):
        return torch.tensor_split(t, tp, dim)
    head_dim = n // num_heads
    counts = [len(c) for c in torch.arange(num_heads).tensor_split(tp)]
    bounds = [head_dim * sum(counts[:r]) for r in range(1, tp)]
    return torch.tensor_split(t, bounds, dim)


def _place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A new contiguous f32 tensor on `device` (never a view of `t`)."""
    return torch.empty(t.shape, dtype=torch.float32, device=device).copy_(t.detach())


def shard_params(params: Mapping[str, torch.Tensor], mesh: TrainMesh,
                 num_heads: int) -> Shards:
    """Place a full state_dict on the mesh under TP_RULES: name -> [tp
    shards, rank r's on mesh.home(r)] or [the replicated tensor on the
    lead device]. New f32 tensors; `params` is not changed."""
    out: Shards = {}
    for name, dim in param_specs(params).items():
        t = params[name]
        if dim is None:
            out[name] = [_place(t, mesh.lead)]
        else:
            out[name] = [_place(piece, mesh.home(r)) for r, piece in
                         enumerate(split_param(name, t, dim, mesh.tp, num_heads))]
    return out


def gather_params(shards: Mapping[str, List[torch.Tensor]], device: torch.device,
                  pick: Callable[[torch.Tensor], torch.Tensor] = torch.Tensor.detach
                  ) -> Dict[str, torch.Tensor]:
    """The full tensors on `device`, from each shard's `pick` (the master
    detached, or its .grad): the shards concatenated along their dim."""
    specs = param_specs(shards)
    return {name: torch.cat([pick(p).to(device) for p in pieces], dim=specs[name] or 0)
            for name, pieces in shards.items()}


def _row_partial(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x @ weight.T in f32 from the `dtype` operands a Dense would use."""
    return F.linear(x.to(torch.float32), weight.to(dtype).to(torch.float32))


class TPModel:
    """The Megatron forward of a BiEncoderModel, CrossEncoderModel or
    MLMModel over `mesh` from its master `shards` (shard_params). `model`
    (on the meta device) gives the configuration, the dtypes, remat, the
    embedding sum and the head; forward(row, ...) runs dp row `row`'s batch
    slice, which lies on the row's lead cell, and returns the tower's output
    there."""

    def __init__(self, model: torch.nn.Module, mesh: TrainMesh, shards: Shards):
        self.model = model
        self.encoder = model.encoder
        self.cfg = self.encoder.cfg
        self.dtype = self.encoder.dtype
        self.remat = self.encoder.remat
        self.mesh = mesh
        self.shards = shards
        self.attn_impl = "auto"  # ops/attention.py:multihead_attention's impl
        self.head_dim = self.cfg.hidden_size // self.cfg.num_heads
        self.act = ACT[self.cfg.hidden_act]
        self.ln_dtype = ln_dtype_of(self.cfg)

    def _replicated(self, device: torch.device) -> Callable[[str], torch.Tensor]:
        return lambda name: self.shards[name][0].to(device)

    def _shard(self, name: str, rank: int, device: torch.device) -> torch.Tensor:
        return self.shards[name][rank].to(device)

    def forward(self, row: int, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cells = self.mesh.grid[row]
        param = self._replicated(cells[0])
        x = self.encoder.embed(lambda n: param("encoder." + n), self._word(cells, input_ids),
                               token_type_ids)
        bias = key_bias(attention_mask)
        for i in range(self.cfg.num_layers):
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(self._layer, i, cells, x, bias, use_reentrant=False)
            else:
                x = self._layer(i, cells, x, bias)
        return self.model.head(param, x.to(torch.float32), attention_mask)

    def row(self, i: int) -> Callable:
        """dp row i's forward, called as a tower: (ids, mask[, types])."""
        return lambda *args: self.forward(i, *args)

    def _word(self, cells, ids: torch.Tensor) -> torch.Tensor:
        """Vocab-parallel lookup, summed on the lead cell in f32."""
        word, lo = None, 0
        for r, dev in enumerate(cells):
            table = self._shard("encoder.word_embeddings.weight", r, dev)
            n = table.shape[0]
            local = ids.to(dev) - lo
            hit = (local >= 0) & (local < n)
            part = torch.where(hit[..., None], F.embedding(local.clamp(0, n - 1), table), 0.0)
            part = part.to(cells[0])
            word = part if word is None else word + part
            lo += n
        return word

    def _reduce(self, parts: List[torch.Tensor], bias: torch.Tensor) -> torch.Tensor:
        """The tp sum of f32 partials, then the replicated bias, in `dtype`."""
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return (total + bias.to(self.dtype).to(torch.float32)).to(self.dtype)

    def _layer(self, i: int, cells, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        p, lead, dt = f"encoder.layers.{i}.", cells[0], self.dtype
        rep = self._replicated(lead)
        parts = []
        for r, dev in enumerate(cells):
            sh = lambda name, r=r, dev=dev: self._shard(p + name, r, dev)
            wq = sh("attention.query.weight")
            heads = wq.shape[0] // self.head_dim
            if not heads:  # a rank past the last head (num_heads < tp)
                continue
            xr = x.to(dev)
            q = dense(xr, wq, sh("attention.query.bias"), dt)
            k = dense(xr, sh("attention.key.weight"), sh("attention.key.bias"), dt)
            v = dense(xr, sh("attention.value.weight"), sh("attention.value.bias"), dt)
            ctx = multihead_attention(q, k, v, bias.to(dev), heads, impl=self.attn_impl)
            parts.append(_row_partial(ctx, sh("attention.output_dense.weight"), dt).to(lead))
        x = self._ln(rep, p + "attention_layer_norm", x,
                     self._reduce(parts, rep(p + "attention.output_dense.bias")))
        parts = []
        for r, dev in enumerate(cells):
            sh = lambda name, r=r, dev=dev: self._shard(p + name, r, dev)
            h = self.act(dense(x.to(dev), sh("intermediate.weight"), sh("intermediate.bias"), dt))
            parts.append(_row_partial(h, sh("output.weight"), dt).to(lead))
        return self._ln(rep, p + "output_layer_norm", x,
                        self._reduce(parts, rep(p + "output.bias")))

    def _ln(self, rep, name: str, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return residual_layer_norm(x, h, rep(name + ".weight"), rep(name + ".bias"),
                                   self.cfg.layer_norm_eps, self.ln_dtype)
