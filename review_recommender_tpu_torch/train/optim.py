"""The JAX trainers' optimizer and the state every trainer shares.

Counterpart of the optax chain in `review_recommender_tpu/train/
contrastive.py:155-158` and `make_lr` (`:47-57`):

  optax.chain(clip_by_global_norm(max_grad_norm),
              adamw(make_lr(tc), weight_decay=tc.weight_decay))

  - clipping as optax does it: every gradient becomes g / norm * max_norm
    when the global norm is at least max_norm, and stays as it is below
    (torch.nn.utils.clip_grad_norm_ divides by norm + 1e-6 instead);
  - torch.optim.AdamW with one parameter group, betas (0.9, 0.999), eps
    1e-8: the same update as optax.adamw, weight decay on every leaf
    (LayerNorms and biases included) and scaled by the learning rate;
  - the learning rate of update n (counted from 0, as optax's count) is
    make_lr's schedule at n, so with a warmup the first update has lr 0.

The step runs on the device with no host sync of its own: the batch
goes up from pinned memory without blocking, the clip factor is a
tensor, and the learning rate is computed on the host from the count.

Trainer holds what the three trainers share: the model on its device
with f32 master weights, the optimizer, the step count, metrics returned
as device tensors (train_step_async) or floats (train_step), and the
checkpoint: {"params", "opt_state", "step"} through torch.save, readable
with torch.load(weights_only=True), written to a .tmp file and renamed.

With `mesh=` (a parallel/mesh.py TrainMesh) the masters are the tp
shards of parallel/tp_bert.py:shard_params, the batch splits into dp
equal slices (a batch that dp does not divide raises, as JAX's
in_shardings do), each slice runs on its dp row's cells
(parallel/tp_bert.py:TPModel) and each trainer's per-slice outputs are
gathered to the lead device, where the loss is the JAX trainer's over
the global batch. AdamW is elementwise, so updating the shards is the
unsharded update; the clip norm counts each master once. Checkpoints are
layout-free, as JAX's are: save gathers the params and the optimizer
state into the one-device layout, and restore shards them again, so a
mesh checkpoint restores on one device and the other way round.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Union

import numpy as np
import torch

from review_recommender_tpu_torch.device import resolve_device
from review_recommender_tpu_torch.models.encoder import build_model
from review_recommender_tpu_torch.parallel.tp_bert import (
    TPModel,
    gather_params,
    param_specs,
    shard_params,
    split_param,
)


def _warmup_cosine(peak: float, warmup: int, decay_steps: int, end: float) -> Callable:
    """optax.warmup_cosine_decay_schedule(init_value=0, peak, warmup,
    decay_steps, end), in float32 arithmetic in optax's order."""
    if decay_steps - warmup <= 0:
        raise ValueError(f"the cosine decay needs total_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup}")
    f = np.float32
    alpha = 0.0 if peak == 0.0 else end / peak
    span = decay_steps - warmup

    def schedule(count: int) -> float:
        if count < warmup:  # linear_schedule(0, peak, warmup)
            frac = f(1) - f(max(count, 0)) / f(warmup)
            return float(f(0.0 - peak) * frac + f(peak))
        t = f(min(count - warmup, span))
        cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * t / f(span)))
        return float(f(peak) * (f(1 - alpha) * cosine + f(alpha)))

    return schedule


def make_lr(tc) -> Union[Callable[[int], float], float]:
    """Constant lr, or warmup + cosine when tc.total_steps is set (the
    warmup is tc.warmup_steps or a tenth of the steps, the end 0.05 x the
    peak)."""
    if getattr(tc, "total_steps", 0) and tc.total_steps > 0:
        warmup = tc.warmup_steps or max(1, tc.total_steps // 10)
        return _warmup_cosine(tc.learning_rate, warmup, tc.total_steps,
                              0.05 * tc.learning_rate)
    return tc.learning_rate


class AdamWClip:
    """clip_by_global_norm then AdamW over a fixed list of parameters."""

    def __init__(self, params, tc):
        self.params = list(params)
        self.max_norm = float(tc.max_grad_norm)
        self.lr = make_lr(tc)
        self.opt = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=tc.weight_decay)

    def lr_at(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else float(self.lr)

    def step(self, count: int) -> None:
        """Update `count` (0-based) from the parameters' .grad. The global
        norm is taken on the first parameter's device; on a mesh each
        master shard counts once."""
        for p in self.params:  # optax updates (and decays) every leaf
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        by_device: Dict[torch.device, List[torch.Tensor]] = {}
        for p in self.params:
            by_device.setdefault(p.device, []).append(p.grad)
        lead = self.params[0].device
        norm = torch.linalg.vector_norm(torch.stack(
            [n.to(lead) for grads in by_device.values() for n in torch._foreach_norm(grads)]))
        keep = norm < self.max_norm
        one = torch.ones_like(norm)
        div, mul = torch.where(keep, one, norm), torch.where(keep, one, one * self.max_norm)
        for dev, grads in by_device.items():
            torch._foreach_div_(grads, div.to(dev))
            torch._foreach_mul_(grads, mul.to(dev))
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(count)
        self.opt.step()


class Trainer:
    """A model with f32 master weights on `device` (or sharded over `mesh`),
    its optimizer and its step count. Subclasses define _outputs(tower,
    *batch) -> a tuple of per-slice tensors, each concatenated over dp rows
    along dim 0, and _loss_from(*outputs) -> (loss, metric), and name the
    metric."""

    metric = "acc"

    def __init__(self, model: torch.nn.Module, params, tc, device, mesh=None):
        self.tc = tc
        self.mesh = mesh
        self.names = [n for n, _ in model.named_parameters()]
        if mesh is None:
            self.device = resolve_device(device)
            self.model = build_model(model, params, self.device).train()
            masters = list(self.model.parameters())
        else:
            self.device = mesh.lead
            self.model = model  # on the meta device: names, dtypes and the heads' code
            self.num_heads = model.encoder.cfg.num_heads
            shards = shard_params({n: params[n] for n in self.names}, mesh, self.num_heads)
            self.shards = {n: [torch.nn.Parameter(t) for t in shards[n]] for n in self.names}
            self.tp_model = TPModel(model, mesh, self.shards)
            masters = [p for n in self.names for p in self.shards[n]]
        self.optim = AdamWClip(masters, tc)
        self.step = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The f32 weights as a state_dict: views of the live parameters on
        one device, the gathered shards (on the lead device) on a mesh."""
        if self.mesh is None:
            return self.model.state_dict()
        return gather_params(self.shards, self.device)

    def set_attn_impl(self, impl: str) -> None:
        """The towers' attention: "auto" (the kernel on CUDA: the tensor-core
        route in bf16/f16, the generic route's 3xTF32 in f32), "kernel" or
        "reference" (the plain version)."""
        if self.mesh is None:
            self.model.encoder.set_attn_impl(impl)
        else:
            self.tp_model.attn_impl = impl

    def gradients(self) -> Dict[str, torch.Tensor]:
        """The masters' .grad as a full state_dict (after a backward); a
        shard the step did not reach (a rank past the last head) counts as
        zeros, as the optimizer takes it."""
        if self.mesh is None:
            return {n: p.grad for n, p in self.model.named_parameters()}
        return gather_params(self.shards, self.device,
                             lambda p: torch.zeros_like(p) if p.grad is None else p.grad)

    def _tensors(self, arrays, device=None):
        """The host batch on `device` (default: the trainer's). A CUDA
        upload goes through pinned memory with non_blocking=True: a copy
        from pageable memory would wait for every kernel already queued, so
        each step would wait for the one before it."""
        device = device or self.device
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if device.type != "cuda":
            return [t.to(device) for t in host]
        return [t.pin_memory().to(device, non_blocking=True) for t in host]

    def _loss(self, *tensors):
        """(loss, metric) of a batch already on the device (one device)."""
        return self._loss_from(*self._outputs(self.model, *tensors))

    def _batch_loss(self, batch):
        """(loss, metric) of a host batch: on a mesh, dp row i takes rows
        [i * B / dp, (i + 1) * B / dp), and the outputs meet on the lead
        device."""
        if self.mesh is None:
            return self._loss(*self._tensors(batch))
        dp, n = self.mesh.dp, len(batch[0])
        if n % dp:
            raise ValueError(f"a batch of {n} rows does not split over dp={dp}")
        per, outs = n // dp, []
        for i in range(dp):
            part = self._tensors([a[i * per:(i + 1) * per] for a in batch], self.mesh.grid[i][0])
            outs.append(self._outputs(self.tp_model.row(i), *part))
        lead = self.mesh.lead
        return self._loss_from(*(torch.cat([o[j].to(lead) for o in outs])
                                 for j in range(len(outs[0]))))

    def train_step_async(self, *batch) -> Dict:
        """One step; the metrics stay device tensors (no host sync), so a
        loop reads them only where it logs and at its end."""
        loss, metric = self._batch_loss(batch)
        self.optim.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(self.step)
        self.step += 1
        return {"loss": loss.detach(), self.metric: metric.detach(), "step": self.step}

    def train_step(self, *batch) -> Dict[str, float]:
        """One step; returns the metrics as floats (syncs with the device)."""
        m = self.train_step_async(*batch)
        return {k: v if k == "step" else float(v) for k, v in m.items()}

    def _opt_state(self) -> dict:
        """The optimizer's state_dict in the one-device layout (parameter i
        the model's i-th), the shards' moments concatenated on a mesh."""
        sd = self.optim.opt.state_dict()
        if self.mesh is None:
            return sd
        state, k = {}, 0
        specs = param_specs(self.shards)
        for i, name in enumerate(self.names):
            pieces = [sd["state"].get(k + r) for r in range(len(self.shards[name]))]
            k += len(pieces)
            if pieces[0] is None:
                continue
            state[i] = {key: pieces[0][key] if key == "step" else
                        torch.cat([st[key].to(self.device) for st in pieces],
                                  dim=specs[name] or 0) for key in pieces[0]}
        groups = [{**g, "params": list(range(len(self.names)))} for g in sd["param_groups"]]
        return {"state": state, "param_groups": groups}

    def save(self, path) -> None:
        """Params, optimizer state and step, atomically (.tmp and rename), in
        the one-device layout."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        torch.save({"params": {k: v.detach().cpu() for k, v in self.params.items()},
                    "opt_state": self._opt_state(), "step": self.step}, tmp)
        tmp.replace(path)  # resume never sees a torn file

    def restore(self, path) -> None:
        """Loads on the host and lets load_state_dict place the tensors:
        AdamW's step counts stay on the host, as a fresh optimizer keeps
        them (on the device, each update would read each one back). On a
        mesh the params and moments are sharded again."""
        state = torch.load(Path(path), map_location="cpu", weights_only=True)
        if self.mesh is None:
            self.model.load_state_dict(state["params"], strict=True)
            self.optim.opt.load_state_dict(state["opt_state"])
        else:
            self._restore_sharded(state["params"], state["opt_state"])
        self.step = int(state["step"])

    def _restore_sharded(self, params, opt_state) -> None:
        if sorted(params) != sorted(self.names):
            raise ValueError("the checkpoint's params are not this model's: "
                             f"{sorted(set(params) ^ set(self.names))[:4]}")
        shards = shard_params(params, self.mesh, self.num_heads)
        with torch.no_grad():
            for name in self.names:
                for master, t in zip(self.shards[name], shards[name]):
                    master.copy_(t)
        specs = param_specs(params)
        state, k = {}, 0
        for i, name in enumerate(self.names):
            n = len(self.shards[name])
            st = opt_state["state"].get(i)
            if st is not None:
                split = lambda t: ([t] if specs[name] is None else
                                   split_param(name, t, specs[name], self.mesh.tp,
                                               self.num_heads))
                moments = {key: split(v) for key, v in st.items() if key != "step"}
                for r in range(n):  # a step count of its own: AdamW adds to it in place
                    state[k + r] = {"step": st["step"].clone(),
                                    **{key: v[r].clone() for key, v in moments.items()}}
            k += n
        groups = [{**g, "params": list(range(k))} for g in opt_state["param_groups"]]
        self.optim.opt.load_state_dict({"state": state, "param_groups": groups})


def materialize(history) -> list:
    """Per-step metrics with device tensors -> floats (one sync at the end)."""
    return [{k: v if k == "step" else float(v) for k, v in m.items()} for m in history]
