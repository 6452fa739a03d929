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
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Union

import numpy as np
import torch

from review_recommender_tpu_torch.device import resolve_device
from review_recommender_tpu_torch.models.encoder import build_model

MESH_REFUSAL = ("training over a device mesh (param_specs, shard_params, mesh=) is not "
                "ported yet (ROADMAP Queue 1 item 12)")


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
        """Update `count` (0-based) from the parameters' .grad."""
        for p in self.params:  # optax updates (and decays) every leaf
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.max_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_norm))
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(count)
        self.opt.step()


class Trainer:
    """A model with f32 master weights on `device`, its optimizer and its
    step count. Subclasses define _loss(*batch) -> (loss, metric) and name
    the metric."""

    metric = "acc"

    def __init__(self, model: torch.nn.Module, params, tc, device, mesh=None):
        if mesh is not None:
            raise NotImplementedError(MESH_REFUSAL)
        self.tc = tc
        self.device = resolve_device(device)
        self.model = build_model(model, params, self.device).train()
        self.optim = AdamWClip(self.model.parameters(), tc)
        self.step = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The f32 weights as a state_dict (views of the live parameters)."""
        return self.model.state_dict()

    def _tensors(self, arrays):
        """The host batch on the device. A CUDA upload goes through pinned
        memory with non_blocking=True: a copy from pageable memory would
        wait for every kernel already queued, so each step would wait for
        the one before it."""
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.device.type != "cuda":
            return [t.to(self.device) for t in host]
        return [t.pin_memory().to(self.device, non_blocking=True) for t in host]

    def train_step_async(self, *batch) -> Dict:
        """One step; the metrics stay device tensors (no host sync), so a
        loop reads them only where it logs and at its end."""
        loss, metric = self._loss(*self._tensors(batch))
        self.optim.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(self.step)
        self.step += 1
        return {"loss": loss.detach(), self.metric: metric.detach(), "step": self.step}

    def train_step(self, *batch) -> Dict[str, float]:
        """One step; returns the metrics as floats (syncs with the device)."""
        m = self.train_step_async(*batch)
        return {k: v if k == "step" else float(v) for k, v in m.items()}

    def save(self, path) -> None:
        """Params, optimizer state and step, atomically (.tmp and rename)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        torch.save({"params": {k: v.detach().cpu() for k, v in self.params.items()},
                    "opt_state": self.optim.opt.state_dict(), "step": self.step}, tmp)
        tmp.replace(path)  # resume never sees a torn file

    def restore(self, path) -> None:
        """Loads on the host and lets load_state_dict place the tensors:
        AdamW's step counts stay on the host, as a fresh optimizer keeps
        them (on the device, each update would read each one back)."""
        state = torch.load(Path(path), map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["params"], strict=True)
        self.optim.opt.load_state_dict(state["opt_state"])
        self.step = int(state["step"])


def materialize(history) -> list:
    """Per-step metrics with device tensors -> floats (one sync at the end)."""
    return [{k: v if k == "step" else float(v) for k, v in m.items()} for m in history]
