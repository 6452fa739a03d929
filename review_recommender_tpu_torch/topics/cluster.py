"""Mini-batched spherical k-means on the engine's device.

Counterpart of `review_recommender_tpu/topics/cluster.py:25-105`
(`_assign`, `spherical_kmeans`); its `kmeans_sanity` belongs to the topic
tooling and is not ported yet. The farthest-point seeding is the JAX
package's numpy code, so it draws the same `default_rng(seed)` stream and
picks the same seeds. Assignment and update run in f32 torch on `device`:
one (rows, D) x (D, k) product per mini-batch (TF32 off, ops/dense.py:
matmul_f32), then per-center counts and sums by scatter-add. Summation
order differs from the JAX one-hot product, so centers agree to f32
rounding and an id can differ only where a row's two best similarities
are that close.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from review_recommender_tpu_torch.device import resolve_device
from review_recommender_tpu_torch.ops.dense import matmul_f32


def _assign(emb: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor, k: int):
    """Cosine assignment of one mini-batch: ids (rows,) (k for padding
    rows), counts (k,), sums (k, D) and the largest valid similarity."""
    sims = matmul_f32(emb, centers.T)
    ids = torch.where(valid, sims.argmax(dim=1), k)
    counts = torch.bincount(ids, minlength=k + 1)[:k].to(torch.float32)
    sums = torch.zeros(k + 1, emb.shape[1], dtype=torch.float32, device=emb.device)
    sums.index_add_(0, ids, emb.to(torch.float32))
    best = torch.where(valid, sims.amax(dim=1), 0.0).amax()
    return ids, counts, sums[:k], best


def farthest_point_seeds(emb: np.ndarray, k: int, rng) -> np.ndarray:
    """(k, D) initial centers: farthest-point seeding on a subsample of at
    most 20,000 rows, padded with jittered copies when too few rows."""
    n = emb.shape[0]
    pool_idx = rng.choice(n, size=min(n, 20000), replace=False) if n > 20000 else np.arange(n)
    pool = emb[pool_idx]
    chosen = [int(rng.integers(0, len(pool)))]
    max_sim = pool @ pool[chosen[0]]
    while len(chosen) < min(k, len(pool)):
        nxt = int(np.argmin(max_sim))
        chosen.append(nxt)
        max_sim = np.maximum(max_sim, pool @ pool[nxt])
    centers = pool[chosen]
    if len(centers) < k:  # degenerate tiny input: pad with jitter
        extra = centers[rng.integers(0, len(centers), k - len(centers))]
        centers = np.concatenate([centers, extra + 1e-3])
    return centers


def spherical_kmeans(embeddings: np.ndarray, k: int = 60, iters: int = 25,
                     batch_rows: int = 65536, seed: int = 0, tol: float = 1e-4,
                     device="cuda", stats: Optional[dict] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster embeddings (rows L2-normalised here). Returns (ids (N,)
    int32, centers (k, D) f32 unit rows). `stats`, when given, receives the
    seeding and iteration seconds and the iterations run."""
    device = resolve_device(device)
    emb = np.asarray(embeddings, dtype=np.float32)
    n, d = emb.shape
    if n == 0:
        return np.zeros(0, np.int32), np.zeros((k, d), np.float32)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    centers = torch.from_numpy(farthest_point_seeds(emb, k, rng)).to(device)
    t1 = time.perf_counter()

    pad = (-n) % batch_rows
    emb_p = torch.from_numpy(np.pad(emb, [(0, pad), (0, 0)])).to(device)
    valid_p = torch.arange(n + pad, device=device) < n
    blocks = [(emb_p[i : i + batch_rows], valid_p[i : i + batch_rows])
              for i in range(0, n + pad, batch_rows)]

    prev = -np.inf
    it = 0
    for it in range(1, iters + 1):
        counts = torch.zeros(k, dtype=torch.float32, device=device)
        sums = torch.zeros(k, d, dtype=torch.float32, device=device)
        obj = 0.0
        for be, bv in blocks:
            _ids, c, s, best = _assign(be, centers, bv, k)
            counts = counts + c
            sums = sums + s
            obj += float(best)
        newc = sums / torch.clamp(counts[:, None], min=1.0)
        newc = newc / torch.clamp(torch.linalg.norm(newc, dim=1, keepdim=True), min=1e-12)
        centers = torch.where(counts[:, None] > 0, newc, centers)  # dead centers stay
        if abs(obj - prev) < tol * max(abs(prev), 1.0):
            break
        prev = obj

    ids_out = torch.cat([_assign(be, centers, bv, k)[0] for be, bv in blocks])
    if stats is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats.update(seed_s=t1 - t0, iters_s=time.perf_counter() - t1, iters=it)
    return ids_out[:n].to(torch.int32).cpu().numpy(), centers.cpu().numpy()
