"""Density clustering of review embeddings: an exact cosine kNN graph on
the card, then core / border / noise rules and a union-find on the host.

Counterpart of `review_recommender_tpu/topics/density.py` (`_knn_block`
:49, `knn_graph` :83, `_UnionFind` :217, `density_cluster` :238), which
gives the topic pipeline HDBSCAN's output semantics: a data-derived
cluster count, the noise label -1, min_cluster_size dissolving runts.

The graph is the O(N^2 D) part. Each block of `batch_rows` rows is scored
against the corpus in column chunks of `col_chunk` rows, one (B, D) x
(D, C) f32 product per chunk (a library matmul, as in JAX, where it is
XLA and not a Pallas kernel; TF32 is off for it), and a running top-k is
merged chunk by chunk. The selection keeps `lax.top_k`'s order: value
descending, and among equal values the lower column first. `torch.topk`
promises no order among ties, so each similarity is turned into an int64
key that orders (value desc, column asc) with no ties at all: the f32 bits
mapped to an order-preserving int32 (-0.0 folded into +0.0 first) in the
high word, 2^31 - 1 - column in the low word. A top-k of distinct keys is
exact on any device. The JAX code pads the corpus to whole chunks and
masks pad columns to -inf inside the loop; here the last chunk is cut
short instead, so no pad column exists to displace a real neighbour.

The host stages copy the JAX code operation for operation: the self
strip (a row whose self lost the tie-break among more than k duplicates
drops its last column), eps as `np.quantile` of the finite core distances
(default interpolation), mutual-core edges, the union-find loop, border
adoption and the size-descending renumbering.

`knn_graph_sharded` (JAX `:126-223`) splits the corpus rows over a list
of devices (a device may repeat), and `knn_graph` is its one-shard case:
each shard scores the row block (a view of a shard on its device that
holds the block, else a copy from the host) against its own rows, keeps a local top-k by the
same keys, and the lead device (shard 0's) merges the shards' keys. A
shard holds exactly its rows, so no pad row exists to mask (JAX masks
the last shard's pad rows to -inf inside the program). The keys order
every candidate, so the merge picks what the one-device graph picks;
only the f32 sums may round apart, as the products' shapes differ.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from review_recommender_tpu_torch.device import resolve_devices
from review_recommender_tpu_torch.ops.dense import matmul_f32

_LOW = 2**31 - 1  # low word of a key: _LOW - column, so lower columns rank first


@contextlib.contextmanager
def _ieee_f32_matmul():
    """CUDA f32 products in full precision (TF32 off) for the graph,
    whatever the caller's process set; its setting is restored after. Only
    the CUDA matmul switch of the current API (`fp32_precision`) is read
    and written: it reflects a legacy `allow_tf32` too, where reading the
    legacy switch or the process-wide getter raises once a caller has
    mixed the two APIs."""
    cuda_mm = torch.backends.cuda.matmul
    prev = cuda_mm.fp32_precision
    cuda_mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        cuda_mm.fp32_precision = prev


def _order_keys(vals: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys ordering (value desc, column asc) with no ties: vals f32
    (B, C), cols int64 broadcastable to it, each in [-1, 2^31 - 1)."""
    bits = (vals + 0.0).view(torch.int32)  # + 0.0 folds -0.0 into +0.0
    mono = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # order-preserving int32
    return (mono.to(torch.int64) << 32) | (_LOW - cols)


def _from_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals f32, cols int64) back from _order_keys."""
    mono = (keys >> 32).to(torch.int32)
    vals = (mono ^ ((mono >> 31) & 0x7FFFFFFF)).view(torch.float32)
    return vals, _LOW - (keys & 0xFFFFFFFF)


def _knn_block(emb: torch.Tensor, block: torch.Tensor, k: int, chunk: int):
    """Top-k cosine neighbours of `block` (B, D) among the rows of `emb`
    (N, D): (vals (B, k) f32 desc, idx (B, k) int64), merged chunk by chunk
    over columns. A row with fewer than k finite similarities carries
    (-inf, -1) tails."""
    b, n = block.shape[0], emb.shape[0]
    best = _order_keys(torch.full((b, k), float("-inf"), device=block.device),
                       torch.full((1, k), -1, dtype=torch.int64, device=block.device))
    for lo in range(0, n, chunk):
        sims = matmul_f32(block, emb[lo : lo + chunk].T)  # (B, <= chunk)
        cols = torch.arange(lo, lo + sims.shape[1], device=block.device)
        top = torch.topk(_order_keys(sims, cols), min(k, sims.shape[1]), dim=1).values
        best = torch.topk(torch.cat([best, top], dim=1), k, dim=1).values  # sorted desc
    vals, idx = _from_keys(best)
    return vals, torch.where(torch.isfinite(vals), idx, -1)


def knn_graph(embeddings: np.ndarray, k: int = 16, batch_rows: int = 1024,
              col_chunk: int = 32768, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Exact cosine kNN graph of the (L2-normalised here) embeddings on
    `device`: (sims (N, min(k, N)) f32, idx int32), each row sorted by
    descending similarity and including the row itself (callers strip
    it). The one-shard case of knn_graph_sharded."""
    return knn_graph_sharded(embeddings, k, devices=[device], batch_rows=batch_rows,
                             col_chunk=col_chunk)


def knn_graph_sharded(embeddings: np.ndarray, k: int = 16, devices: Optional[Sequence] = None,
                      n_shards: Optional[int] = None, batch_rows: int = 1024,
                      col_chunk: int = 32768, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """knn_graph with the corpus rows split over `devices`, or `n_shards`
    shards on `device`'s type (device.resolve_devices; n_shards None takes
    every CUDA device): shard s holds rows [s*per, (s+1)*per), per =
    ceil(N / n). Per row block, each shard's local top-k (global columns)
    by order keys, merged on the lead device. Returns knn_graph's (sims,
    idx)."""
    devices = resolve_devices(devices, n_shards, device)
    emb = np.asarray(embeddings, np.float32)
    n = emb.shape[0]
    if n == 0:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    k_eff = min(k, n)
    per = -(-n // len(devices))
    lead = devices[0]
    shards = [(lo, torch.from_numpy(emb[lo:lo + per]).to(dev))
              for lo, dev in zip(range(0, n, per), devices)]

    def block_on(dev, lo, hi):
        """Rows [lo, hi) on `dev`: a view of a shard there that holds them
        all, else a copy from the host (no device holds more than its
        shards and a block)."""
        for off, rows in shards:
            if rows.device == dev and off <= lo and hi <= off + rows.shape[0]:
                return rows[lo - off:hi - off]
        return torch.from_numpy(emb[lo:hi]).to(dev)

    sims = torch.empty((n, k_eff), dtype=torch.float32, device=lead)
    idx = torch.empty((n, k_eff), dtype=torch.int64, device=lead)
    with _ieee_f32_matmul():
        for lo in range(0, n, batch_rows):
            hi = min(lo + batch_rows, n)
            blocks = {}
            keys = []
            for off, rows in shards:
                dev = rows.device
                if dev not in blocks:
                    blocks[dev] = block_on(dev, lo, hi)
                v, i = _knn_block(rows, blocks[dev], min(k_eff, rows.shape[0]), col_chunk)
                keys.append(_order_keys(v, torch.where(i >= 0, i + off, -1)).to(lead))
            v, i = _from_keys(torch.topk(torch.cat(keys, dim=1), k_eff, dim=1).values)
            sims[lo:hi], idx[lo:hi] = v, torch.where(torch.isfinite(v), i, -1)
    return sims.cpu().numpy(), idx.to(torch.int32).cpu().numpy()


class _UnionFind:
    __slots__ = ("parent",)

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:  # path compression
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def density_cluster(embeddings: np.ndarray, min_samples: int = 10, min_cluster_size: int = 40,
                    knn: int = 16, eps: Optional[float] = None, eps_quantile: float = 0.60,
                    batch_rows: int = 1024, col_chunk: int = 32768,
                    n_shards: Optional[int] = None, devices: Optional[Sequence] = None,
                    device="cuda", stats: Optional[dict] = None) -> Tuple[np.ndarray, dict]:
    """Density clustering with HDBSCAN's output semantics: (labels (N,)
    int32, -1 = noise, clusters numbered 0.. by descending size; info with
    n_clusters, noise, eps, core_points). The kNN graph runs on `device`,
    or, with `devices` or n_shards > 1, sharded (knn_graph_sharded); the
    host stages are the same. `stats`, when given, receives the seconds of
    each stage: graph, union_find (edges and roots), border (adoption),
    renumber."""
    emb = np.asarray(embeddings, np.float32)
    n = len(emb)
    if n == 0:
        return np.zeros(0, np.int32), {"n_clusters": 0, "noise": 0, "eps": 0.0}

    t0 = time.perf_counter()
    k_graph = min(max(knn, min_samples) + 1, n)  # +1: self column
    if devices is None and (n_shards or 1) <= 1:
        devices = [device]
    sims, idx = knn_graph_sharded(emb, k=k_graph, devices=devices, n_shards=n_shards,
                                  batch_rows=batch_rows, col_chunk=col_chunk, device=device)
    t_graph = time.perf_counter()

    # strip ONE column per row: the self column where present; a row whose
    # self lost the tie-break among > k_graph exact duplicates drops its last
    is_self = idx == np.arange(n)[:, None]
    drop_col = np.where(is_self.any(axis=1), is_self.argmax(axis=1), k_graph - 1)
    keep = np.ones_like(idx, bool)
    keep[np.arange(n), drop_col] = False
    sims = sims[keep].reshape(n, k_graph - 1)
    idx = idx[keep].reshape(n, k_graph - 1)

    if sims.shape[1] == 0:  # a 1-row corpus: no neighbours, all noise
        return np.full(n, -1, np.int32), {"n_clusters": 0, "noise": n, "eps": 0.0,
                                          "core_points": 0}

    ms = min(min_samples, sims.shape[1])
    core_dist = 1.0 - sims[:, ms - 1]  # distance to the min_samples-th neighbour
    if eps is None:
        finite = core_dist[np.isfinite(core_dist)]
        if len(finite) == 0:  # fewer than min_samples real neighbours anywhere
            return np.full(n, -1, np.int32), {"n_clusters": 0, "noise": n, "eps": 0.0,
                                              "core_points": 0}
        eps = float(np.quantile(finite, eps_quantile))
    is_core = core_dist <= eps

    # mutual-core edges within eps (exact kNN and one eps: no reverse lookup)
    src = np.repeat(np.arange(n), idx.shape[1])
    dst = idx.ravel()
    s = sims.ravel()
    m = is_core[src] & is_core[dst] & (s >= 1.0 - eps) & (dst >= 0)
    uf = _UnionFind(n)
    for a, b in zip(src[m], dst[m]):
        uf.union(int(a), int(b))
    labels = np.full(n, -1, np.int32)
    roots = {}
    for i in np.flatnonzero(is_core):
        r = uf.find(int(i))
        labels[i] = roots.setdefault(r, len(roots))
    t_uf = time.perf_counter()

    # border adoption: a non-core point joins its best core neighbour within eps
    for i in np.flatnonzero(~is_core):
        row_idx, row_sim = idx[i], sims[i]
        ok = is_core[row_idx] & (row_sim >= 1.0 - eps)
        if ok.any():
            labels[i] = labels[row_idx[np.argmax(np.where(ok, row_sim, -np.inf))]]
    t_border = time.perf_counter()

    # dissolve runts into noise, renumber by size desc
    lab, counts = np.unique(labels[labels >= 0], return_counts=True)
    keep_ids = lab[counts >= min_cluster_size]
    order = keep_ids[np.argsort(-counts[counts >= min_cluster_size], kind="stable")]
    remap = np.full(labels.max() + 2 if len(lab) else 1, -1, np.int32)
    for newid, old in enumerate(order):
        remap[old] = newid
    labels = np.where(labels >= 0, remap[np.maximum(labels, 0)], -1)
    if stats is not None:
        stats.update(graph_s=t_graph - t0, union_find_s=t_uf - t_graph,
                     border_s=t_border - t_uf, renumber_s=time.perf_counter() - t_border,
                     edges=int(m.sum()))
    return labels.astype(np.int32), {
        "n_clusters": int(len(order)),
        "noise": int((labels == -1).sum()),
        "eps": float(eps),
        "core_points": int(is_core.sum()),
    }
