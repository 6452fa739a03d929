"""IVF (inverted-file) dense pool: a sub-linear stage A.

Counterpart of `review_recommender_tpu/ops/ivf.py:59-274`:

  offline  spherical k-means over the corpus (topics/cluster.py) -> C
           centroids; each cluster's rows packed into fixed-size blocks of
           Mb rows (a cluster owns ceil(size / Mb) blocks, the last one
           padded);
  online   q @ centroids.T -> every block takes its centroid's score ->
           the `nprobe` best live blocks -> one gather of their rows ->
           q @ rows.T -> top-`pool`.

Scores of the scanned rows are exact (the same product and dtype as the
exact pool); only pool membership is approximate, and data-dependent,
which is why the engine measures pool recall at init
(`measure_pool_recall`). Dead blocks (no valid slot) never win a probe
slot; nprobe >= the block count is an exact scan; a pool longer than
nprobe * Mb is padded with -inf scores. `ivf_topk` takes a query (D,) or
a batch (B, D): the batch gathers (B, nprobe, Mb, D) rows once and scores
them with one batched product over views of that gather (no second copy).

The JAX package runs these products in XLA outside any Pallas kernel; here
they are library products too (torch.mm / torch.bmm, f32 results).
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from review_recommender_tpu_torch.ops.dense import NEG_INF, dense_topk, matmul_f32, stable_topk

logger = logging.getLogger(__name__)

IVF_KEYS = ("ivf_centroids", "ivf_blocks", "ivf_block_valid", "ivf_block_rows",
            "ivf_block_centroid")


@dataclasses.dataclass
class IVFIndex:
    """Host IVF layout (numpy). block_row_ids[b, i] is the corpus row at
    slot i of block b (0 where padded, masked by block_valid). `stats`
    holds the build's timings and fill."""

    centroids: np.ndarray  # (C, D) f32, unit rows
    block_row_ids: np.ndarray  # (NB, Mb) int32
    block_valid: np.ndarray  # (NB, Mb) bool
    block_centroid: np.ndarray  # (NB,) int32
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def n_blocks(self) -> int:
        return int(self.block_row_ids.shape[0])

    @property
    def block_rows(self) -> int:
        return int(self.block_row_ids.shape[1])


def auto_centroids(n_valid: int) -> int:
    """~4 * sqrt(N) centroids, clamped to [16, 65536]."""
    return int(np.clip(4.0 * np.sqrt(max(n_valid, 1)), 16, 65536))


def auto_block_rows(n_valid: int, n_centroids: int) -> int:
    """The power of two nearest the mean cluster size, clamped to [64, 1024]."""
    avg = max(n_valid / max(n_centroids, 1), 1.0)
    return int(np.clip(2 ** round(np.log2(avg)), 64, 1024))


def ivf_sizes(n_valid: int, n_centroids: int = 0, block_rows: int = 0) -> tuple[int, int]:
    """(C, Mb) that build_ivf chooses for n_valid rows (0 = auto)."""
    k = min(int(n_centroids) if n_centroids else auto_centroids(n_valid), max(n_valid, 1))
    mb = int(block_rows) if block_rows else auto_block_rows(n_valid, k)
    return k, mb


def ivf_footprint_bound(n_valid: int, dim: int, itemsize: int, n_centroids: int = 0,
                        block_rows: int = 0) -> int:
    """Most device bytes ivf_device_arrays can take for n_valid rows: the
    blocks hold at most N + C*(Mb - 1) slots (each cluster pads its last
    block by at most Mb - 1), each slot a row of `itemsize` values, a row
    id (int32) and a valid flag; plus the centroids and one centroid id
    (int64) per block."""
    k, mb = ivf_sizes(n_valid, n_centroids, block_rows)
    slots = n_valid + k * (mb - 1)
    n_blocks = slots // mb
    return slots * (dim * itemsize + 4 + 1) + n_blocks * 8 + k * dim * itemsize


def build_ivf(emb: np.ndarray, valid: np.ndarray, *, n_centroids: int = 0,
              block_rows: int = 0, kmeans_iters: int = 10, seed: int = 0,
              device="cuda") -> IVFIndex:
    """Train centroids over the valid rows of the padded corpus (N_pad, D)
    on `device` and pack each cluster's rows into blocks of Mb rows
    (auto-sized when 0). Padding rows are never placed in a block."""
    from review_recommender_tpu_torch.topics.cluster import spherical_kmeans

    emb = np.asarray(emb, dtype=np.float32)
    valid = np.asarray(valid, dtype=bool)
    rows = np.nonzero(valid)[0].astype(np.int32)
    if rows.size == 0:
        mb = max(int(block_rows), 1) if block_rows else 64
        return IVFIndex(centroids=np.zeros((1, emb.shape[1]), np.float32),
                        block_row_ids=np.zeros((1, mb), np.int32),
                        block_valid=np.zeros((1, mb), bool),
                        block_centroid=np.zeros(1, np.int32),
                        stats=dict(n_centroids=1, block_rows=mb, n_blocks=1, fill=0.0))
    k, mb = ivf_sizes(rows.size, n_centroids, block_rows)
    stats: dict = {}
    ids, centers = spherical_kmeans(emb[rows], k=k, iters=kmeans_iters, seed=seed,
                                    device=device, stats=stats)

    blk_rows: list = []
    blk_cent: list = []
    order = np.argsort(ids, kind="stable")
    sorted_ids, sorted_rows = ids[order], rows[order]
    starts = np.searchsorted(sorted_ids, np.arange(k))
    ends = np.searchsorted(sorted_ids, np.arange(k), side="right")
    for c in range(k):
        members = sorted_rows[starts[c] : ends[c]]
        for off in range(0, len(members), mb):
            blk_rows.append(members[off : off + mb])
            blk_cent.append(c)
    nb = len(blk_rows)
    row_ids = np.zeros((nb, mb), np.int32)
    bvalid = np.zeros((nb, mb), bool)
    for b, members in enumerate(blk_rows):
        row_ids[b, : len(members)] = members
        bvalid[b, : len(members)] = True
    stats.update(n_centroids=k, block_rows=mb, n_blocks=nb,
                 fill=float(bvalid.mean()) if nb else 0.0)
    logger.info("IVF: %d rows -> %d centroids, %d blocks x %d rows (fill %.0f%%)",
                rows.size, k, nb, mb, 100 * stats["fill"])
    return IVFIndex(centroids=np.asarray(centers, np.float32), block_row_ids=row_ids,
                    block_valid=bvalid, block_centroid=np.asarray(blk_cent, np.int32),
                    stats=stats)


def ivf_device_arrays(ivf: IVFIndex, emb: torch.Tensor) -> dict:
    """The tensors of ivf_topk on emb's device: the (NB, Mb, D) block tensor
    gathered from the placed corpus `emb` (its dtype), the centroids in that
    dtype, and the bookkeeping. Like the striped slices, a second copy of
    the corpus (plus block padding)."""
    dev = emb.device
    put = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=dev)
    row_ids = put(ivf.block_row_ids, torch.int32)
    return {
        "ivf_centroids": put(ivf.centroids, torch.float32).to(emb.dtype),
        "ivf_blocks": emb[row_ids.reshape(-1).long()].reshape(ivf.n_blocks, ivf.block_rows, -1),
        "ivf_block_valid": put(ivf.block_valid, torch.bool),
        "ivf_block_rows": row_ids,
        "ivf_block_centroid": put(ivf.block_centroid, torch.int64),
    }


def ivf_device_bytes(arrays: dict) -> int:
    """Device bytes of the ivf_* tensors in `arrays`."""
    return sum(arrays[k].numel() * arrays[k].element_size() for k in IVF_KEYS if k in arrays)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with an f32 result (ops/dense.py:matmul_f32's rule)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def ivf_topk(centroids: torch.Tensor, blocks: torch.Tensor, block_valid: torch.Tensor,
             block_row_ids: torch.Tensor, block_centroid: torch.Tensor, qvec: torch.Tensor,
             pool: int, nprobe: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-`pool` rows from the `nprobe` best blocks for qvec (D,) or
    (B, D). Returns (scores (..., pool) f32 descending, exact, -inf pad
    tail; rows (..., pool) int64 in the corpus row space, 0 where padded)."""
    nb, mb, d = blocks.shape
    np_ = min(int(nprobe), nb)
    q = qvec.reshape(-1, d)
    bsz = q.shape[0]
    cscores = matmul_f32(q.to(centroids.dtype), centroids.T)  # (B, C)
    bscores = cscores[:, block_centroid]  # (B, NB)
    bscores = torch.where(block_valid.any(dim=1), bscores, NEG_INF)
    _, bids = stable_topk(bscores, np_)  # (B, np)
    sub = blocks[bids].reshape(bsz, np_ * mb, d)  # the one gather
    sims = _bmm_f32(q.to(blocks.dtype)[:, None, :], sub.transpose(1, 2))[:, 0]  # (B, np*Mb)
    sims = torch.where(block_valid[bids].reshape(bsz, np_ * mb), sims, NEG_INF)
    kk = min(int(pool), np_ * mb)
    top, j = stable_topk(sims, kk)
    rows = torch.gather(block_row_ids[bids].reshape(bsz, np_ * mb).long(), 1, j)
    if kk < int(pool):  # keep the (pool,) contract
        top = torch.nn.functional.pad(top, (0, int(pool) - kk), value=NEG_INF)
        rows = torch.nn.functional.pad(rows, (0, int(pool) - kk))
    return top.reshape(*qvec.shape[:-1], -1), rows.reshape(*qvec.shape[:-1], -1)


def measure_pool_recall(emb: torch.Tensor, valid: torch.Tensor, dev: tuple, pool: int,
                        nprobe: int, n_queries: int = 16, seed: int = 0) -> float:
    """Mean fraction of the exact top-`pool` that the IVF probe recovers,
    with corpus rows (drawn by `default_rng(seed)`, as in the JAX package)
    as queries. dev: the ivf_device_arrays tensors in IVF_KEYS order."""
    rows = np.nonzero(valid.cpu().numpy())[0]
    if rows.size == 0:
        return 1.0
    rng = np.random.default_rng(seed)
    sel = rows[rng.integers(0, rows.size, min(n_queries, rows.size))]
    qv = emb[torch.from_numpy(sel).to(emb.device)].to(torch.float32)
    _, i_ref = dense_topk(emb, qv, valid, pool)
    _, i_ivf = ivf_topk(*dev, qv, pool, nprobe)
    i_ref, i_ivf = i_ref.cpu().numpy(), i_ivf.cpu().numpy()
    return float(np.mean([len(set(i_ref[i]) & set(i_ivf[i])) / max(i_ref.shape[1], 1)
                          for i in range(len(sel))]))
