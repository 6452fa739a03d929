"""Sharded batch embedding job with checkpoint and resume.

Counterpart of `review_recommender_tpu/data/embed_job.py`: texts are
encoded in shards of `shard_rows` (cut at `char_cap` characters) by
`encoder.encode(chunk, batch_size=256)` (on the card, the port's BiEncoder,
whose forward runs the attention kernel of csrc/mha_fwd.cu); each finished
shard is written to a temp file and renamed, so a killed job resumes at
the first missing shard. A `job.json` manifest records the row and shard
counts; a manifest for other counts restarts the job.

For an offline build over several devices, construct the encoder with a
device list (`BiEncoder(..., devices=["cuda:0", "cuda:1", ...])`, the
JAX package's `BiEncoder(mesh=...)`): each batch splits into one equal
slice a device, pure data parallelism.

`job_status` counts only complete shard files (`emb_shard_NNNNN.npy`). The
JAX function's glob also matches the temp name `emb_shard_NNNNN.tmp.npy`
that a killed job leaves and raises on it (ROADMAP Queue 3); here such a
shard is reported missing.
"""
from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import List, Sequence

import numpy as np

logger = logging.getLogger(__name__)

SHARD_ROWS = 20_000
_SHARD_NAME = re.compile(r"emb_shard_(\d{5})\.npy\Z")


def _shard_path(out_dir: Path, i: int) -> Path:
    return out_dir / f"emb_shard_{i:05d}.npy"


def run_embed_job(
    texts: Sequence[str],
    encoder,  # models.encoder.BiEncoder (or any .encode(texts)->np.ndarray)
    out_dir: str | Path,
    *,
    shard_rows: int = SHARD_ROWS,
    batch_size: int = 256,
    resume: bool = True,
    char_cap: int = 4000,
) -> np.ndarray:
    """Encode texts shard by shard; returns the (N, D) matrix.

    Layout in out_dir: emb_shard_XXXXX.npy per shard + job.json manifest.
    Resume skips shards whose file already exists with the right row count.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = len(texts)
    n_shards = -(-n // shard_rows) if n else 0

    manifest_path = out / "job.json"
    manifest = {"n_rows": n, "shard_rows": shard_rows, "n_shards": n_shards}
    if manifest_path.exists() and resume:
        old = json.loads(manifest_path.read_text())
        if old.get("n_rows") != n or old.get("shard_rows") != shard_rows:
            logger.warning("job manifest mismatch (%s vs %s) — restarting", old, manifest)
            resume = False
    manifest_path.write_text(json.dumps(manifest))

    parts: List[np.ndarray] = []
    for si in range(n_shards):
        lo, hi = si * shard_rows, min((si + 1) * shard_rows, n)
        path = _shard_path(out, si)
        if resume and path.exists():
            arr = np.load(path)
            if arr.shape[0] == hi - lo:
                logger.info("shard %d/%d: resume hit (%d rows)", si + 1, n_shards, arr.shape[0])
                parts.append(arr)
                continue
        chunk = [str(t)[:char_cap] for t in texts[lo:hi]]
        arr = encoder.encode(chunk, batch_size=batch_size)
        tmp = path.with_suffix(".tmp.npy")
        np.save(tmp, arr)
        tmp.replace(path)  # atomic flush: resume never sees a torn shard
        logger.info("shard %d/%d: encoded %d rows", si + 1, n_shards, len(chunk))
        parts.append(arr)

    if not parts:
        cfg = getattr(encoder, "cfg", None)
        return np.zeros((0, cfg.hidden_size if cfg else 0), np.float32)
    return np.concatenate(parts, axis=0)


def job_status(out_dir: str | Path) -> dict:
    """Resume status: the manifest's shard count, the complete shards and
    the indices of the missing ones."""
    out = Path(out_dir)
    if not (out / "job.json").exists():
        return {"started": False}
    manifest = json.loads((out / "job.json").read_text())
    done = {int(m.group(1)) for m in map(_SHARD_NAME.match, (p.name for p in out.iterdir()))
            if m}
    missing = [i for i in range(manifest["n_shards"]) if i not in done]
    return {
        "started": True,
        "n_shards": manifest["n_shards"],
        "done_shards": len(done),
        "complete": len(done) == manifest["n_shards"],
        "missing": missing,
    }
