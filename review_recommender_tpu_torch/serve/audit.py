"""Index-bundle audit: the deploy gate.

Counterpart of `review_recommender_tpu/serve/audit.py`, with its check
names: required files, manifest and schema version, review files,
checksums, the bundle loads (ProductIndex.validate), meta/array row
alignment, SKU uniqueness, unit embeddings, vocab/idf alignment, term ids
in range, invalid padding rows, review segments, and the device footprint
against the device's memory under EMB_DTYPE (int8: emb_q + emb_scale) and
DENSE_POOL_MODE (striped: one more corpus; ivf: the block tensor's worst
case, index/schema.py:footprint_total). It reads either bundle layout
(index/io.py): the port's numpy meta files or a JAX bundle's parquet.
The footprint is checked on `device` (on the CPU no limit applies), per
device over the MESH_SHARDS shards the CLI would place
(device.resolve_devices: capped to the CUDA devices present; a device's
load is the sum of its shards), and the report carries `mesh_shards` and
`per_device_bytes`, as JAX's does.

Returns a JSON-safe report whose `ok` gates deployment (the CLI's exit code).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from review_recommender_tpu_torch.config import config
from review_recommender_tpu_torch.device import resolve_devices
from review_recommender_tpu_torch.index import io
from review_recommender_tpu_torch.index.schema import (
    SCHEMA_VERSION,
    check_hbm_fit,
    footprint_total,
)

REQUIRED_FILES = ["manifest.json", "product_arrays.npz", "vocab.txt"]
_EMB_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _meta_file(src: Path, port_name: str, jax_name: str) -> str:
    """The meta file the bundle has (load_bundle's order), the port's name
    when it has neither."""
    return jax_name if (src / jax_name).exists() and not (src / port_name).exists() \
        else port_name


def audit_index_dir(index_dir, verify_checksums: bool = True, device="cuda") -> Dict:
    src = Path(index_dir)
    checks: List[Dict] = []
    ok = True

    def check(name: str, passed: bool, detail: str = "") -> bool:
        nonlocal ok
        checks.append({"check": name, "passed": bool(passed), "detail": detail})
        ok = ok and bool(passed)
        return bool(passed)

    required = REQUIRED_FILES + [_meta_file(src, io.PRODUCT_META, io.JAX_PRODUCT_META)]
    missing = [f for f in required if not (src / f).exists()]
    if not check("required_files", not missing, f"missing: {missing}"):
        return {"ok": False, "checks": checks}

    try:
        manifest = json.loads((src / "manifest.json").read_text())
        check("schema_version", manifest.get("schema_version", 0) <= SCHEMA_VERSION,
              f"v{manifest.get('schema_version')} (supported <= v{SCHEMA_VERSION})")
    except (OSError, ValueError) as e:
        check("manifest_parses", False, str(e))
        return {"ok": False, "checks": checks}

    if manifest.get("has_reviews"):
        rfiles = ["review_arrays.npz", _meta_file(src, io.REVIEW_META, io.JAX_REVIEW_META)]
        rmissing = [f for f in rfiles if not (src / f).exists()]
        check("review_files", not rmissing, f"missing: {rmissing}")

    if verify_checksums:
        bad = io.mismatched_files(src, manifest)
        check("checksums", not bad, f"mismatched: {bad}")

    try:
        bundle = io.load_bundle(src)  # runs ProductIndex.validate()
        p = bundle.products
        check("bundle_loads", True, f"{p.n_docs} docs")
    except Exception as e:  # noqa: BLE001 - the audit reports what any reader raised
        check("bundle_loads", False, f"{type(e).__name__}: {e}")
        return {"ok": False, "checks": checks}

    check("meta_alignment", len(p.skus) == p.n_docs == len(p.agg_texts),
          f"skus={len(p.skus)} texts={len(p.agg_texts)} n_docs={p.n_docs}")
    n_unique = len(set(p.skus))
    check("sku_uniqueness", n_unique == p.n_docs, f"{n_unique}/{p.n_docs} unique")
    norms = np.linalg.norm(p.emb[: p.n_docs], axis=1)
    nz = norms > 0
    check("embeddings_normalized",
          bool(np.allclose(norms[nz], 1.0, atol=1e-3)) if nz.any() else True,
          f"norm range [{norms.min(initial=0):.4f}, {norms.max(initial=0):.4f}]")
    check("vocab_idf_alignment", p.idf.shape[0] == len(p.vocab) + 1,
          f"idf={p.idf.shape[0]} vocab+1={len(p.vocab) + 1}")
    max_id = int(p.doc_terms.max(initial=0))
    check("term_ids_in_range", max_id <= len(p.vocab), f"max id {max_id} vocab {len(p.vocab)}")
    check("padding_invalid", not p.valid[p.n_docs:].any(), "padding rows must be invalid")

    if bundle.reviews is not None:
        r = bundle.reviews
        m = r.n_reviews_total
        seg = np.asarray(r.rev_product[:m])
        check("review_segments_in_range", bool(((seg >= 0) & (seg <= p.n_docs)).all()),
              f"seg range [{seg.min(initial=0)}, {seg.max(initial=0)}], "
              f"discard bucket = {p.n_docs}")
        check("review_meta_alignment", len(r.rev_texts) == m, f"texts={len(r.rev_texts)} n={m}")

    footprint = {"emb_dtype": config.EMB_DTYPE, "dense_pool_mode": config.DENSE_POOL_MODE}
    int8 = config.EMB_DTYPE == "int8"
    dtype = torch.bfloat16 if int8 else _EMB_DTYPES.get(config.EMB_DTYPE)
    if dtype is None:
        check("hbm_fit", False, f"unsupported EMB_DTYPE={config.EMB_DTYPE}")
    else:
        pool = config.resolve_pool_mode(config.DENSE_POOL_MODE, p.n_padded)
        fp, total = footprint_total(bundle, dtype, quantize_int8=int8,
                                    striped=pool == "striped", ivf=pool == "ivf",
                                    ivf_centroids=config.IVF_CENTROIDS,
                                    ivf_block_rows=config.IVF_BLOCK_ROWS)
        shard_devices = resolve_devices(None, max(config.MESH_SHARDS, 1), device)
        fit = check_hbm_fit(total, shard_devices)
        check("hbm_fit", fit["fits"],
              f"{fit['per_device_bytes'] / 2**20:.1f} MiB/device on {device} "
              f"({len(shard_devices)} shards)"
              + (f" of {fit['limit_bytes'] / 2**20:.0f} MiB ({100 * fit['frac']:.1f}%)"
                 if fit["limit_bytes"] else " (no device memory limit)"))
        footprint.update(
            mesh_shards=config.MESH_SHARDS,
            bytes_per_array={k: int(v) for k, v in sorted(fp.items(), key=lambda kv: -kv[1])},
            total_bytes=int(total), per_device_bytes=fit["per_device_bytes"],
            hbm_limit_bytes=fit["limit_bytes"])

    return {
        "ok": ok,
        "n_docs": p.n_docs,
        "vocab_size": len(p.vocab),
        "has_reviews": bundle.reviews is not None,
        "device_footprint": footprint,
        "checks": checks,
    }
