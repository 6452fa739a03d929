"""Versioned index-bundle IO, on numpy and the standard library.

Layout of a bundle directory written by `save_bundle`:

  manifest.json        schema version, counts, dims, build params, the
                       sha256 of every other file ("checksums")
  product_arrays.npz   the ProductIndex arrays + idf/df
  product_meta.npz     host columns: sku and agg_text as UTF-8 bytes
                       (`<col>_utf8` uint8) with int64 offsets
                       (`<col>_offsets`, n + 1 of them), last_ts as
                       strings with a null mask (`last_ts_null`) when the
                       index has it
  vocab.txt            one term per line, line i = term id i + 1
  review_arrays.npz    (with reviews) the ReviewIndex arrays
  review_meta.npz      (with reviews) text as UTF-8 + offsets, stars f32

The manifest, the array files and vocab.txt are those of the JAX package
(`review_recommender_tpu/index/io.py`), key for key. Its host columns are
parquet files (`product_meta.parquet`, `review_meta.parquet`), which need
pandas or pyarrow, and the card's machine has neither. `load_bundle` reads
either layout, deciding by which meta file exists: the port's on any
machine, a JAX bundle's parquet only where pyarrow imports (else it raises
and names the reader). `python -m review_recommender_tpu_torch.index.io
convert SRC DST` rewrites a JAX bundle into this layout on a machine with
pyarrow. Remote paths (hf://, s3://, ...) raise: fsspec is not on the
card's machine (ROADMAP Queue 1 item 18).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import logging
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from review_recommender_tpu_torch.index.schema import (
    SCHEMA_VERSION,
    IndexBundle,
    ProductIndex,
    ReviewIndex,
)

logger = logging.getLogger(__name__)

PRODUCT_META = "product_meta.npz"
REVIEW_META = "review_meta.npz"
JAX_PRODUCT_META = "product_meta.parquet"
JAX_REVIEW_META = "review_meta.parquet"


def is_remote(path) -> bool:
    """True for fsspec-style URLs (hf://, s3://, gs://, memory://...)."""
    return "://" in str(path)


def _local(path) -> Path:
    if is_remote(path):
        raise ValueError(f"remote bundle {path}: the port reads local directories only "
                         "(fsspec is not installed on the card's machine; ROADMAP Queue 1 "
                         "item 18)")
    return Path(path)


def _sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _pack_strings(name: str, strings: Sequence[str]) -> Dict[str, np.ndarray]:
    """{name_utf8: uint8 bytes, name_offsets: int64 (n + 1,)}."""
    enc = [s.encode("utf-8") for s in strings]
    offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offsets[1:])
    return {f"{name}_utf8": np.frombuffer(b"".join(enc), np.uint8),
            f"{name}_offsets": offsets}


def _unpack_strings(arrs, name: str) -> List[str]:
    raw = arrs[f"{name}_utf8"].tobytes()
    off = arrs[f"{name}_offsets"].tolist()
    return [raw[a:b].decode("utf-8") for a, b in zip(off[:-1], off[1:])]


def save_bundle(bundle: IndexBundle, out_dir) -> Path:
    """Write `bundle` to `out_dir` in the port's layout; returns the path."""
    out = _local(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    p = bundle.products
    arrays = dict(emb=p.emb, n_reviews=p.n_reviews, avg_stars=p.avg_stars,
                  doc_terms=p.doc_terms, doc_tf=p.doc_tf, doc_len=p.doc_len,
                  gate_bits=p.gate_bits, valid=p.valid, idf=p.idf, df=p.df)
    if p.doc_tokens is not None:
        arrays["doc_tokens"] = p.doc_tokens
        arrays["doc_token_len"] = p.doc_token_len
    if p.doc_bm25 is not None:
        arrays["doc_bm25"] = p.doc_bm25
    np.savez_compressed(out / "product_arrays.npz", **arrays)
    meta = {**_pack_strings("sku", [str(s) for s in p.skus]),
            **_pack_strings("agg_text", [str(t) for t in p.agg_texts])}
    if p.last_ts is not None:
        meta.update(_pack_strings("last_ts", ["" if t is None else str(t) for t in p.last_ts]))
        meta["last_ts_null"] = np.asarray([t is None for t in p.last_ts], bool)
    np.savez_compressed(out / PRODUCT_META, **meta)
    with open(out / "vocab.txt", "w", encoding="utf-8") as f:
        for term, _tid in sorted(p.vocab.items(), key=lambda kv: kv[1]):
            f.write(term + "\n")
    files = ["product_arrays.npz", PRODUCT_META, "vocab.txt"]

    if bundle.reviews is not None:
        r = bundle.reviews
        np.savez_compressed(out / "review_arrays.npz", rev_emb=r.rev_emb,
                            rev_product=r.rev_product, rev_valid=r.rev_valid)
        np.savez_compressed(out / REVIEW_META,
                            **_pack_strings("text", [str(t) for t in r.rev_texts]),
                            stars=np.asarray(r.rev_stars, np.float32))
        files += ["review_arrays.npz", REVIEW_META]

    manifest = {
        "schema_version": bundle.version,
        "n_docs": p.n_docs,
        "n_padded": p.n_padded,
        "dim": p.dim,
        "terms_cap": p.terms_cap,
        "vocab_size": len(p.vocab),
        "avgdl": p.avgdl,
        "has_reviews": bundle.reviews is not None,
        "n_reviews_total": bundle.reviews.n_reviews_total if bundle.reviews else 0,
        "meta": bundle.meta,
        "checksums": {f: _sha256(out / f) for f in files},
    }
    with open(out / "manifest.json", "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2)
    logger.info("wrote index bundle to %s (%d docs)", out, p.n_docs)
    return out


def _read_parquet(path: Path, columns: Sequence[str]) -> Dict[str, list]:
    """Columns of a JAX bundle's parquet meta file, as Python lists."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise RuntimeError(
            f"{path} is a JAX-package bundle's parquet meta file, and reading it needs "
            "pyarrow, which is not installed here. Convert the bundle on a machine with "
            "pyarrow: python -m review_recommender_tpu_torch.index.io convert SRC DST") from e
    table = pq.read_table(path)
    return {c: table.column(c).to_pylist() for c in columns if c in table.column_names}


def _ts(t) -> Optional[str]:
    return None if t is None or (isinstance(t, float) and math.isnan(t)) else str(t)


def _product_meta(src: Path) -> tuple:
    """(skus, agg_texts, last_ts or None) from whichever meta file exists."""
    if (src / PRODUCT_META).exists():
        with np.load(src / PRODUCT_META) as m:
            last_ts = None
            if "last_ts_null" in m.files:
                last_ts = [None if null else t for t, null in
                           zip(_unpack_strings(m, "last_ts"), m["last_ts_null"].tolist())]
            return _unpack_strings(m, "sku"), _unpack_strings(m, "agg_text"), last_ts
    if (src / JAX_PRODUCT_META).exists():
        cols = _read_parquet(src / JAX_PRODUCT_META, ("sku", "agg_text", "last_ts"))
        last_ts = [_ts(t) for t in cols["last_ts"]] if "last_ts" in cols else None
        return ([str(s) for s in cols["sku"]], [str(t) for t in cols["agg_text"]], last_ts)
    raise FileNotFoundError(f"{src}: neither {PRODUCT_META} nor {JAX_PRODUCT_META}")


def _review_meta(src: Path) -> tuple:
    """(texts, stars f32) from whichever review meta file exists."""
    if (src / REVIEW_META).exists():
        with np.load(src / REVIEW_META) as m:
            return _unpack_strings(m, "text"), np.asarray(m["stars"], np.float32)
    if (src / JAX_REVIEW_META).exists():
        cols = _read_parquet(src / JAX_REVIEW_META, ("text", "stars"))
        stars = np.asarray([np.nan if s is None else s for s in cols["stars"]], np.float32)
        return [str(t) for t in cols["text"]], stars
    raise FileNotFoundError(f"{src}: neither {REVIEW_META} nor {JAX_REVIEW_META}")


def mismatched_files(src, manifest: dict) -> List[str]:
    """The files of the manifest's checksums whose sha256 differs (a
    missing file is left to the reader that needs it)."""
    src = Path(src)
    return [f for f, want in manifest.get("checksums", {}).items()
            if (src / f).exists() and _sha256(src / f) != want]


def load_bundle(in_dir, verify_checksums: bool = False) -> IndexBundle:
    """Read a bundle directory of either layout (see the module docstring)."""
    src = _local(in_dir)
    with open(src / "manifest.json", encoding="utf-8") as fh:
        manifest = json.load(fh)
    if manifest["schema_version"] > SCHEMA_VERSION:
        raise ValueError(f"index bundle schema v{manifest['schema_version']} is newer than "
                         f"supported v{SCHEMA_VERSION}")
    if verify_checksums:
        bad = mismatched_files(src, manifest)
        if bad:
            raise ValueError(f"checksum mismatch for {', '.join(bad)}")

    with np.load(src / "product_arrays.npz") as fh:
        arrs = dict(fh)
    skus, agg_texts, last_ts = _product_meta(src)
    with open(src / "vocab.txt", encoding="utf-8") as fh:
        vocab = {line.rstrip("\n"): i + 1 for i, line in enumerate(fh) if line}
    p = ProductIndex(
        emb=arrs["emb"], n_reviews=arrs["n_reviews"], avg_stars=arrs["avg_stars"],
        doc_terms=arrs["doc_terms"], doc_tf=arrs["doc_tf"], doc_len=arrs["doc_len"],
        gate_bits=arrs["gate_bits"], valid=arrs["valid"], skus=skus, agg_texts=agg_texts,
        vocab=vocab, idf=arrs["idf"], df=arrs["df"], avgdl=float(manifest["avgdl"]),
        n_docs=int(manifest["n_docs"]), doc_tokens=arrs.get("doc_tokens"),
        doc_token_len=arrs.get("doc_token_len"), doc_bm25=arrs.get("doc_bm25"),
        last_ts=last_ts,
    )
    p.validate()

    reviews: Optional[ReviewIndex] = None
    if manifest.get("has_reviews"):
        with np.load(src / "review_arrays.npz") as fh:
            rarrs = dict(fh)
        texts, stars = _review_meta(src)
        reviews = ReviewIndex(rev_emb=rarrs["rev_emb"], rev_product=rarrs["rev_product"],
                              rev_valid=rarrs["rev_valid"], rev_texts=texts, rev_stars=stars,
                              n_reviews_total=int(manifest["n_reviews_total"]))
    return IndexBundle(products=p, reviews=reviews, version=int(manifest["schema_version"]),
                       meta=manifest.get("meta", {}))


def convert(src, dst) -> Path:
    """Rewrite the bundle at `src` (either layout; checksums verified) into
    the port's layout at `dst`."""
    return save_bundle(load_bundle(src, verify_checksums=True), dst)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m review_recommender_tpu_torch.index.io",
                                 description="index bundle tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert", help="rewrite a bundle (a JAX-package bundle's parquet "
                                       "meta included) in the port's numpy-only layout")
    c.add_argument("src")
    c.add_argument("dst")
    args = ap.parse_args(argv)
    out = convert(args.src, args.dst)
    print(json.dumps({"converted": str(args.src), "out": str(out)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
