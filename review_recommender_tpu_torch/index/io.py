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
pyarrow. `load_bundle` also reads a bundle at an fsspec URL (hf://, s3://,
memory://, ...) where fsspec imports, as the JAX one does; where it does
not (the card's machine), a remote path raises and names the way round.
Bundles are written to local directories only, as in JAX.
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


def join_path(base, name: str) -> str:
    """base / name, keeping a URL's scheme (Path() collapses "hf://")."""
    b = str(base)
    if is_remote(b):
        return b.rstrip("/") + "/" + name
    return str(Path(b) / name)


def _fsspec(path):
    try:
        import fsspec
    except ImportError as e:
        raise RuntimeError(
            f"{path} is a remote path, and reading it needs fsspec, which is not installed "
            "here: copy the files to a local directory first") from e
    return fsspec


def open_artifact(path, mode: str = "rb"):
    """A local file or an fsspec URL opened for reading ("rb", or "r" as
    UTF-8 text)."""
    enc = {} if "b" in mode else {"encoding": "utf-8"}
    if is_remote(path):
        return _fsspec(path).open(str(path), mode, **enc).open()
    return open(path, mode, **enc)


def artifact_exists(path) -> bool:
    """Whether a local file or an fsspec URL exists."""
    if is_remote(path):
        fs, p = _fsspec(path).core.url_to_fs(str(path))
        return fs.exists(p)
    return Path(path).exists()


def _local(path) -> Path:
    if is_remote(path):
        raise ValueError(f"{path}: bundles are written to local directories only")
    return Path(path)


def _sha256(path) -> str:
    h = hashlib.sha256()
    with open_artifact(path) as f:
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


def pack_nullable_strings(name: str, values: Sequence[Optional[str]]) -> Dict[str, np.ndarray]:
    """_pack_strings of the values (None as "") with a bool `name_null` mask."""
    return {**_pack_strings(name, ["" if v is None else v for v in values]),
            f"{name}_null": np.asarray([v is None for v in values], bool)}


def unpack_nullable_strings(arrs, name: str) -> List[Optional[str]]:
    """The values of pack_nullable_strings, None where the mask is set."""
    return [None if null else v
            for v, null in zip(_unpack_strings(arrs, name), arrs[f"{name}_null"].tolist())]


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
        meta.update(pack_nullable_strings("last_ts",
                                          [None if t is None else str(t) for t in p.last_ts]))
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


def read_parquet(path, columns: Sequence[str], convert_hint: str):
    """The columns of a parquet file (local or fsspec) present in it, as a
    pyarrow Table; without pyarrow, raises with `convert_hint`."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise RuntimeError(f"reading {path} needs pyarrow, which is not installed here. "
                           f"{convert_hint}") from e
    with open_artifact(path) as f:
        pf = pq.ParquetFile(f)
        return pf.read(columns=[c for c in columns if c in pf.schema_arrow.names])


def _read_parquet(path, columns: Sequence[str]) -> Dict[str, list]:
    """Columns of a JAX bundle's parquet meta file, as Python lists."""
    table = read_parquet(path, columns, "It is a JAX-package bundle's meta file: convert the "
                         "bundle on a machine with pyarrow: python -m "
                         "review_recommender_tpu_torch.index.io convert SRC DST")
    return {c: table.column(c).to_pylist() for c in table.column_names}


def _ts(t) -> Optional[str]:
    return None if t is None or (isinstance(t, float) and math.isnan(t)) else str(t)


def _load_npz(path) -> Dict[str, np.ndarray]:
    """Every array of a local or fsspec .npz file."""
    with open_artifact(path) as f, np.load(f) as arrs:
        return dict(arrs)


def _product_meta(src: str) -> tuple:
    """(skus, agg_texts, last_ts or None) from whichever meta file exists."""
    if artifact_exists(join_path(src, PRODUCT_META)):
        m = _load_npz(join_path(src, PRODUCT_META))
        last_ts = unpack_nullable_strings(m, "last_ts") if "last_ts_null" in m else None
        return _unpack_strings(m, "sku"), _unpack_strings(m, "agg_text"), last_ts
    if artifact_exists(join_path(src, JAX_PRODUCT_META)):
        cols = _read_parquet(join_path(src, JAX_PRODUCT_META), ("sku", "agg_text", "last_ts"))
        last_ts = [_ts(t) for t in cols["last_ts"]] if "last_ts" in cols else None
        return ([str(s) for s in cols["sku"]], [str(t) for t in cols["agg_text"]], last_ts)
    raise FileNotFoundError(f"{src}: neither {PRODUCT_META} nor {JAX_PRODUCT_META}")


def _review_meta(src: str) -> tuple:
    """(texts, stars f32) from whichever review meta file exists."""
    if artifact_exists(join_path(src, REVIEW_META)):
        m = _load_npz(join_path(src, REVIEW_META))
        return _unpack_strings(m, "text"), np.asarray(m["stars"], np.float32)
    if artifact_exists(join_path(src, JAX_REVIEW_META)):
        cols = _read_parquet(join_path(src, JAX_REVIEW_META), ("text", "stars"))
        stars = np.asarray([np.nan if s is None else s for s in cols["stars"]], np.float32)
        return [str(t) for t in cols["text"]], stars
    raise FileNotFoundError(f"{src}: neither {REVIEW_META} nor {JAX_REVIEW_META}")


def mismatched_files(src, manifest: dict) -> List[str]:
    """The files of the manifest's checksums whose sha256 differs (a
    missing file is left to the reader that needs it)."""
    return [f for f, want in manifest.get("checksums", {}).items()
            if artifact_exists(join_path(src, f)) and _sha256(join_path(src, f)) != want]


def load_bundle(in_dir, verify_checksums: bool = False) -> IndexBundle:
    """Read a bundle of either layout (see the module docstring) from a
    local directory or an fsspec URL."""
    src = str(in_dir)
    with open_artifact(join_path(src, "manifest.json"), "r") as fh:
        manifest = json.load(fh)
    if manifest["schema_version"] > SCHEMA_VERSION:
        raise ValueError(f"index bundle schema v{manifest['schema_version']} is newer than "
                         f"supported v{SCHEMA_VERSION}")
    if verify_checksums:
        bad = mismatched_files(src, manifest)
        if bad:
            raise ValueError(f"checksum mismatch for {', '.join(bad)}")

    arrs = _load_npz(join_path(src, "product_arrays.npz"))
    skus, agg_texts, last_ts = _product_meta(src)
    with open_artifact(join_path(src, "vocab.txt"), "r") as fh:
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
        rarrs = _load_npz(join_path(src, "review_arrays.npz"))
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
