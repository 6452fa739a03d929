"""The port's tower loading (review_recommender_tpu_torch/models/load.py,
convert.py, tokenizer.py) against the JAX package's.

WordPiece ids equal the JAX tokenizer's (accents, CJK, punctuation,
control characters, a word over 100 characters, unknown pieces, a vocab
without [MASK]). Tiny HF snapshots written by `transformers`
save_pretrained (safetensors and .bin; skipped where transformers is
absent) load through the port's own readers and give the JAX loader's
outputs within 1e-5 in f32; the port's safetensors and msgpack readers
are held to the `safetensors` and `flax` packages' on the same bytes
(BF16, numpy scalars, flax's chunked arrays). Native towers written by
the JAX package's save_native_tower (hash and wordpiece tokenizers) load
with equal outputs. A kind mismatch and missing files raise as in JAX.
The full-size golden (tests/goldens/bert_fullsize.npz, weights from
tests/golden_utils.py) holds the port's converter and forward at the
bge-small and MiniLM-L6 shapes to the HF outputs at the JAX test's
tolerance (atol 5e-4, rtol 1e-3)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.models import load as jload
from review_recommender_tpu.models.bert import BertConfig as JaxBertConfig
from review_recommender_tpu.models.bert import init_biencoder, init_crossencoder
from review_recommender_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from review_recommender_tpu.models.tokenizer import WordPieceTokenizer as JaxWordPiece
from review_recommender_tpu_torch.models import load as tload
from review_recommender_tpu_torch.models.bert import BertConfig, BiEncoderModel, CrossEncoderModel
from review_recommender_tpu_torch.models.convert import (
    convert_biencoder,
    convert_crossencoder,
    params_from_flax,
)
from review_recommender_tpu_torch.models.encoder import build_model
from review_recommender_tpu_torch.models.tokenizer import WordPieceTokenizer, wordpiece

GOLDENS_FULL = Path(__file__).parent / "goldens" / "bert_fullsize.npz"
TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] wireless head ##phones great sound the quick brown "
         "fox , . ! cafe naive 中 国 un ##believ ##able ##s a ##b ##c").split()
TEXTS = [
    "Wireless HEADPHONES, great sound!",
    "Café naïve résumé — Ünïcödé",
    "中国 headphones中国",
    "tab\there\x00null\x07bell​zero-width�replacement",
    "unbelievables abc",
    "x" * 101 + " great",
    "a" * 100,
    "qqq unknownpiece ##s 12.5% (sound)",
    "",
]
BI_TEXTS = ["wireless headphones great sound", "the quick brown fox", "cafe , naive !"]


def _vocab_dir(tmp_path, words=VOCAB):
    d = tmp_path
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.txt").write_text("\n".join(words) + "\n", encoding="utf-8")
    return d / "vocab.txt"


# ----------------------------------------------------------------- wordpiece
@pytest.mark.parametrize("lowercase", [True, False])
@pytest.mark.parametrize("text", TEXTS)
def test_wordpiece_ids_match_jax(tmp_path, text, lowercase):
    path = _vocab_dir(tmp_path)
    j = JaxWordPiece.from_vocab_file(path, lowercase=lowercase)
    t = WordPieceTokenizer.from_vocab_file(path, lowercase=lowercase)
    assert t.tokenize(text) == j.tokenize(text)
    assert t.token_ids(text) == j.token_ids(text)


def test_wordpiece_special_ids_and_mask_fallback(tmp_path):
    path = _vocab_dir(tmp_path / "full")
    no_mask = _vocab_dir(tmp_path / "nomask", [w for w in VOCAB if w != "[MASK]"])
    for p in (path, no_mask):
        j, t = JaxWordPiece.from_vocab_file(p), WordPieceTokenizer.from_vocab_file(p)
        for name in ("cls_id", "sep_id", "pad_id", "unk_id", "mask_id"):
            assert getattr(t, name) == getattr(j, name), (p, name)
    assert WordPieceTokenizer.from_vocab_file(no_mask).mask_id == \
        WordPieceTokenizer.from_vocab_file(no_mask).unk_id
    vocab = {w: i for i, w in enumerate(VOCAB)}
    assert wordpiece("unbelievables", vocab) == ["un", "##believ", "##able", "##s"]
    assert wordpiece("x" * 101, vocab) == ["[UNK]"] and wordpiece("unz", vocab) == ["[UNK]"]


# -------------------------------------------------------------- HF snapshots
TINY = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64, type_vocab_size=2)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """{(kind, fmt): dir} of tiny HF snapshots, fmt safetensors or bin."""
    transformers = pytest.importorskip("transformers")
    root = tmp_path_factory.mktemp("snapshots")
    out = {}
    for kind in ("biencoder", "crossencoder"):
        for fmt in ("safetensors", "bin"):
            torch.manual_seed(3 if kind == "biencoder" else 4)
            if kind == "biencoder":
                model = transformers.BertModel(transformers.BertConfig(**TINY),
                                               add_pooling_layer=False)
            else:
                model = transformers.BertForSequenceClassification(
                    transformers.BertConfig(**TINY, num_labels=1))
            d = root / f"{kind}_{fmt}"
            model.eval().save_pretrained(d, safe_serialization=fmt == "safetensors")
            _vocab_dir(d)
            out[kind, fmt] = d
    return out


def _pair(kind, d):
    """(JAX tower, port tower), both f32, the port's on the CPU."""
    if kind == "biencoder":
        return (jload.load_biencoder(d, dtype=jnp.float32),
                tload.load_biencoder(d, device="cpu", dtype=torch.float32))
    return (jload.load_crossencoder(d, dtype=jnp.float32),
            tload.load_crossencoder(d, device="cpu", dtype=torch.float32))


def _outputs(kind, tower):
    if kind == "biencoder":
        return tower.encode(BI_TEXTS + TEXTS)
    return tower("wireless headphones", BI_TEXTS + TEXTS)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("kind", ["biencoder", "crossencoder"])
def test_hf_snapshot_loads_like_jax(snapshots, kind, fmt):
    d = snapshots[kind, fmt]
    assert (d / ("model.safetensors" if fmt == "safetensors" else "pytorch_model.bin")).exists()
    jt, tt = _pair(kind, d)
    assert tt.cfg == BertConfig(**{f: getattr(jt.cfg, f) for f in BertConfig.__dataclass_fields__})
    assert tt.tokenizer.vocab == jt.tokenizer.vocab
    np.testing.assert_allclose(_outputs(kind, tt), _outputs(kind, jt), **TOL)


def test_config_from_hf_matches_jax_and_the_json_reader(snapshots):
    import transformers

    from review_recommender_tpu.models.convert import config_from_hf as jax_config_from_hf
    from review_recommender_tpu_torch.models.convert import config_from_hf

    d = snapshots["crossencoder", "bin"]
    hf = transformers.BertConfig.from_pretrained(d)
    got, want = config_from_hf(hf), jax_config_from_hf(hf)
    assert got == BertConfig(**{f: getattr(want, f) for f in BertConfig.__dataclass_fields__})
    assert got == tload._config_from_json(d / "config.json")


def test_safetensors_reader_matches_the_package(snapshots, tmp_path):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    st = snapshots["crossencoder", "safetensors"] / "model.safetensors"
    want, got = load_file(str(st)), tload.read_safetensors(st)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rng = torch.Generator().manual_seed(0)
    mixed = {"bf": torch.randn(3, 5, generator=rng).to(torch.bfloat16),
             "h": torch.randn(4, generator=rng).to(torch.float16),
             "i": torch.arange(6, dtype=torch.int64).reshape(2, 3),
             "empty": torch.zeros(0, 4), "b": torch.tensor([True, False])}
    save_file(mixed, str(tmp_path / "m.safetensors"), metadata={"format": "pt"})
    got = tload.read_safetensors(tmp_path / "m.safetensors")
    assert got["bf"].dtype == np.float32
    np.testing.assert_array_equal(got["bf"], mixed["bf"].float().numpy())
    for k in ("h", "i", "empty", "b"):
        np.testing.assert_array_equal(got[k], mixed[k].numpy(), err_msg=k)
    (tmp_path / "bad.safetensors").write_bytes(b"\xff" * 8 + b"{}")
    with pytest.raises(ValueError, match="runs past the file"):
        tload.read_safetensors(tmp_path / "bad.safetensors")


def test_prefixed_state_dict_and_missing_pooler(snapshots):
    """A `bert.`-prefixed encoder converts like an unprefixed one; the
    bi-encoder ignores an absent pooler and the cross-encoder raises
    KeyError for one, as the JAX converters do."""
    from review_recommender_tpu.models import convert as jconvert

    sd = tload._load_state_dict(snapshots["crossencoder", "safetensors"])
    cfg = tload._config_from_json(snapshots["crossencoder", "safetensors"] / "config.json")
    jcfg = jload._config_from_json(snapshots["crossencoder", "safetensors"] / "config.json")
    assert any(k.startswith("bert.") for k in sd)
    got, want = convert_biencoder(sd, cfg), jconvert.convert_biencoder(sd, jcfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    no_pooler = {k: v for k, v in sd.items() if "pooler" not in k}
    for fn, c in ((convert_crossencoder, cfg), (jconvert.convert_crossencoder, jcfg)):
        with pytest.raises(KeyError, match="pooler"):
            fn(no_pooler, c)


# ------------------------------------------------------------- native towers
@pytest.fixture(scope="module")
def native_towers(tmp_path_factory):
    """{(kind, tokenizer): dir} written by the JAX save_native_tower."""
    root = tmp_path_factory.mktemp("native")
    vocab = _vocab_dir(root / "vocab_src")
    cfg = JaxBertConfig.tiny(vocab_size=len(VOCAB))
    out = {}
    for kind, init in (("biencoder", init_biencoder), ("crossencoder", init_crossencoder)):
        _model, params = init(cfg, seed=5)
        for tok_name, tok in (("hash", JaxHashTokenizer(vocab_size=len(VOCAB))),
                              ("wordpiece", JaxWordPiece.from_vocab_file(vocab))):
            d = root / f"{kind}_{tok_name}"
            jload.save_native_tower(d, kind, cfg, params, tok,
                                    **({"pooling": "mean"} if kind == "biencoder" else {}))
            out[kind, tok_name] = d
    return out


@pytest.mark.parametrize("tok_name", ["hash", "wordpiece"])
@pytest.mark.parametrize("kind", ["biencoder", "crossencoder"])
def test_native_tower_loads_like_jax(native_towers, kind, tok_name):
    d = native_towers[kind, tok_name]
    jt, tt = _pair(kind, d)
    assert type(tt.tokenizer).__name__ == type(jt.tokenizer).__name__
    if kind == "biencoder":
        assert tt.model.pooling == "mean"
    np.testing.assert_allclose(_outputs(kind, tt), _outputs(kind, jt), **TOL)


def test_msgpack_reader_matches_flax(native_towers, monkeypatch):
    import flax.serialization as fs

    blob = (native_towers["crossencoder", "hash"] / "params.msgpack").read_bytes()
    want, got = fs.msgpack_restore(blob), tload.read_flax_msgpack(blob)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tree = {"scalar": np.float32(2.5), "i64": np.int64(-7), "ints": [0, 127, 128, -1, -33,
            -129, 2**16, 2**33, -(2**40)], "floats": [1.5, -0.25], "none": None,
            "flags": [True, False], "text": "é" * 40, "bytes": b"x" * 300,
            "bf16": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
            "big": np.arange(40, dtype=np.float32).reshape(5, 8)}
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)  # "big" goes out in flax's chunked form
    blob = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    got, want = tload.read_flax_msgpack(blob), fs.msgpack_restore(blob)
    assert got["scalar"] == 2.5 and isinstance(got["scalar"], np.float32)
    assert got["i64"] == -7 and got["ints"] == want["ints"] and got["floats"] == want["floats"]
    assert got["none"] is None and got["flags"] == [True, False] and got["text"] == "é" * 40
    assert got["bytes"] == b"x" * 300
    np.testing.assert_array_equal(got["bf16"], np.asarray(want["bf16"], np.float32))
    np.testing.assert_array_equal(got["big"], want["big"])
    with pytest.raises(ValueError, match="ends early"):
        tload.read_flax_msgpack(blob[:-3])


def test_kind_mismatch_and_missing_files_raise_as_in_jax(native_towers, snapshots, tmp_path):
    bi, ce = native_towers["biencoder", "hash"], native_towers["crossencoder", "hash"]
    for loader in (jload.load_crossencoder, lambda d: tload.load_crossencoder(d, device="cpu")):
        with pytest.raises(ValueError, match="'biencoder' tower, expected 'crossencoder'"):
            loader(bi)
    for loader in (jload.load_biencoder, lambda d: tload.load_biencoder(d, device="cpu")):
        with pytest.raises(ValueError, match="'crossencoder' tower, expected 'biencoder'"):
            loader(ce)
    no_weights = tmp_path / "no_weights"
    no_weights.mkdir()
    cfg_json = (snapshots["biencoder", "bin"] / "config.json").read_text()
    (no_weights / "config.json").write_text(cfg_json)
    _vocab_dir(no_weights)
    no_vocab = tmp_path / "no_vocab"
    no_vocab.mkdir()
    for f in ("config.json", "pytorch_model.bin"):
        (no_vocab / f).write_bytes((snapshots["biencoder", "bin"] / f).read_bytes())
    for d, what in ((no_weights, "no model.safetensors or pytorch_model.bin"),
                    (no_vocab, "no vocab.txt"), (tmp_path / "absent", "config.json")):
        for loader in (jload.load_biencoder, lambda d: tload.load_biencoder(d, device="cpu")):
            with pytest.raises(FileNotFoundError, match=what):
                loader(d)
    spec_dir = tmp_path / "bad_spec"
    spec_dir.mkdir()
    meta = json.loads((bi / "config.json").read_text())
    meta["tokenizer"] = {"type": "sentencepiece"}
    (spec_dir / "config.json").write_text(json.dumps(meta))
    (spec_dir / "params.msgpack").write_bytes((bi / "params.msgpack").read_bytes())
    for loader in (jload.load_biencoder, lambda d: tload.load_biencoder(d, device="cpu")):
        with pytest.raises(ValueError, match="unknown tokenizer type"):
            loader(spec_dir)


# ----------------------------------------------------------- full-size golden
def _full_state_dict(g, prefix: str, seed: int) -> dict:
    from tests.golden_utils import manifest_from_npz, synth_state_arrays

    return synth_state_arrays(manifest_from_npz(g, prefix), seed=seed)


@pytest.mark.parametrize("kind", ["biencoder", "crossencoder"])
def test_fullsize_golden(kind):
    """bge-small (12 x 384, 12 heads) and MiniLM-L6-shaped towers through
    the port's converter and f32 forward against the committed HF outputs."""
    g = np.load(GOLDENS_FULL)
    if kind == "biencoder":
        cfg, prefix, seed, model = BertConfig.bge_small(), "be_", 100, BiEncoderModel
        params = convert_biencoder(_full_state_dict(g, "be_man.", seed), cfg)
    else:
        cfg, prefix, seed, model = BertConfig.minilm_l6_cross(), "ce_", 200, CrossEncoderModel
        params = convert_crossencoder(_full_state_dict(g, "ce_man.", seed), cfg)
    with torch.device("meta"):
        m = model(cfg, dtype=torch.float32)
    m = build_model(m, params_from_flax(params, cfg, kind), torch.device("cpu"))
    ids, mask, tt = (torch.from_numpy(g[f"{prefix}in_{k}"].astype(np.int32))
                     for k in ("ids", "mask", "tt"))
    with torch.inference_mode():
        got = m(ids, mask, tt).numpy()
    np.testing.assert_allclose(got, g[f"{prefix}out"], atol=5e-4, rtol=1e-3)


_HYGIENE = """
import json, sys
import numpy as np
from review_recommender_tpu_torch.models.load import load_biencoder, load_crossencoder
from review_recommender_tpu_torch.engine.search import SearchEngine
from review_recommender_tpu_torch.index.build import synth_product_index
from review_recommender_tpu_torch.index.schema import IndexBundle
st, native = sys.argv[1], sys.argv[2]
be = load_biencoder(st, device="cpu")
ce = load_crossencoder(native, device="cpu")
out = [be.encode(["wireless headphones"]).shape[1], len(ce("great", ["sound", "fox"]))]
p = synth_product_index(400, 32, 500, 8, seed=0)
for dtype, pool in (("int8", "exact"), ("int8", "striped"), ("bfloat16", "ivf")):
    eng = SearchEngine(IndexBundle(products=p), device="cpu", emb_dtype=dtype, dense_pool=pool,
                       query_encoder=be)
    out.append(len(eng.run_search("t12 t34", k=5, rerank_k=0)[0]))
bad = [m for m in ("jax", "flax", "msgpack", "safetensors", "pandas", "pyarrow")
       if m in sys.modules]
bad += sorted(m for m in sys.modules
              if m == "review_recommender_tpu" or m.startswith("review_recommender_tpu."))
print(json.dumps({"out": out, "bad": bad}))
"""


def test_loading_and_the_new_pools_import_no_forbidden_module(snapshots, native_towers):
    """A fresh interpreter loads a safetensors snapshot and a native tower
    and runs int8 (exact, striped) and IVF engines without loading jax,
    flax, msgpack, safetensors, pandas, pyarrow or the JAX package."""
    import os
    import subprocess
    import sys

    repo = Path(__file__).resolve().parents[1]
    env = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
           "PYTHONPATH": str(repo)}
    proc = subprocess.run([sys.executable, "-c", _HYGIENE,
                           str(snapshots["biencoder", "safetensors"]),
                           str(native_towers["crossencoder", "wordpiece"])],
                          cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"out": [32, 2, 5, 5, 5], "bad": []}
