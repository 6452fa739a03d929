"""The port's tokenizer and towers against the JAX package.

Tokenizers must agree exactly. Towers run at BertConfig.tiny() in float32
with the flax parameters carried over by `params_from_flax`; outputs agree
to 1e-4 (f32 matmul sum order, and flax's E[x^2]-E[x]^2 LayerNorm variance
against torch's two-pass one, leave ~1e-6 after two layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.models import bert as jbert
from review_recommender_tpu.models import encoder as jenc
from review_recommender_tpu.models import tokenizer as jtok
from review_recommender_tpu_torch.models import bert as tbert
from review_recommender_tpu_torch.models import encoder as tenc
from review_recommender_tpu_torch.models import tokenizer as ttok
from review_recommender_tpu_torch.models.convert import params_from_flax

TOL = dict(rtol=1e-4, atol=1e-4)
TEXTS = [
    "Wireless Bluetooth headphones, noise-cancelling (ANC)!",
    "Café crème — naïve façade; 東京 tower",
    "t12 t345 t7",
    "",
    "socks " * 40,
]


def test_hash_tokenizer_ids():
    jt, tt = jtok.HashTokenizer(30522), ttok.HashTokenizer(30522)
    for text in TEXTS:
        assert tt.tokenize(text) == jt.tokenize(text)
        assert tt.token_ids(text) == jt.token_ids(text)
    assert (tt.pad_id, tt.unk_id, tt.cls_id, tt.sep_id, tt.mask_id) == (0, 1, 2, 3, 4)


@pytest.mark.parametrize("seed", range(3))
def test_ascii_tokenize_equals_the_character_loop_and_jax(seed):
    """basic_tokenize's one-pass route for ASCII words against the
    character loop (which every word with a non-ASCII character takes) and
    the JAX function, on 20,000 random ASCII strings: every control
    character, blanks, punctuation."""
    import random

    rng = random.Random(seed)
    pool = [chr(i) for i in range(128)] + list("ab cD\t\n.,!'") * 8
    for _ in range(20_000):
        text = "".join(rng.choice(pool) for _ in range(rng.randint(0, 30)))
        for lower in (True, False):
            want = jtok.basic_tokenize(text, lower)
            assert ttok.basic_tokenize(text, lower) == want
            assert ttok.basic_tokenize_chars(text, lower) == want


MIXED_EDGES = ["\u0391\u03a3.\u0391 \u0391\u03a3", "cafe\u0301 au lait", "a\u00a0b c",
               "x\u2028y z", "\u4e2d\u6587abc def", "\u039f\u0394\u039f\u03a3's end",
               "zero\u200bwidth, ok", "\ufffd\x00a\x1cb \u3000c", "\u201cnice\u201d it's"]


@pytest.mark.parametrize("seed", range(3))
def test_mixed_text_tokenize_equals_the_character_loop_and_jax(seed):
    """Text with non-ASCII words among ASCII ones (accents, combining marks,
    Greek final sigma, CJK, Unicode blanks and controls): basic_tokenize,
    which sends only those words through the character loop, against the
    loop over the whole text and the JAX function."""
    import random

    rng = random.Random(seed)
    uni = list("\u00e9\u00c9\u00f1\u00df\u0130\u03a3\u03c3\u03c2\u0391\u0301\u0308"
               "\u00a0\u3000\u200b\ufffd\x85\u4e2d\u6587\uff41\u2026\u201c\u201d\u2019"
               "\u2013\U0001f600")
    pool = [chr(i) for i in range(128)] + list("ab cD\t\n.,!'") * 8 + uni * 3
    texts = MIXED_EDGES + ["".join(rng.choice(pool) for _ in range(rng.randint(0, 40)))
                           for _ in range(20_000)]
    for text in texts:
        for lower in (True, False):
            want = jtok.basic_tokenize(text, lower)
            assert ttok.basic_tokenize(text, lower) == want, repr(text)
            assert ttok.basic_tokenize_chars(text, lower) == want, repr(text)


def test_hash_tokenizer_id_cache_is_emptied_at_its_bound(monkeypatch):
    monkeypatch.setattr(ttok, "_ID_CACHE_MAX", 4)
    jt, tt = jtok.HashTokenizer(500), ttok.HashTokenizer(500)
    for text in TEXTS * 2:
        assert tt.token_ids(text) == jt.token_ids(text)
        assert len(tt._ids) <= 4


@pytest.mark.parametrize("max_len", [512, 24, 9])
def test_encode_and_pack_seqs(max_len):
    """Pairs past the budget go through longest-first truncation."""
    jt, tt = jtok.HashTokenizer(500), ttok.HashTokenizer(500)
    queries = [TEXTS[0], TEXTS[2], TEXTS[4], TEXTS[1]]
    docs = [TEXTS[4], TEXTS[0] * 3, TEXTS[2], TEXTS[3]]
    for pairs in (None, docs):
        ref = jtok.encode_seqs(jt, queries, pairs=pairs, max_len=max_len)
        got = ttok.encode_seqs(tt, queries, pairs=pairs, max_len=max_len)
        assert got == ref
        assert all(len(ids) <= max_len for ids, _ in got)
        for a, b in zip(ttok.pack_seqs(tt, got), jtok.pack_seqs(jt, ref)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ttok.pack_seqs(tt, got, pad_to=64), jtok.pack_seqs(jt, ref, pad_to=64)):
            np.testing.assert_array_equal(a, b)
    for n in (1, 16, 17, 300, 512, 900):
        assert ttok.pad_bucket(n) == jtok.pad_bucket(n)


def _flax_params(kind, seed):
    cfg = jbert.BertConfig.tiny()
    init = jbert.init_biencoder if kind == "biencoder" else jbert.init_crossencoder
    _, params = init(cfg, seed=seed, dtype=jnp.float32)
    return cfg, jax.tree.map(np.asarray, params)


def _batch(seed, b=3, s=24, vocab=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    lens = np.array([s, 10, 1][:b])
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    tt = (np.arange(s)[None, :] >= lens[:, None] // 2).astype(np.int32) * mask
    return ids, mask, tt


def _port_model(cls, cfg, sd, **kw):
    model = cls(tbert.BertConfig(**vars(cfg)), dtype=torch.float32, **kw)
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_biencoder_model_matches_flax(pooling):
    cfg, params = _flax_params("biencoder", seed=0)
    ids, mask, tt = _batch(1)
    ref = jbert.BiEncoderModel(cfg, dtype=jnp.float32, pooling=pooling, attn_impl="xla").apply(
        {"params": params}, ids, mask, tt)
    sd = params_from_flax(params, cfg, "biencoder")
    model = _port_model(tbert.BiEncoderModel, cfg, sd, pooling=pooling)
    assert set(sd) == set(model.state_dict())
    with torch.inference_mode():
        got = model(*(torch.from_numpy(x) for x in (ids, mask, tt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, rtol=1e-5)


def test_crossencoder_model_matches_flax():
    cfg, params = _flax_params("crossencoder", seed=1)
    ids, mask, tt = _batch(2, b=3, s=32)
    ref = jbert.CrossEncoderModel(cfg, dtype=jnp.float32, attn_impl="pallas").apply(
        {"params": params}, ids, mask, tt)
    sd = params_from_flax(params, cfg, "crossencoder")
    model = _port_model(tbert.CrossEncoderModel, cfg, sd)
    with torch.inference_mode():
        got = model(*(torch.from_numpy(x) for x in (ids, mask, tt)))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_params_from_flax_casts_only_the_dense_layers():
    cfg, params = _flax_params("crossencoder", seed=2)
    sd = params_from_flax(params, cfg, "crossencoder", dtype=torch.bfloat16)
    assert sd["encoder.layers.0.attention.query.weight"].dtype == torch.bfloat16
    assert sd["encoder.layers.1.output.bias"].dtype == torch.bfloat16
    for key in ("encoder.word_embeddings.weight", "encoder.embeddings_layer_norm.weight",
                "encoder.layers.0.output_layer_norm.bias", "pooler.weight", "classifier.weight"):
        assert sd[key].dtype == torch.float32, key
    np.testing.assert_array_equal(
        sd["encoder.layers.0.intermediate.weight"].float().numpy(),
        np.asarray(params["encoder"]["layer_0"]["intermediate"]["kernel"]).T
        .astype(jnp.bfloat16).astype(np.float32))
    # random init writes the same key set
    assert set(tbert.init_state_dict(tbert.BertConfig(**vars(cfg)), "crossencoder")) == set(sd)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = tbert.ACT["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    assert np.abs(got - torch.nn.functional.gelu(torch.from_numpy(x)).numpy()).max() > 1e-4


def test_encoder_wrappers_match_jax():
    """Bucketing, length sort and padding: the wrappers feed both towers the
    same blocks, so encode/score_pairs agree row for row."""
    cfg = jbert.BertConfig.tiny()
    jbe = jenc.BiEncoder.random_init(cfg, seed=3, dtype=jnp.float32)
    jce = jenc.CrossEncoder.random_init(cfg, seed=4, dtype=jnp.float32)
    tcfg = tbert.BertConfig(**vars(cfg))
    tok = ttok.HashTokenizer(cfg.vocab_size)
    params = lambda m: jax.tree.map(np.asarray, m.params)
    tbe = tenc.BiEncoder(tcfg, params_from_flax(params(jbe), cfg, "biencoder"), tok,
                         device="cpu", dtype=torch.float32)
    tce = tenc.CrossEncoder(tcfg, params_from_flax(params(jce), cfg, "crossencoder"), tok,
                            device="cpu", dtype=torch.float32)
    texts = TEXTS[:3] + ["kitchen knife"] * 6
    np.testing.assert_allclose(tbe.encode(texts), jbe.encode(texts), **TOL)
    np.testing.assert_allclose(tbe("yellow socks"), jbe("yellow socks"), **TOL)
    docs = [t * 3 for t in TEXTS] * 2
    np.testing.assert_allclose(tce("wireless headphones", docs),
                               jce("wireless headphones", docs), **TOL)
    assert tenc.SEQ_BUCKETS == jenc.SEQ_BUCKETS and tenc.BATCH_BUCKETS == jenc.BATCH_BUCKETS
    for n in (1, 5, 64, 65, 300):
        assert tenc._batch_bucket(n) == jenc._batch_bucket(n)
