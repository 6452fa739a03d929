"""The port's data-parallel encoder, ln_dtype="bfloat16" and the
global-scale int8 scan against the JAX package on the CPU.

  BiEncoder(devices=["cpu"] * 8) against the JAX BiEncoder(mesh=Mesh(the
    8 virtual CPU devices of tests/conftest.py, ("dp",))) and against the
    port's one-device encode, tiny f32 towers carried over by
    params_from_flax: within 1e-5; every batch bucket a multiple of 8,
    cut into 8 equal slices; run_embed_job over the device list writes the
    JAX mesh job's shards (within 1e-5) and manifest;
  ln_dtype="bfloat16": the port's towers against flax's, both tower kinds,
    in f32 and bf16 compute, within BF16_LN_TOL; the knob changes the f32
    towers; any other name raises as in JAX;
  quantize_corpus_int8_global equal to JAX's, and
    dense_striped_topk_scan_int8_global's rows equal to JAX's and its
    scores within one f32 rounding, on ragged N, all-invalid stripes, a
    pool past the valid stripes, and both query shapes.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from review_recommender_tpu.data import embed_job as jjob
from review_recommender_tpu.models import bert as jbert
from review_recommender_tpu.models import encoder as jenc
from review_recommender_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from review_recommender_tpu.ops import dense as jdense
from review_recommender_tpu_torch.data import embed_job as pjob
from review_recommender_tpu_torch.models import encoder as penc
from review_recommender_tpu_torch.models.bert import (
    BertConfig,
    BiEncoderModel,
    CrossEncoderModel,
)
from review_recommender_tpu_torch.models.convert import params_from_flax
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from review_recommender_tpu_torch.ops import dense as pdense

VOCAB, N_DEV = 512, 8
CFG, JCFG = BertConfig.tiny(VOCAB), jbert.BertConfig.tiny(VOCAB)
TEXTS = [" ".join(f"w{(i * 7 + j) % 61}" for j in range(i % 19 + 1)) for i in range(45)]
EMB_TOL = 1e-5
# one bf16 rounding of a LayerNorm output (2^-8 relative) can land on the
# other side in the two frameworks (flax's E[x^2] - E[x]^2 variance against
# torch's two-pass one), and the towers carry it through the later layers:
# measured 4.9e-4 / 9.3e-4 in f32 compute, 3.4e-3 / 6.3e-3 in bf16 (the
# tests' bf16 bound, as the trainers' bf16 losses)
BF16_LN_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


@functools.lru_cache(maxsize=None)
def flax_params(kind="biencoder", ln_dtype="float32", seed=0):
    jcfg = dataclasses.replace(JCFG, ln_dtype=ln_dtype)
    init = jbert.init_biencoder if kind == "biencoder" else jbert.init_crossencoder
    _, params = init(jcfg, seed=seed, dtype=jnp.float32)
    return jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def jax_mesh_encoder():
    mesh = Mesh(np.array(jax.devices()[:N_DEV]), ("dp",))
    return jenc.BiEncoder(JCFG, jax.tree.map(jnp.asarray, flax_params()),
                          JHashTokenizer(VOCAB), dtype=jnp.float32, mesh=mesh)


def port_encoder(devices=None):
    kw = {"device": "cpu"} if devices is None else {"devices": devices}
    return penc.BiEncoder(CFG, params_from_flax(flax_params(), CFG, "biencoder"),
                          HashTokenizer(VOCAB), dtype=torch.float32, **kw)


@functools.lru_cache(maxsize=None)
def jax_mesh_encode(batch_size):
    return jax_mesh_encoder().encode(TEXTS, batch_size=batch_size)


# ---------------------------------------------------------- data-parallel
@pytest.mark.parametrize("batch_size", [4, 16, 256])
def test_data_parallel_encode_equals_jax_mesh_and_one_device(batch_size):
    dp = port_encoder(["cpu"] * N_DEV)
    got = dp.encode(TEXTS, batch_size=batch_size)
    assert got.shape == (len(TEXTS), CFG.hidden_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_mesh_encode(batch_size), rtol=0, atol=EMB_TOL)
    np.testing.assert_allclose(got, port_encoder().encode(TEXTS, batch_size=batch_size),
                               rtol=0, atol=EMB_TOL)
    assert dp(TEXTS[3]).shape == (CFG.hidden_size,)


def test_batch_buckets_are_multiples_of_the_device_count():
    for n in list(range(1, 40)) + [255, 256, 257, 300, 513]:
        b = jenc._batch_bucket(n)
        assert penc._batch_bucket(n, N_DEV) == -(-b // N_DEV) * N_DEV, n
        assert penc._batch_bucket(n) == b, n
    dp = port_encoder(["cpu"] * N_DEV)
    seen = []
    (model,) = dp.models.values()  # one copy for the one distinct device
    model.register_forward_pre_hook(lambda _m, args: seen.append(tuple(args[0].shape)))
    dp.encode(TEXTS, batch_size=16)
    chunks = [16, 16, len(TEXTS) - 32]
    assert len(seen) == N_DEV * len(chunks)
    for c, i in zip(chunks, range(0, len(seen), N_DEV)):
        rows = {shape[0] for shape in seen[i:i + N_DEV]}  # equal slices
        assert rows == {penc._batch_bucket(c, N_DEV) // N_DEV}, (c, seen[i:i + N_DEV])


def test_data_parallel_encoder_takes_the_device_list():
    dp = port_encoder(["cpu"] * 3)
    assert dp.devices == [torch.device("cpu")] * 3 and dp.device == torch.device("cpu")
    assert penc._batch_bucket(5, 3) == 9
    np.testing.assert_allclose(dp.encode(TEXTS[:5]), port_encoder().encode(TEXTS[:5]),
                               rtol=0, atol=EMB_TOL)
    with pytest.raises(ValueError, match="empty"):
        port_encoder([])


def test_embed_job_over_the_device_list_writes_the_jax_mesh_shards(tmp_path):
    texts = TEXTS * 2
    want = jjob.run_embed_job(texts, jax_mesh_encoder(), tmp_path / "j", shard_rows=32,
                              batch_size=16)
    got = pjob.run_embed_job(texts, port_encoder(["cpu"] * N_DEV), tmp_path / "t",
                             shard_rows=32, batch_size=16)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len([n for n in names if n.startswith("emb_shard_")]) == 3
    for name in names:
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(tmp_path / "t" / name),
                                       np.load(tmp_path / "j" / name), rtol=0, atol=EMB_TOL)
    assert json.loads((tmp_path / "t" / "job.json").read_text()) == json.loads(
        (tmp_path / "j" / "job.json").read_text())


def test_load_biencoder_passes_the_device_list(tmp_path):
    from review_recommender_tpu_torch.models import load

    tower = port_encoder()
    load.save_native_tower(tmp_path / "be", "biencoder", CFG,
                           {k: v.detach() for k, v in tower.model.state_dict().items()},
                           HashTokenizer(VOCAB))
    dp = load.load_biencoder(tmp_path / "be", devices=["cpu"] * 4, dtype=torch.float32)
    assert dp.devices == [torch.device("cpu")] * 4
    np.testing.assert_allclose(dp.encode(TEXTS), tower.encode(TEXTS), rtol=0, atol=EMB_TOL)


# -------------------------------------------------------- ln_dtype bf16
def _towers(kind, dtype):
    """(flax output, port output, port output with f32 LayerNorms) for the
    ln_dtype="bfloat16" tower of `kind` computing in `dtype`."""
    jcfg = dataclasses.replace(JCFG, ln_dtype="bfloat16")
    cfg = dataclasses.replace(CFG, ln_dtype="bfloat16")
    params = flax_params(kind, "bfloat16", seed=1)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    ids, mask, tt = jenc.pack_seqs(JHashTokenizer(VOCAB), jenc.encode_seqs(
        JHashTokenizer(VOCAB), TEXTS[:12], pairs=TEXTS[12:24] if kind != "biencoder" else None,
        max_len=48))
    if kind == "biencoder":
        jm, pm = jbert.BiEncoderModel(jcfg, dtype=jdt), BiEncoderModel
    else:
        jm, pm = jbert.CrossEncoderModel(jcfg, dtype=jdt), CrossEncoderModel
    want = np.asarray(jm.apply({"params": params}, ids, mask, tt), np.float32)
    sd = params_from_flax(params, cfg, kind)
    out = []
    for c in (cfg, CFG):
        with torch.device("meta"):
            model = pm(c, dtype=dtype)
        model = penc.build_model(model, sd, torch.device("cpu"))
        with torch.no_grad():
            out.append(model(*(torch.from_numpy(np.asarray(a)) for a in (ids, mask, tt)))
                       .float().numpy())
    return want, out[0], out[1]


@pytest.mark.parametrize("kind", ["biencoder", "crossencoder"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bf16_layer_norm_towers_match_flax(kind, dtype):
    want, got, f32_ln = _towers(kind, dtype)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LN_TOL[dtype])
    if dtype == torch.float32:  # the knob rounds the f32 tower's LayerNorms, as flax's does
        assert np.abs(f32_ln - want).max() > np.abs(got - want).max()


def test_unknown_ln_dtype_raises_as_in_jax():
    cfg = dataclasses.replace(CFG, ln_dtype="float16")
    with pytest.raises(ValueError, match="expected 'float32'/'bfloat16'"):
        with torch.device("meta"):
            BiEncoderModel(cfg)
    jcfg = dataclasses.replace(JCFG, ln_dtype="float16")
    with pytest.raises(ValueError, match="expected 'float32'/'bfloat16'"):
        jbert.init_biencoder(jcfg)


# ------------------------------------------------------- int8, one scale
def _corpus(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,d,seed", [(1003, 64, 0), (64, 32, 1), (5, 16, 2)])
def test_global_quantization_equals_jax(n, d, seed):
    emb = _corpus(n, d, seed)
    got_q, got_s = pdense.quantize_corpus_int8_global(emb)
    want_q, want_s = jdense.quantize_corpus_int8_global(emb)
    assert got_q.dtype == np.int8 and np.array_equal(got_q, np.asarray(want_q))
    assert got_s == want_s and isinstance(got_s, float)


INT8_CASES = {
    # (n rows, dim, stripes, pool, invalid rule)
    "ragged": (1003, 64, 64, 20, "tail"),
    "dead_stripes": (960, 64, 32, 32, "stripes"),
    "pool_past_valid": (200, 32, 16, 16, "most"),
    "one_slice": (48, 32, 64, 10, "none"),
}


def _valid(n, g, rule, rng):
    v = np.ones(n, bool)
    if rule == "tail":
        v[-17:] = False
    elif rule == "stripes":  # stripes 3, 7 and 20 hold no valid row
        v[np.isin(np.arange(n) % g, [3, 7, 20])] = False
        v[rng.integers(0, n, 40)] = False
    elif rule == "most":  # valid rows in 5 of 16 stripes
        v[~np.isin(np.arange(n) % g, [0, 2, 4, 9, 15])] = False
    return v


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_global_int8_scan_equals_jax(case):
    n, d, stripes, pool, rule = INT8_CASES[case]
    rng = np.random.default_rng(7)
    emb = _corpus(n, d, 3)
    valid = _valid(n, min(stripes, n), rule, rng)
    q, scale = jdense.quantize_corpus_int8_global(emb)
    qvecs = rng.standard_normal((5, d)).astype(np.float32)
    j_qs, _s, j_valid = jdense.slice_corpus_for_striped_int8(
        jnp.asarray(q), jnp.zeros(n, jnp.float32), jnp.asarray(valid), stripes)
    p_qs, _s, p_valid = pdense.slice_corpus_for_striped_int8(
        torch.from_numpy(q), torch.zeros(n), torch.from_numpy(valid), stripes)
    got_s, got_i = pdense.dense_striped_topk_scan_int8_global(
        p_qs, p_valid, torch.from_numpy(qvecs), pool, scale)
    for b, qv in enumerate(qvecs):
        want_s, want_i = jdense.dense_striped_topk_scan_int8_global(
            j_qs, j_valid, jnp.asarray(qv), pool, scale)
        want_s, want_i = np.asarray(want_s), np.asarray(want_i)
        dead = np.isneginf(want_s)
        assert np.array_equal(np.isneginf(got_s[b].numpy()), dead), b
        assert np.array_equal(got_i[b].numpy(), want_i.astype(np.int64)), b
        np.testing.assert_allclose(got_s[b].numpy()[~dead], want_s[~dead], rtol=1.2e-7, atol=0)
        one_s, one_i = pdense.dense_striped_topk_scan_int8_global(
            p_qs, p_valid, torch.from_numpy(qv), pool, scale)
        assert one_s.shape == (min(pool, p_qs.shape[1]),)
        assert torch.equal(one_i, got_i[b]) and torch.equal(one_s, got_s[b])
    if rule in ("stripes", "most"):  # the pool reaches a stripe with no valid row
        assert np.isneginf(got_s.numpy()).all(axis=0).any()
