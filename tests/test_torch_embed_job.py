"""The port's sharded embedding job (review_recommender_tpu_torch/data/
embed_job.py) against the JAX package's `data/embed_job.py`.

With tests/test_data_pipeline.py's hash encoder: the same shard files
(byte-equal .npy), manifest and returned matrix at several shard sizes; a
resume encodes exactly the missing shards in both; a manifest for other
counts restarts both; `job_status` equal before, during and after a job.
The reference's fault is pinned (ROADMAP Queue 3): a killed job's temp
shard `emb_shard_NNNNN.tmp.npy` makes the JAX `job_status` raise, while
the port reports that shard missing. With tiny f32 towers carried from a
JAX BiEncoder by params_from_flax, the two jobs' embeddings agree within
1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.data import embed_job as J
from review_recommender_tpu.models.bert import BertConfig as JaxBertConfig
from review_recommender_tpu.models.encoder import BiEncoder as JaxBiEncoder
from review_recommender_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from review_recommender_tpu_torch.data import embed_job as T
from review_recommender_tpu_torch.models.bert import BertConfig
from review_recommender_tpu_torch.models.convert import params_from_flax
from review_recommender_tpu_torch.models.encoder import BiEncoder
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from tests.test_data_pipeline import FakeEncoder

TEXTS = [f"review {i} " + "word " * (i % 7) + "é" * (i % 3) for i in range(23)] + ["x" * 5000]
EMB_TOL = 1e-5


def carried_towers(vocab=512):
    """(JAX BiEncoder, port BiEncoder): tiny f32 towers, the port's
    parameters carried from the JAX init by params_from_flax."""
    cfg = JaxBertConfig.tiny(vocab_size=vocab)
    jbe = JaxBiEncoder.random_init(cfg, tokenizer=JaxHashTokenizer(vocab_size=vocab), seed=0,
                                   dtype=jnp.float32)
    params = params_from_flax(jax.tree.map(np.asarray, jbe.params), cfg, "biencoder")
    tbe = BiEncoder(BertConfig(**vars(cfg)), params, HashTokenizer(vocab_size=vocab),
                    device="cpu", dtype=torch.float32)
    return jbe, tbe


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("shard_rows", [1, 5, 7, 24, 100])
def test_job_equal_jax(tmp_path, shard_rows):
    je, te = FakeEncoder(), FakeEncoder()
    a = J.run_embed_job(TEXTS, je, tmp_path / "j", shard_rows=shard_rows)
    b = T.run_embed_job(TEXTS, te, tmp_path / "t", shard_rows=shard_rows)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert _files(tmp_path / "j") == _files(tmp_path / "t")
    assert je.calls == te.calls == -(-len(TEXTS) // shard_rows)
    assert T.job_status(tmp_path / "t") == {**J.job_status(tmp_path / "j"), "missing": []}


@pytest.mark.parametrize("drop", [[0], [2], [1, 3], [0, 1, 2, 3, 4]])
def test_resume_encodes_only_missing_shards_as_jax(tmp_path, drop):
    for mod, name in ((J, "j"), (T, "t")):
        mod.run_embed_job(TEXTS, FakeEncoder(), tmp_path / name, shard_rows=5)
        for i in drop:
            (tmp_path / name / f"emb_shard_{i:05d}.npy").unlink()
    status = T.job_status(tmp_path / "t")
    assert status["missing"] == drop and status["done_shards"] == 5 - len(drop)
    assert {k: v for k, v in status.items() if k != "missing"} == J.job_status(tmp_path / "j")
    je, te = FakeEncoder(), FakeEncoder()
    a = J.run_embed_job(TEXTS, je, tmp_path / "j", shard_rows=5)
    b = T.run_embed_job(TEXTS, te, tmp_path / "t", shard_rows=5)
    assert je.calls == te.calls == len(drop) and np.array_equal(a, b)
    assert _files(tmp_path / "j") == _files(tmp_path / "t")


@pytest.mark.parametrize("change", ["rows", "shard_rows", "no_resume", "short_shard"])
def test_restart_cases_equal_jax(tmp_path, change):
    """A manifest for other counts (or resume=False) re-encodes every
    shard; a shard file of the wrong length is re-encoded alone."""
    calls = []
    for mod, name in ((J, "j"), (T, "t")):
        mod.run_embed_job(TEXTS, FakeEncoder(), tmp_path / name, shard_rows=6)
        if change == "short_shard":
            np.save(tmp_path / name / "emb_shard_00001.npy", np.zeros((2, 16), np.float32))
        texts = TEXTS[:-3] if change == "rows" else TEXTS
        enc = FakeEncoder()
        out = mod.run_embed_job(texts, enc, tmp_path / name,
                                shard_rows=5 if change == "shard_rows" else 6,
                                resume=change != "no_resume")
        calls.append((enc.calls, out))
    assert calls[0][0] == calls[1][0] == {"rows": 4, "shard_rows": 5, "no_resume": 4,
                                          "short_shard": 1}[change]
    assert np.array_equal(calls[0][1], calls[1][1])
    assert json.loads((tmp_path / "t" / "job.json").read_text()) == \
        json.loads((tmp_path / "j" / "job.json").read_text())


def test_empty_job_and_status_before_a_job_equal_jax(tmp_path):
    assert T.job_status(tmp_path / "none") == J.job_status(tmp_path / "none") == {"started": False}
    a = J.run_embed_job([], FakeEncoder(), tmp_path / "j")
    b = T.run_embed_job([], FakeEncoder(), tmp_path / "t")
    assert a.shape == b.shape == (0, 0) and b.dtype == np.float32
    assert T.job_status(tmp_path / "t") == {**J.job_status(tmp_path / "j"), "missing": []}


def test_fault_torn_temp_shard_raises_in_jax_reported_missing_here(tmp_path):
    """ROADMAP Queue 3: a job killed between np.save and the rename leaves
    emb_shard_NNNNN.tmp.npy; the JAX glob emb_shard_*.npy matches it and
    int("00003.tmp") raises. The port counts complete shards only."""
    for mod, name in ((J, "j"), (T, "t")):
        mod.run_embed_job(TEXTS, FakeEncoder(), tmp_path / name, shard_rows=6)
        d = tmp_path / name
        (d / "emb_shard_00003.npy").rename(d / "emb_shard_00003.tmp.npy")
    with pytest.raises(ValueError, match="invalid literal"):
        J.job_status(tmp_path / "j")
    assert T.job_status(tmp_path / "t") == {"started": True, "n_shards": 4, "done_shards": 3,
                                            "complete": False, "missing": [3]}
    enc = FakeEncoder()
    out = T.run_embed_job(TEXTS, enc, tmp_path / "t", shard_rows=6)
    assert enc.calls == 1 and out.shape == (len(TEXTS), 16)
    assert T.job_status(tmp_path / "t")["complete"]


def test_tiny_towers_job_within_tolerance_of_jax(tmp_path):
    jbe, tbe = carried_towers()
    a = J.run_embed_job(TEXTS, jbe, tmp_path / "j", shard_rows=10, batch_size=8)
    b = T.run_embed_job(TEXTS, tbe, tmp_path / "t", shard_rows=10, batch_size=8)
    assert a.shape == b.shape == (len(TEXTS), jbe.cfg.hidden_size)
    np.testing.assert_allclose(b, a, rtol=0, atol=EMB_TOL)
    (tmp_path / "t" / "emb_shard_00001.npy").unlink()
    c = T.run_embed_job(TEXTS, tbe, tmp_path / "t", shard_rows=10, batch_size=8)
    assert np.array_equal(b, c)
