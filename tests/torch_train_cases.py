"""Shared pieces of the training parity tests (tests/test_torch_train.py,
tests/test_torch_mlm.py): one flax init per trainer kind carried over to
the port with params_from_flax, the JAX and port trainers built on it, a
batch for each kind made by the port's host code, and leaf-by-leaf
comparison of flax trees."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from review_recommender_tpu.models import bert as jbert
from review_recommender_tpu.train import contrastive as jcon
from review_recommender_tpu.train import cross_encoder as jxe
from review_recommender_tpu.train import mlm as jmlm
from review_recommender_tpu_torch.models.bert import BertConfig
from review_recommender_tpu_torch.models.convert import flax_from_params, params_from_flax
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from review_recommender_tpu_torch.train import contrastive as pcon
from review_recommender_tpu_torch.train import cross_encoder as pxe
from review_recommender_tpu_torch.train import mlm as pmlm

VOCAB, SEQ, BATCH = 384, 24, 8
CFG = BertConfig.tiny(VOCAB)
JCFG = jbert.BertConfig.tiny(VOCAB)
WORDS = [f"word{i}" for i in range(80)]
# kind -> (port model kind, JAX init, JAX trainer/config, port trainer/config)
KINDS = {
    "contrastive": ("biencoder", jbert.init_biencoder, (jcon.ContrastiveTrainer, jcon.TrainConfig),
                    (pcon.ContrastiveTrainer, pcon.TrainConfig)),
    "cross": ("crossencoder", jbert.init_crossencoder,
              (jxe.CrossEncoderTrainer, jxe.CrossTrainConfig),
              (pxe.CrossEncoderTrainer, pxe.CrossTrainConfig)),
    "mlm": ("mlm", jmlm.init_mlm, (jmlm.MLMTrainer, jmlm.MLMTrainConfig),
            (pmlm.MLMTrainer, pmlm.MLMTrainConfig)),
}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def texts(n, seed=0, length=12):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=length)) for _ in range(n)]


def batch(kind, seed=0):
    """One batch of `kind`'s trainer from the port's host code."""
    tok = HashTokenizer(VOCAB)
    docs = texts(BATCH, seed)
    rng = np.random.default_rng(seed + 100)
    queries = [" ".join(rng.choice(d.split(), size=4, replace=False)) for d in docs]
    if kind == "contrastive":
        return pcon.make_pair_batch(tok, queries, docs, max_len=SEQ, pad_to=SEQ)
    if kind == "cross":
        labels = (np.arange(BATCH) % 2).astype(np.float32)
        return pxe.make_triple_batch(tok, queries, docs, labels,
                                     max_len=SEQ, pad_to=SEQ)
    return pmlm.make_mlm_batch(tok, docs, max_len=SEQ, rng=rng)


def flax_init(kind, seed=0):
    """The flax init of `kind`'s model, f32 numpy leaves."""
    _, params = KINDS[kind][1](JCFG, seed=seed, dtype=jnp.float32)
    return jax.tree.map(np.asarray, params)


def trainers(kind, tc_kw, dtype=torch.float32, seed=0):
    """(JAX trainer, port trainer on the CPU) from one flax init."""
    model_kind, _init, (jtr, jtc), (ptr, ptc) = KINDS[kind]
    params = flax_init(kind, seed)
    j = jtr(JCFG, jax.tree.map(jnp.asarray, params), train_cfg=jtc(**tc_kw), dtype=JDTYPE[dtype])
    p = ptr(CFG, params_from_flax(params, CFG, model_kind), train_cfg=ptc(**tc_kw), dtype=dtype,
            device="cpu")
    return j, p


def port_tree(kind, sd):
    return flax_from_params(sd, CFG, KINDS[kind][0])


def assert_trees_close(got, want, rtol, atol, path=""):
    """Leaf by leaf: the same keys, values within rtol/atol."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=path)
