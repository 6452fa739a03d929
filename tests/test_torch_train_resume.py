"""Checkpoint and resume of the port's training loops (the contract of
tests/test_train_resume.py): a run killed after 4 steps and resumed into a
fresh trainer continues the 8-step run's loss stream exactly and ends at
its parameters; a finished run resumed is a no-op. The checkpoint is read
with torch.load(weights_only=True); and a fresh interpreter trains, saves
and loads a tower without loading anything of JAX."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from review_recommender_tpu_torch.models.bert import BertConfig, init_state_dict
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from review_recommender_tpu_torch.train.contrastive import ContrastiveTrainer, TrainConfig
from review_recommender_tpu_torch.train.cross_encoder import (
    CrossEncoderTrainer,
    CrossTrainConfig,
    train_crossencoder,
)
from review_recommender_tpu_torch.train.data import train_biencoder
from review_recommender_tpu_torch.train.mlm import MLMTrainConfig, MLMTrainer, pretrain_mlm

CFG = BertConfig(vocab_size=256, hidden_size=32, num_layers=1, num_heads=2,
                 intermediate_size=64, max_position=64)


@pytest.fixture(scope="module")
def texts():
    rng = np.random.default_rng(0)
    words = [f"word{i}" for i in range(60)]
    return [" ".join(rng.choice(words, size=12)) for _ in range(40)]


def _same_params(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _mlm(seed):
    return MLMTrainer(CFG, init_state_dict(CFG, "mlm", seed), device="cpu",
                      train_cfg=MLMTrainConfig(seed=3, total_steps=8))


def test_mlm_resume_continues_the_exact_stream(texts, tmp_path):
    tok = HashTokenizer(256)
    kw = dict(batch_size=4, max_len=24, seed=3, log_every=0)
    full = _mlm(1)
    h_full = pretrain_mlm(full, texts, tok, steps=8, **kw)
    half = _mlm(1)
    ckpt = tmp_path / "mlm.ckpt"
    pretrain_mlm(half, texts, tok, steps=4, checkpoint_path=str(ckpt), checkpoint_every=2, **kw)
    assert ckpt.exists() and half.step == 4
    resumed = _mlm(99)  # another init: the checkpoint wins
    resumed.restore(ckpt)
    assert resumed.step == 4
    h_res = pretrain_mlm(resumed, texts, tok, steps=8, **kw)
    assert [m["step"] for m in h_res] == [5, 6, 7, 8]
    assert [m["loss"] for m in h_res] == [m["loss"] for m in h_full[4:]]
    _same_params(resumed.params, full.params)
    assert pretrain_mlm(resumed, texts, tok, steps=8, **kw) == [] and resumed.step == 8


def test_biencoder_resume_continues_the_exact_stream(texts, tmp_path):
    tok = HashTokenizer(256)
    pairs = [(t.split()[0], t) for t in texts]
    kw = dict(batch_size=4, epochs=2, max_len=24, seed=5, log_every=0)
    make = lambda seed: ContrastiveTrainer(CFG, init_state_dict(CFG, "biencoder", seed),
                                           device="cpu", train_cfg=TrainConfig(seed=5))
    full = make(1)
    h_full = train_biencoder(full, pairs, tok, **kw)
    assert len(h_full) == 20
    half = make(1)
    ckpt = tmp_path / "bi.ckpt"
    train_biencoder(half, pairs, tok, checkpoint_path=str(ckpt), **{**kw, "epochs": 1})
    state = torch.load(ckpt, weights_only=True)
    assert state["step"] == 10 and set(state) == {"params", "opt_state", "step"}
    resumed = make(77)
    resumed.restore(ckpt)
    h_res = train_biencoder(resumed, pairs, tok, **kw)
    assert [m["step"] for m in h_res] == list(range(11, 21))
    assert [m["loss"] for m in h_res] == [m["loss"] for m in h_full[10:]]
    _same_params(resumed.params, full.params)


def test_crossencoder_resume_continues_the_exact_stream(texts, tmp_path):
    tok = HashTokenizer(256)
    triples = [(t.split()[0], t, float(i % 2)) for i, t in enumerate(texts)]
    kw = dict(batch_size=4, epochs=2, max_len=32, seed=5, log_every=0)
    make = lambda seed: CrossEncoderTrainer(CFG, init_state_dict(CFG, "crossencoder", seed),
                                            device="cpu", train_cfg=CrossTrainConfig(seed=5))
    full = make(1)
    h_full = train_crossencoder(full, triples, tok, **kw)
    half = make(1)
    ckpt = tmp_path / "xe.ckpt"
    train_crossencoder(half, triples, tok, checkpoint_path=str(ckpt), checkpoint_every=3,
                       **{**kw, "epochs": 1})
    resumed = make(42)
    resumed.restore(ckpt)
    h_res = train_crossencoder(resumed, triples, tok, **kw)
    assert 0 < len(h_res) < len(h_full)
    assert [m["loss"] for m in h_res] == [m["loss"] for m in h_full[len(h_full) - len(h_res):]]
    _same_params(resumed.params, full.params)


_HYGIENE = """
import json, sys
import numpy as np
from review_recommender_tpu_torch.models.bert import BertConfig, init_state_dict
from review_recommender_tpu_torch.models.load import load_biencoder, save_native_tower
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from review_recommender_tpu_torch.train import ContrastiveTrainer, TrainConfig, make_pair_batch
cfg = BertConfig(vocab_size=256, hidden_size=32, num_layers=1, num_heads=2,
                 intermediate_size=64, max_position=64)
tr = ContrastiveTrainer(cfg, init_state_dict(cfg, "biencoder", 0), device="cpu",
                        train_cfg=TrainConfig(learning_rate=1e-3))
tok = HashTokenizer(256)
m = tr.train_step(*make_pair_batch(tok, ["a b", "c d"], ["a b e", "c d f"], max_len=8, pad_to=8))
save_native_tower(sys.argv[1], "biencoder", cfg, tr.params, tok)
emb = load_biencoder(sys.argv[1], device="cpu").encode(["a b"])
bad = sorted(x for x in sys.modules if x in ("jax", "flax", "optax", "msgpack")
             or x == "review_recommender_tpu" or x.startswith("review_recommender_tpu."))
print(json.dumps({"loss": m["loss"], "shape": list(emb.shape), "bad": bad}))
"""


def test_training_imports_nothing_of_jax(tmp_path):
    """A fresh interpreter trains a step, saves the tower and loads it
    without loading jax, flax, optax, msgpack or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", _HYGIENE, str(tmp_path / "bi")], env=env,
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["shape"] == [1, 32] and np.isfinite(res["loss"])


@pytest.mark.parametrize("make", [
    lambda: ContrastiveTrainer(CFG, init_state_dict(CFG, "biencoder", 0)),
    lambda: CrossEncoderTrainer(CFG, init_state_dict(CFG, "crossencoder", 0)),
    lambda: MLMTrainer(CFG, init_state_dict(CFG, "mlm", 0)),
], ids=["contrastive", "cross", "mlm"])
def test_trainers_run_on_the_card_unless_told_otherwise(make):
    """device defaults to "cuda", and asking for it without CUDA raises:
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is there")
    with pytest.raises(RuntimeError, match="cuda"):
        make()
