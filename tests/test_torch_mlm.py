"""The port's MLM pretraining (train/mlm.py) against the JAX package's on
the CPU, from one flax init carried over by params_from_flax(kind="mlm"):
the model's logits within 1e-5 in f32; one step's loss and masked
accuracy within 1e-5, gradients within 1e-5 relative (1e-6 absolute) and
parameters within 1e-6 (tests/test_torch_train.py's rules), with and
without clipping; five scheduled steps within 1e-4; one bf16 step within
2e-2; make_mlm_batch's arrays equal JAX's under the same Generator;
pretrain_mlm's loop, its checkpoint and the graft of its trunk."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from review_recommender_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from review_recommender_tpu.models.tokenizer import WordPieceTokenizer as JWordPiece
from review_recommender_tpu.train import mlm as jmlm
from review_recommender_tpu_torch.models.bert import init_state_dict
from review_recommender_tpu_torch.models.convert import flax_from_params, params_from_flax
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer, WordPieceTokenizer
from review_recommender_tpu_torch.train import mlm as pmlm
from review_recommender_tpu_torch.train.cross_encoder import warm_start_from_biencoder
from tests import torch_train_cases as C
from tests.test_torch_train import check_one_step, five_step_losses, one_step_case


def test_mlm_logits_equal_jax():
    params = C.flax_init("mlm", seed=3)
    ids, mask, _labels, _w = C.batch("mlm", seed=1)
    want = jmlm.MLMModel(C.JCFG, dtype=jnp.float32).apply({"params": params}, ids, mask)
    with torch.device("meta"):
        model = pmlm.MLMModel(C.CFG, dtype=torch.float32)
    model = model.to_empty(device="cpu")
    model.load_state_dict(params_from_flax(params, C.CFG, "mlm"))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("clip", [False, True])
def test_one_mlm_step_matches_jax(clip):
    case = one_step_case("mlm", clip)
    assert (case["gnorm"] >= case["max_norm"]) == clip
    check_one_step(case)


def test_five_scheduled_mlm_steps_track_jax():
    losses = five_step_losses("mlm")
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=0, atol=1e-4)


def test_one_bf16_mlm_step_loss_within_2e_2():
    losses = five_step_losses("mlm", dtype=torch.bfloat16, steps=1)
    assert np.all(np.isfinite(losses)) and abs(losses[0, 0] - losses[0, 1]) <= 2e-2, losses


@pytest.mark.parametrize("seed,mask_prob", [(0, 0.15), (1, 0.3), (2, 0.02)])
def test_make_mlm_batch_equals_jax(seed, mask_prob):
    texts = C.texts(12, seed=seed, length=int(3 + 2 * seed)) + ["", "one"]
    got = pmlm.make_mlm_batch(HashTokenizer(512), texts, max_len=16, mask_prob=mask_prob,
                              rng=np.random.default_rng(seed))
    want = jmlm.make_mlm_batch(JHashTokenizer(512), texts, max_len=16, mask_prob=mask_prob,
                               rng=np.random.default_rng(seed))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got[3].sum(axis=1)[:12] >= 1).all()


def test_make_mlm_batch_with_wordpiece_equals_jax():
    words = "[PAD] [UNK] [CLS] [SEP] [MASK] soft yellow socks".split()
    vocab = {w: i for i, w in enumerate(words)}
    kw = dict(max_len=8, mask_prob=0.5)
    got = pmlm.make_mlm_batch(WordPieceTokenizer(vocab), ["soft yellow socks"] * 4,
                              rng=np.random.default_rng(2), **kw)
    want = jmlm.make_mlm_batch(JWordPiece(vocab), ["soft yellow socks"] * 4,
                               rng=np.random.default_rng(2), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_pretrain_loop_checkpoint_and_graft(tmp_path):
    """pretrain_mlm's stream equals JAX's (the same masked batches), its
    checkpoint holds the step, and its trunk grafts into a cross-encoder."""
    texts = C.texts(20, seed=5)
    params = C.flax_init("mlm", seed=1)
    kw = dict(batch_size=4, steps=3, max_len=16, seed=2, log_every=0)
    p = pmlm.MLMTrainer(C.CFG, params_from_flax(params, C.CFG, "mlm"), dtype=torch.float32,
                        device="cpu", train_cfg=pmlm.MLMTrainConfig(learning_rate=1e-3))
    j = jmlm.MLMTrainer(C.JCFG, jax.tree.map(jnp.asarray, params), dtype=jnp.float32,
                        train_cfg=jmlm.MLMTrainConfig(learning_rate=1e-3))
    ph = pmlm.pretrain_mlm(p, texts, HashTokenizer(C.VOCAB), checkpoint_path=tmp_path / "m.ckpt",
                           **kw)
    jh = jmlm.pretrain_mlm(j, texts, JHashTokenizer(C.VOCAB), **kw)
    assert [m["step"] for m in ph] == [1, 2, 3]
    np.testing.assert_allclose([m["loss"] for m in ph], [m["loss"] for m in jh], rtol=0,
                               atol=1e-4)
    state = torch.load(tmp_path / "m.ckpt", weights_only=True)
    assert state["step"] == 3 and not (tmp_path / "m.tmp").exists()
    xe = init_state_dict(C.CFG, "crossencoder", seed=2)
    out = warm_start_from_biencoder(xe, p.params)
    assert torch.equal(out["encoder.word_embeddings.weight"],
                       p.params["encoder.word_embeddings.weight"])
    assert torch.equal(out["pooler.weight"], xe["pooler.weight"])
    assert sorted(flax_from_params(out, C.CFG, "crossencoder")) == ["classifier", "encoder",
                                                                    "pooler"]


def test_init_mlm_is_seeded():
    _m, a = pmlm.init_mlm(C.CFG, seed=4)
    _m, b = pmlm.init_mlm(C.CFG, seed=4)
    assert sorted(a) == sorted(init_state_dict(C.CFG, "mlm", 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["mlm_decoder.weight"].shape == (C.VOCAB, C.CFG.hidden_size)
