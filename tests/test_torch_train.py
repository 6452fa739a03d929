"""The port's training (review_recommender_tpu_torch/train/) against the JAX
package's on the CPU, from one flax init carried over by params_from_flax.

In f32: one step of the contrastive and cross-encoder trainers gives the
loss and metric within 1e-5, every gradient leaf within 1e-5 relative
(1e-6 absolute), and every parameter after the AdamW update within 1e-6
of optax's update from the same gradients and, wherever the gradient is
at least 1e-5 (assert_step_close says why), of JAX's own step, also with
max_grad_norm small enough that optax's clipping triggers; five
steps under a warmup + cosine schedule track JAX's losses within 1e-4;
make_lr equals the optax schedule at every step. One step in bf16 (the
default dtype) gives the loss within 2e-2: the frameworks round the bf16
products at other places. The host code (pair and triple mining, batch
iteration, tokenized batches, the trunk graft) is equal exactly; remat
changes nothing; towers the port saves load in the JAX loaders (and the
JAX package's in the port's) with equal outputs within 1e-5; both CLIs'
`train` on one bundle mine the same pairs and write towers that both
loaders serve. The MLM trainer's cases are in tests/test_torch_mlm.py;
the card's cases in tests/test_torch_gpu.py.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from review_recommender_tpu.models import load as jload
from review_recommender_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from review_recommender_tpu.train import contrastive as jcon
from review_recommender_tpu.train import cross_encoder as jxe
from review_recommender_tpu.train import data as jdata
from review_recommender_tpu_torch.models import load as pload
from review_recommender_tpu_torch.models.convert import flax_from_params, params_from_flax
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
from review_recommender_tpu_torch.train import contrastive as pcon
from review_recommender_tpu_torch.train import cross_encoder as pxe
from review_recommender_tpu_torch.train import data as pdata
from review_recommender_tpu_torch.train import optim as poptim
from tests import torch_train_cases as C

ONE_STEP = [(kind, clip) for kind in ("contrastive", "cross") for clip in (False, True)]


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(kind):
    """The JAX trainer's loss, metric and gradients at the flax init on
    C.batch(kind), under one jax.jit(value_and_grad): the clipped and the
    unclipped case share them, as their loss does not read the clip."""
    jtr, _ = C.trainers(kind, {})
    (jloss, jmetric), jgrads = jax.jit(jax.value_and_grad(jtr._loss, has_aux=True))(
        jtr.params, *map(jnp.asarray, C.batch(kind)))
    return float(jloss), float(jmetric), jax.tree.map(np.asarray, jgrads)


def one_step_case(kind, clip):
    """One step of the JAX and port trainers on the same batch (constant lr
    1e-3; max_grad_norm 1e-3 makes optax clip, 1e3 does not): loss,
    metric and gradients of both (the JAX trainer's loss under
    jax.value_and_grad); the port's parameters after its update, beside
    the JAX trainer's optax chain applied to the port's gradients and to
    JAX's own (the JAX step)."""
    tc = {"learning_rate": 1e-3, "max_grad_norm": 1e-3 if clip else 1e3}
    jtr, ptr = C.trainers(kind, tc)
    start = jtr.params
    b = C.batch(kind)
    jloss, jmetric, jgrads = jax_loss_and_grads(kind)
    ploss, pmetric = ptr._loss(*ptr._tensors(b))
    ploss.backward()
    pgrads = C.port_tree(kind, {n: p.grad for n, p in ptr.model.named_parameters()})
    ptr.optim.step(0)

    def optax_step(grads):
        updates, _ = jtr.tx.update(grads, jtr.tx.init(start), start)
        return jax.tree.map(np.asarray, optax.apply_updates(start, updates))

    port = C.port_tree(kind, ptr.params)
    return {"loss": (ploss.item(), jloss), "metric": (pmetric.item(), jmetric),
            "grads": (pgrads, jgrads),
            "update": (port, optax_step(jax.tree.map(jnp.asarray, pgrads))),
            "params": (port, optax_step(jax.tree.map(jnp.asarray, jgrads))),
            "gnorm": float(optax.global_norm(jgrads)), "max_norm": tc["max_grad_norm"]}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree, np.float32)


def assert_step_close(got, want, grads, atol=1e-6, min_grad=1e-5):
    """Parameters after one AdamW step, within atol wherever the gradient
    is at least min_grad. Adam's first step is lr * g / (|g| + 1e-8), which
    turns a gradient's relative error r into up to lr * r / 4 in the
    parameter: on an element whose gradient is near the f32 rounding noise
    of the backward (1e-9 to 1e-8 here), such as every attention key bias,
    whose gradient is zero in exact arithmetic because the softmax cancels
    it, r is large, and the two frameworks' noise differs. Those elements
    are held to optax by the update from the same gradients instead."""
    checked = total = 0
    for (path, g), (_, w), (_, gr) in zip(_leaves(got), _leaves(want), _leaves(grads)):
        live = np.abs(gr) >= min_grad
        np.testing.assert_allclose(g[live], w[live], rtol=0, atol=atol, err_msg=path)
        checked, total = checked + int(live.sum()), total + live.size
    assert checked > total // 2, (checked, total)


def check_one_step(case):
    (pl, jl), (pa, ja) = case["loss"], case["metric"]
    assert abs(pl - jl) <= 1e-5 and abs(pa - ja) <= 1e-5
    C.assert_trees_close(*case["grads"], rtol=1e-5, atol=1e-6)
    C.assert_trees_close(*case["update"], rtol=0, atol=1e-6)
    assert_step_close(*case["params"], case["grads"][1])


@pytest.mark.parametrize("kind,clip", ONE_STEP)
def test_one_step_matches_jax(kind, clip):
    case = one_step_case(kind, clip)
    assert (case["gnorm"] >= case["max_norm"]) == clip  # the clipped case does clip
    check_one_step(case)


def five_step_losses(kind, dtype=torch.float32, steps=5):
    tc = {"learning_rate": 1e-3, "total_steps": 10, "warmup_steps": 3}
    jtr, ptr = C.trainers(kind, tc, dtype=dtype)
    out = []
    for i in range(steps):
        b = C.batch(kind, seed=i)
        out.append((ptr.train_step(*b)["loss"], jtr.train_step(*b)["loss"]))
    return np.asarray(out)


@pytest.mark.parametrize("kind", ["contrastive", "cross"])
def test_five_scheduled_steps_track_jax(kind):
    losses = five_step_losses(kind)
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=0, atol=1e-4)
    assert len(set(np.round(losses[:, 0], 6))) > 1  # the steps train


@pytest.mark.parametrize("kind", ["contrastive", "cross"])
def test_one_bf16_step_loss_within_2e_2(kind):
    losses = five_step_losses(kind, dtype=torch.bfloat16, steps=1)
    assert np.all(np.isfinite(losses))
    assert abs(losses[0, 0] - losses[0, 1]) <= 2e-2, losses


@pytest.mark.parametrize("tc", [
    {"learning_rate": 1e-3, "total_steps": 10, "warmup_steps": 3},
    {"learning_rate": 5e-4, "total_steps": 37, "warmup_steps": 0},
    {"learning_rate": 2e-5, "total_steps": 0},
])
def test_make_lr_equals_the_optax_schedule(tc):
    cfg = pcon.TrainConfig(**tc)
    mine, theirs = poptim.make_lr(cfg), jcon.make_lr(jcon.TrainConfig(**tc))
    if not tc["total_steps"]:
        assert mine == theirs == tc["learning_rate"]
        return
    for step in range(tc["total_steps"] + 3):
        want = float(theirs(jnp.int32(step)))
        assert mine(step) == pytest.approx(want, rel=1e-6, abs=1e-12), step
    assert mine(0) == 0.0  # the first update's lr under a warmup


def test_remat_changes_nothing():
    params = params_from_flax(C.flax_init("contrastive"), C.CFG, "biencoder")
    losses, trees = [], []
    for remat in (False, True):
        tr = pcon.ContrastiveTrainer(C.CFG, params, device="cpu", dtype=torch.float32,
                                     train_cfg=pcon.TrainConfig(learning_rate=1e-3, remat=remat))
        losses.append([tr.train_step(*C.batch("contrastive", s))["loss"] for s in range(2)])
        trees.append(C.port_tree("contrastive", tr.params))
    assert losses[0] == losses[1]
    C.assert_trees_close(trees[1], trees[0], rtol=0, atol=0)


# ----------------------------------------------------------------- host code
@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(3)
    words = [f"{w}{s}" for w in ("soft", "blue", "steel", "mesh", "cable", "knife", "shoe",
                                 "phone", "lamp", "sock", "bag", "desk")
             for s in ("", "er", "ing", "est")] + ["the", "great", "very"]
    skus = [f"P{i:03d}" for i in range(24)]
    products = [" ".join(rng.choice(words, size=16)) for _ in skus]
    rev_skus = [skus[int(i)] for i in rng.integers(0, 24, size=120)] + ["ghost"]
    reviews = [" ".join(rng.choice(words, size=int(rng.integers(2, 12)))) for _ in rev_skus]
    return reviews, rev_skus, skus, products


@pytest.mark.parametrize("kw", [{}, {"keywords_per_query": 3, "max_pairs_per_product": 2,
                                     "seed": 7}])
def test_mine_pairs_equals_jax(corpus, kw):
    got = pdata.mine_pairs(*corpus, **kw)
    assert got and got == jdata.mine_pairs(*corpus, **kw)


@pytest.mark.parametrize("hard", [False, True])
def test_mine_triples_equals_jax(corpus, hard):
    pairs = pdata.mine_pairs(*corpus)

    def hard_fn(query, k):  # the positive among the candidates is skipped
        return [corpus[3][len(query) % 24]] + corpus[3][:k]

    kw = {"n_negatives": 3, "seed": 5, "hard_negative_fn": hard_fn if hard else None}
    got = pdata.mine_triples(pairs, corpus[3], **kw)
    assert got == jdata.mine_triples(pairs, corpus[3], **kw)
    assert len(got) == 4 * len(pairs)


@pytest.mark.parametrize("kw", [{}, {"batch_order_only": True}, {"start_step": 3},
                                {"batch_order_only": True, "start_step": 2, "epochs": 2},
                                {"drop_remainder": False, "epochs": 2}])
def test_iterate_batches_equals_jax(corpus, kw):
    pairs = pdata.mine_pairs(*corpus)
    args = dict(batch_size=5, max_len=20, seed=11, **kw)
    got = list(pdata.iterate_batches(pairs, HashTokenizer(512), **args))
    want = list(jdata.iterate_batches(pairs, JHashTokenizer(512), **args))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_pair_and_triple_batches_equal_jax(corpus):
    reviews, _s, _k, products = corpus
    for got, want in ((pcon.make_pair_batch(HashTokenizer(512), reviews[:6], products[:6],
                                            max_len=16),
                       jcon.make_pair_batch(JHashTokenizer(512), reviews[:6], products[:6],
                                            max_len=16)),
                      (pxe.make_triple_batch(HashTokenizer(512), reviews[:6], products[:6],
                                             [1, 0, 0, 1, 0, 0], max_len=24, pad_to=24),
                       jxe.make_triple_batch(JHashTokenizer(512), reviews[:6], products[:6],
                                             [1, 0, 0, 1, 0, 0], max_len=24, pad_to=24))):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src_max_position", [64, 128, 32])
def test_warm_start_equals_jax(src_max_position):
    """The trunk of an MLM model grafted into a cross-encoder, across
    another max_position (rows copied where both have them)."""
    from review_recommender_tpu.train.mlm import init_mlm

    src_cfg = dataclasses.replace(C.JCFG, max_position=src_max_position)
    _, src = init_mlm(src_cfg, seed=4, dtype=jnp.float32)
    src = jax.tree.map(np.asarray, src)
    xe = C.flax_init("cross", seed=9)
    want = jax.tree.map(np.asarray, jxe.warm_start_from_biencoder(xe, src))
    port_src_cfg = dataclasses.replace(C.CFG, max_position=src_max_position)
    xe_sd = params_from_flax(xe, C.CFG, "crossencoder")
    before = {k: v.clone() for k, v in xe_sd.items()}
    got = pxe.warm_start_from_biencoder(xe_sd, params_from_flax(src, port_src_cfg, "mlm"))
    C.assert_trees_close(flax_from_params(got, C.CFG, "crossencoder"), want, rtol=0, atol=0)
    assert all(torch.equal(before[k], xe_sd[k]) for k in before)  # the input is unchanged


def test_warm_start_refuses_another_trunk():
    xe = params_from_flax(C.flax_init("cross"), C.CFG, "crossencoder")
    bi = dict(params_from_flax(C.flax_init("contrastive"), C.CFG, "biencoder"))
    bi.pop("encoder.layers.1.output.bias")
    with pytest.raises(ValueError, match="same parameters"):
        pxe.warm_start_from_biencoder(xe, bi)


# ------------------------------------------------------------- tower files
def test_port_saved_towers_load_in_jax_and_the_port(tmp_path):
    """A tower the port trains and saves loads in the JAX native loaders and
    in the port's; embeddings and scores agree within 1e-5 in f32."""
    tok = HashTokenizer(C.VOCAB)
    out = {}
    for kind, model_kind in (("contrastive", "biencoder"), ("cross", "crossencoder")):
        _j, ptr = C.trainers(kind, {"learning_rate": 1e-3})
        ptr.train_step(*C.batch(kind))
        out[model_kind] = pload.save_native_tower(tmp_path / model_kind, model_kind, C.CFG,
                                                  ptr.params, tok, pooling="cls")
    texts = C.texts(5, seed=42)
    jbe = jload.load_native_biencoder(out["biencoder"], dtype=jnp.float32, max_len=32)
    pbe = pload.load_biencoder(out["biencoder"], device="cpu", dtype=torch.float32, max_len=32)
    np.testing.assert_allclose(pbe.encode(texts), jbe.encode(texts), rtol=0, atol=1e-5)
    jce = jload.load_native_crossencoder(out["crossencoder"], dtype=jnp.float32, max_len=32)
    pce = pload.load_crossencoder(out["crossencoder"], device="cpu", dtype=torch.float32,
                                  max_len=32)
    q = ["word1 word2"] * len(texts)
    np.testing.assert_allclose(pce.score_pairs(q, texts), jce.score_pairs(q, texts), rtol=0,
                               atol=1e-5)
    meta = json.loads((out["biencoder"] / "config.json").read_text())
    assert meta["format"] == "rrt-native-v1" and meta["tokenizer"]["type"] == "hash"


def test_jax_saved_tower_loads_in_the_port(tmp_path):
    from review_recommender_tpu.models.tokenizer import WordPieceTokenizer as JWordPiece

    vocab = {t: i for i, t in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                                         + C.WORDS + ["##s"])}
    params = C.flax_init("contrastive", seed=6)
    d = jload.save_native_tower(tmp_path / "bi", "biencoder", C.JCFG,
                                jax.tree.map(jnp.asarray, params), JWordPiece(vocab))
    cfg, sd, tok, pooling = pload.load_tower_params(d, "biencoder")
    assert cfg == C.CFG and pooling == "cls" and tok.vocab == vocab
    assert all(v.dtype == torch.float32 for v in sd.values())  # trainable: f32 masters
    C.assert_trees_close(flax_from_params(sd, cfg, "biencoder"), params, rtol=0, atol=0)
    # and back: the port writes the same tower the JAX package wrote
    pload.save_native_tower(tmp_path / "again", "biencoder", cfg, sd, tok)
    assert (tmp_path / "again" / "vocab.txt").read_text() == (d / "vocab.txt").read_text()
    again = jload.load_native_biencoder(tmp_path / "again", dtype=jnp.float32, max_len=32)
    C.assert_trees_close(jax.tree.map(np.asarray, again.params), params, rtol=0, atol=0)
