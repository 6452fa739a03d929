"""The port's dp x tp training (parallel/mesh.py, parallel/tp_bert.py, the
trainers' mesh=) against the JAX trainers on the 8 virtual CPU devices of
tests/conftest.py, from one flax init carried over by params_from_flax
(tests/torch_train_cases.py: the tiny config, f32).

  specs        param_specs equals JAX's param_specs for the bi-encoder,
               cross-encoder and MLM trees, leaf for leaf, through
               flax_from_params' names and transposes;
  one step     each trainer on a (4, 2) JAX mesh against the port's
               TrainMesh(["cpu"] * 8, 4, 2): loss and metric within 1e-5,
               gradients within 1e-5 relative (1e-6 absolute), parameters
               after the AdamW step as tests/test_torch_train.py's
               check_one_step holds them, with and without the clip; the
               port's mesh step equals its one-device step by the same
               rules at (4, 2), (1, 8), (2, 4) and (8, 1);
  splits       JAX refuses every split that does not divide (tp = 3 over
               hidden 64, vocab 30522 over tp = 4 at device_put; a batch of
               6 over dp = 4 at the call), and so does the port; JAX runs
               tp = 8 over the tiny config's 4 heads and a 6-head tower over
               tp = 4 (hidden and FFN split evenly, heads not), and the port
               runs them with whole heads a rank (some ranks none) and
               matches;
  remat        remat=True on the mesh changes nothing;
  checkpoints  mesh -> one device and one device -> mesh: the state
               restored exactly, the next step's loss within 1e-6 of the
               saving trainer's own next step;
  refusals     a list that mixes CUDA and the CPU, a wrong device count.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from review_recommender_tpu.models import bert as jbert
from review_recommender_tpu.train import contrastive as jcon
from review_recommender_tpu_torch.models.bert import BertConfig, init_state_dict
from review_recommender_tpu_torch.models.convert import flax_from_params, params_from_flax
from review_recommender_tpu_torch.parallel import tp_bert
from review_recommender_tpu_torch.parallel.mesh import TrainMesh
from review_recommender_tpu_torch.train import contrastive as pcon
from review_recommender_tpu_torch.train import param_specs, shard_params
from tests import torch_train_cases as C
from tests.test_torch_train import assert_step_close, check_one_step

KINDS = ["contrastive", "cross", "mlm"]
MESH = (4, 2)


def jax_mesh(dp, tp):
    return Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp), ("dp", "tp"))


def port_mesh(dp, tp):
    return TrainMesh(["cpu"] * (dp * tp), dp, tp)


def _batch_shardings(mesh, batch):
    return [jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("dp", *[None] * (a.ndim - 1))))
            for a in batch]


@functools.lru_cache(maxsize=None)
def flax_init(kind, jcfg=C.JCFG, seed=0):
    """The flax init of `kind`'s model at `jcfg`, f32 numpy leaves."""
    _, params = C.KINDS[kind][1](jcfg, seed=seed, dtype=jnp.float32)
    return jax.tree.map(np.asarray, params)


def jax_mesh_trainer(kind, tc_kw, shape=MESH, dtype=torch.float32, jcfg=C.JCFG):
    """The JAX trainer of `kind` on a (dp, tp) JAX mesh from flax_init."""
    _model_kind, _init, (jtr, jtc), _port = C.KINDS[kind]
    return jtr(jcfg, jax.tree.map(jnp.asarray, flax_init(kind, jcfg)), train_cfg=jtc(**tc_kw),
               mesh=jax_mesh(*shape), dtype=C.JDTYPE[dtype])


def port_trainer(kind, tc_kw, shape=MESH, dtype=torch.float32, cfg=C.CFG, jcfg=C.JCFG):
    """The port trainer of `kind` from the same init: on a TrainMesh of
    CPUs, or on one CPU device where shape is None."""
    model_kind, _init, _jax, (ptr, ptc) = C.KINDS[kind]
    kw = {"device": "cpu"} if shape is None else {"mesh": port_mesh(*shape)}
    return ptr(cfg, params_from_flax(flax_init(kind, jcfg), cfg, model_kind),
               train_cfg=ptc(**tc_kw), dtype=dtype, **kw)


@functools.lru_cache(maxsize=None)
def jax_mesh_loss_and_grads(kind, shape=MESH, dtype=torch.float32, jcfg=C.JCFG):
    """The JAX mesh trainer's loss, metric and gradients at the flax init
    on C.batch(kind), its params and batch sharded as its step shards
    them (one jit of value_and_grad)."""
    jtr = jax_mesh_trainer(kind, {}, shape, dtype, jcfg)
    (loss, metric), grads = jax.jit(jax.value_and_grad(jtr._loss, has_aux=True))(
        jtr.params, *_batch_shardings(jtr.mesh, C.batch(kind)))
    return float(loss), float(metric), jax.tree.map(np.asarray, grads)


def _optax_step(kind, tc_kw, grads):
    """The JAX trainers' optax chain (a one-device JAX trainer's `tx`) from
    the flax init: AdamW is elementwise, so the sharded update is this."""
    _model_kind, _init, (jtr, jtc), _port = C.KINDS[kind]
    start = jax.tree.map(jnp.asarray, flax_init(kind))
    tx = jtr(C.JCFG, start, train_cfg=jtc(**tc_kw), dtype=jnp.float32).tx
    updates, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(start), start)
    return jax.tree.map(np.asarray, optax.apply_updates(start, updates))


def _port_step(kind, shape, tc_kw, dtype=torch.float32, cfg=C.CFG, jcfg=C.JCFG):
    """The port trainer's loss, metric, gradients (flax trees) and params
    after one step on C.batch(kind), on a TrainMesh or one CPU device."""
    tr = port_trainer(kind, tc_kw, shape, dtype, cfg, jcfg)
    loss, metric = tr._batch_loss(C.batch(kind))
    loss.backward()
    grads = flax_from_params(tr.gradients(), cfg, C.KINDS[kind][0])
    tr.optim.step(0)
    return loss.item(), metric.item(), grads, flax_from_params(tr.params, cfg, C.KINDS[kind][0])


def mesh_step_case(kind, clip):
    """check_one_step's case for the port's (4, 2) mesh step against the
    JAX (4, 2) mesh (constant lr 1e-3; max_grad_norm 1e-3 clips, 1e3 does
    not)."""
    tc = {"learning_rate": 1e-3, "max_grad_norm": 1e-3 if clip else 1e3}
    jloss, jmetric, jgrads = jax_mesh_loss_and_grads(kind)
    ploss, pmetric, pgrads, port = _port_step(kind, MESH, tc)
    return {"loss": (ploss, jloss), "metric": (pmetric, jmetric), "grads": (pgrads, jgrads),
            "update": (port, _optax_step(kind, tc, pgrads)),
            "params": (port, _optax_step(kind, tc, jgrads)),
            "gnorm": float(optax.global_norm(jgrads)), "max_norm": tc["max_grad_norm"]}


# --------------------------------------------------------------------- specs
def _spec_markers(sd, specs):
    """Each tensor as an index grid along its split dim (zeros where it is
    replicated), so flax_from_params' transposes move the split axis."""
    out = {}
    for name, t in sd.items():
        dim = specs[name]
        shape = [1] * t.dim()
        if dim is not None:
            shape[dim] = t.shape[dim]
        grid = torch.zeros(t.shape) if dim is None else torch.arange(
            1, t.shape[dim] + 1, dtype=torch.float32).reshape(shape).expand(t.shape)
        out[name] = grid.contiguous()
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("kind", KINDS)
def test_param_specs_equal_jax(kind):
    model_kind = C.KINDS[kind][0]
    flax_params = flax_init(kind)
    sd = params_from_flax(flax_params, C.CFG, model_kind)
    specs = param_specs(sd)
    assert any(d is not None for d in specs.values())
    markers = dict(_leaves(C.port_tree(kind, _spec_markers(sd, specs))))
    want = dict(_leaves(jcon.param_specs(flax_params)))
    assert sorted(markers) == sorted(want)
    for path, marker in markers.items():
        varying = [a for a in range(marker.ndim) if marker.shape[a] > 1
                   and not np.all(marker == np.take(marker, [0], axis=a))]
        if not marker.any():
            got = P()
        else:
            assert len(varying) == 1, path
            got = P(*["tp" if a == varying[0] else None for a in range(marker.ndim)])
        assert got == want[path], (path, got, want[path])


def test_shard_params_places_whole_heads_and_gathers_back():
    cfg = dataclasses.replace(C.CFG, hidden_size=96, num_heads=6, intermediate_size=192,
                              num_layers=1)
    sd = init_state_dict(cfg, "biencoder", 3)
    shards = shard_params(sd, port_mesh(2, 4), cfg.num_heads)
    q = shards["encoder.layers.0.attention.query.weight"]
    assert [t.shape[0] for t in q] == [32, 32, 16, 16]  # heads 2, 2, 1, 1 of width 16
    assert [t.shape[1] for t in shards["encoder.layers.0.attention.output_dense.weight"]] \
        == [32, 32, 16, 16]
    assert [t.shape[0] for t in shards["encoder.layers.0.intermediate.weight"]] == [48] * 4
    assert [t.shape[0] for t in shards["encoder.word_embeddings.weight"]] == [96] * 4
    assert len(shards["encoder.layers.0.output.bias"]) == 1  # replicated: added once
    back = tp_bert.gather_params(shards, torch.device("cpu"))
    for name, t in sd.items():
        assert torch.equal(back[name], t), name
        assert all(s.data_ptr() != t.data_ptr() for s in shards[name])  # copies, not views


# ------------------------------------------------------------------ one step
@pytest.mark.parametrize("kind,clip", [(k, c) for k in KINDS for c in (False, True)])
def test_mesh_step_matches_jax_mesh(kind, clip):
    case = mesh_step_case(kind, clip)
    assert (case["gnorm"] >= case["max_norm"]) == clip
    check_one_step(case)


@pytest.mark.parametrize("kind,shape", [(k, s) for k in KINDS for s in
                                        ((4, 2), (1, 8), (2, 4), (8, 1))])
def test_mesh_step_equals_the_one_device_step(kind, shape):
    tc = {"learning_rate": 1e-3}
    ol, om, og, op = _port_step(kind, None, tc)
    ml, mm, mg, mp = _port_step(kind, shape, tc)
    assert abs(ml - ol) <= 1e-5 and abs(mm - om) <= 1e-5
    C.assert_trees_close(mg, og, rtol=1e-5, atol=1e-6)
    assert_step_close(mp, op, og)


def test_one_bf16_mesh_step_loss_within_2e_2():
    jl, _jm, _jg = jax_mesh_loss_and_grads("contrastive", MESH, torch.bfloat16)
    tr = port_trainer("contrastive", {"learning_rate": 1e-3}, MESH, torch.bfloat16)
    pl = tr.train_step(*C.batch("contrastive"))["loss"]
    assert np.isfinite(pl) and abs(pl - jl) <= 2e-2, (pl, jl)


# -------------------------------------------------------------------- splits
TP3_CFG = (BertConfig.tiny(C.VOCAB), jbert.BertConfig.tiny(C.VOCAB))
VOCAB_CFG = (BertConfig.tiny(30522), jbert.BertConfig.tiny(30522))


@pytest.mark.parametrize("case", ["tp3_over_hidden_64", "vocab_30522_over_tp4"])
def test_uneven_param_splits_raise_as_in_jax(case):
    (cfg, jcfg), shape = {"tp3_over_hidden_64": (TP3_CFG, (2, 3)),
                          "vocab_30522_over_tp4": (VOCAB_CFG, (2, 4))}[case]
    with pytest.raises(ValueError, match="divisible"):
        jax_mesh_trainer("contrastive", {}, shape, jcfg=jcfg)
    sd = init_state_dict(cfg, "biencoder", 0)
    with pytest.raises(ValueError, match=f"does not split over tp={shape[1]}"):
        pcon.ContrastiveTrainer(cfg, sd, mesh=port_mesh(*shape), dtype=torch.float32)


def test_batch_that_dp_does_not_divide_raises_as_in_jax():
    jtr, ptr = jax_mesh_trainer("contrastive", {}), port_trainer("contrastive", {})
    b = [a[:6] for a in C.batch("contrastive")]
    with pytest.raises(ValueError, match="divisible by 4"):
        jtr.train_step(*b)
    with pytest.raises(ValueError, match="6 rows does not split over dp=4"):
        ptr.train_step(*b)
    assert ptr.step == jtr.step == 0


SIX_HEADS = (dataclasses.replace(C.CFG, hidden_size=96, num_heads=6, intermediate_size=192),
             dataclasses.replace(C.JCFG, hidden_size=96, num_heads=6, intermediate_size=192))


@pytest.mark.parametrize("case", ["tp8_over_4_heads", "tp4_over_6_heads"])
def test_head_splits_jax_runs_match(case):
    """Hidden, FFN and vocab split evenly, heads do not: JAX runs (GSPMD
    reshards the heads), the port runs whole heads a rank; loss, metric
    and gradients as the one-step test holds them."""
    (cfg, jcfg), shape = {"tp8_over_4_heads": ((C.CFG, C.JCFG), (1, 8)),
                          "tp4_over_6_heads": (SIX_HEADS, (2, 4))}[case]
    tr = port_trainer("contrastive", {}, shape, cfg=cfg, jcfg=jcfg)
    heads = [t.shape[0] // (cfg.hidden_size // cfg.num_heads)
             for t in tr.shards["encoder.layers.0.attention.query.weight"]]
    assert heads == {"tp8_over_4_heads": [1, 1, 1, 1, 0, 0, 0, 0],
                     "tp4_over_6_heads": [2, 2, 1, 1]}[case]
    jl, jm, jg = jax_mesh_loss_and_grads("contrastive", shape, jcfg=jcfg)
    pl, pm, pg, _ = _port_step("contrastive", shape, {}, cfg=cfg, jcfg=jcfg)
    assert abs(pl - jl) <= 1e-5 and abs(pm - jm) <= 1e-5, (pl, jl, pm, jm)
    C.assert_trees_close(pg, jg, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- remat, ckpt
def test_remat_on_the_mesh_changes_nothing():
    sd = params_from_flax(flax_init("contrastive"), C.CFG, "biencoder")
    losses, trees = [], []
    for remat in (False, True):
        tr = pcon.ContrastiveTrainer(C.CFG, sd, mesh=port_mesh(*MESH), dtype=torch.float32,
                                     train_cfg=pcon.TrainConfig(learning_rate=1e-3, remat=remat))
        assert tr.tp_model.remat == remat
        losses.append([tr.train_step(*C.batch("contrastive", s))["loss"] for s in range(2)])
        trees.append(C.port_tree("contrastive", tr.params))
    assert losses[0] == losses[1]
    C.assert_trees_close(trees[1], trees[0], rtol=0, atol=0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("direction", ["mesh_to_one", "one_to_mesh"])
def test_checkpoints_restore_across_layouts(kind, direction, tmp_path):
    """Two steps, save, restore in the other layout (params and AdamW
    moments equal to the checkpoint's exactly), a third step: its loss
    within 1e-6 of the saving trainer's own third step."""
    model_kind, _i, _j, (ptr, ptc) = C.KINDS[kind]
    sd = params_from_flax(flax_init(kind), C.CFG, model_kind)
    tc = ptc(learning_rate=1e-3, total_steps=6, warmup_steps=1)
    layouts = {"one": {"device": "cpu"}, "mesh": {"mesh": port_mesh(*MESH)}}
    src, dst = direction.split("_to_")
    make = lambda layout: ptr(C.CFG, sd, train_cfg=tc, dtype=torch.float32, **layouts[layout])
    first = make(src)
    for s in range(2):
        first.train_step(*C.batch(kind, s))
    first.save(tmp_path / "ckpt.pt")
    resumed = make(dst)
    resumed.restore(tmp_path / "ckpt.pt")
    assert resumed.step == 2
    saved = torch.load(tmp_path / "ckpt.pt", weights_only=True)
    for name, t in resumed.params.items():
        assert torch.equal(t, saved["params"][name]), name
    state = resumed._opt_state()["state"]
    assert sorted(state) == sorted(saved["opt_state"]["state"])
    for i, st in saved["opt_state"]["state"].items():
        for key, v in st.items():
            assert torch.equal(state[i][key].cpu(), v), (i, key)
    got = resumed.train_step(*C.batch(kind, 2))["loss"]
    want = first.train_step(*C.batch(kind, 2))["loss"]
    assert abs(got - want) <= 1e-6, (got, want)


def test_mesh_checkpoint_is_the_one_device_layout(tmp_path):
    sd = params_from_flax(flax_init("contrastive"), C.CFG, "biencoder")
    one = pcon.ContrastiveTrainer(C.CFG, sd, device="cpu", dtype=torch.float32)
    mesh = pcon.ContrastiveTrainer(C.CFG, sd, mesh=port_mesh(*MESH), dtype=torch.float32)
    for tr, name in ((one, "one.pt"), (mesh, "mesh.pt")):
        tr.train_step(*C.batch("contrastive"))
        tr.save(tmp_path / name)
    a, b = (torch.load(tmp_path / n, weights_only=True) for n in ("one.pt", "mesh.pt"))
    assert list(a["params"]) == list(b["params"])
    assert sorted(a["opt_state"]["state"]) == sorted(b["opt_state"]["state"])
    for i, st in a["opt_state"]["state"].items():
        for key, v in st.items():
            assert b["opt_state"]["state"][i][key].shape == v.shape, (i, key)
    assert a["opt_state"]["param_groups"][0]["params"] == b["opt_state"]["param_groups"][0][
        "params"]


# ------------------------------------------------------------------ refusals
def test_a_list_mixing_cuda_and_the_cpu_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="mix types"):
        TrainMesh(["cuda:0", "cpu", "cuda:0", "cpu"], 2, 2)


@pytest.mark.parametrize("n,dp,tp", [(7, 4, 2), (9, 4, 2), (4, 1, 8)])
def test_a_wrong_device_count_is_refused(n, dp, tp):
    with pytest.raises(ValueError, match=f"needs {dp * tp} devices, got {n}"):
        TrainMesh(["cpu"] * n, dp, tp)


@pytest.mark.parametrize("dp,tp", [(0, 2), (2, 0)])
def test_an_empty_axis_is_refused(dp, tp):
    with pytest.raises(ValueError, match="at least 1"):
        TrainMesh(["cpu"] * 2, dp, tp)


def test_the_train_package_exports_the_tp_layout():
    from review_recommender_tpu_torch import train

    assert train.param_specs is tp_bert.param_specs and train.shard_params is tp_bert.shard_params
    assert pcon.TP_RULES is tp_bert.TP_RULES and len(pcon.TP_RULES) == len(jcon.TP_RULES)
