"""The CUDA kernels (fused attention, packed and unpacked BM25, the fused
stage-A tile pass) against their plain torch versions, on the card.

Needs an NVIDIA Hopper GPU with nvcc; every test skips where
torch.cuda.is_available() is false. The file imports no jax, so on a
machine without jax it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Attention: tolerance 2e-2 in bf16/f16 (tests/test_attention.py's bf16
bound); the kernel divides the exponentials by the f32 row sum before it
rounds the probabilities to the input type, as the reference does, so a
probability differs from the reference's only where its f32 value lies
within an ulp or two of a rounding boundary. BM25: bitwise equal scores (tf_q
sums integers; every other step is rounded alone, in the reference's order).
Stage A: winner scores within 1e-5 (exact bf16/f32 products summed in f32 in
another order than cuBLAS's); a winner id may differ only where the plain
version's scores of the two rows are within that tolerance (a near tie);
rounds past a tile's valid rows are exactly (-3.4e38, 0). A bf16 corpus
takes the tensor-core kernel, an f32 corpus the CUDA-core one. Serving:
device_fetch reads CUDA tensors through pinned buffers, and both HTTP
front ends answer a /search on a small CUDA engine, encoding on the card.
Offline path: a bundle built, saved and loaded, then the CLI's search on
it on the card. Serving configurations: the int8 scores and pools
(torch._int_mm on padded shapes) bit-equal to the CPU int8 path; ivf_topk
on the card against its CPU run on the same index (scores within 1e-5, ids
equal but for near ties); a bge-small-shaped tower loaded from disk within
2e-2 of its CPU f32 forward. Training: the attention's gradient
(MhaKernelFn: the kernel forward, the reference's recompute backward)
against autograd through mha_reference within 2e-2 at the trainers'
shapes, a row masked but for one key, and an S off the key tile; one bf16
ContrastiveTrainer step against the CPU f32 step from the same init.
Topics: the kNN graph on the card against its CPU path at 5,000 x 384 and
on the duplicate, negative-similarity, ragged-chunk and zero-row cases
(similarities within 1e-5, ids equal but for near ties), also with TF32
turned on by the caller; density labels on the card equal the CPU's on a
well-separated mixture; `rrt topics --device cuda` writes the cards and
aspect metrics of `--device cpu` in both lanes.
"""
from pathlib import Path
import numpy as np
import pytest
import torch

from review_recommender_tpu_torch.ops import attention as tatt
from review_recommender_tpu_torch.ops import bm25_kernel as tbk
from review_recommender_tpu_torch.ops import stage_a as tsa
from review_recommender_tpu_torch.ops.bm25 import bm25_full_scores, masked_topk
from review_recommender_tpu_torch.ops.dense import matmul_f32
from tests.torch_bm25_cases import CASES, bm25_edge_case, pack
from tests.torch_stage_a_cases import CASES as STAGE_A_CASES
from tests.torch_stage_a_cases import stage_a_case

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, s, hd, dtype, device):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, hd)).astype(np.float32))
               .to(device=device, dtype=dtype) for _ in range(3))
    lens = rng.integers(1, s + 1, size=b)
    bias = np.where(np.arange(s)[None, :] < lens[:, None], 0.0, -1e30).astype(np.float32)
    if b > 1:
        bias[-1] = -1e30
    return q, k, v, torch.from_numpy(bias).to(device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,s,heads,d", [
    (64, 512, 12, 32), (1, 16, 12, 32), (8, 128, 6, 64), (4, 256, 3, 128),
    (3, 40, 2, 32), (2, 1, 4, 64), (2, 511, 1, 128), (5, 100, 3, 64),
    (1, 32, 12, 32), (50, 287, 12, 32),  # query_e2e: encode, then rerank (a ragged key tile)
])
def test_kernel_matches_reference(cuda, dtype, b, s, heads, d):
    q, k, v, bias = _inputs(b * 1000 + s, b, s, heads * d, dtype, cuda)
    before = tatt.mha_kernel_launches
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
        ref = tatt.mha_reference(q, k, v, bias, heads)
    torch.cuda.synchronize()
    assert tatt.mha_kernel_launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2, err
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_all_masked_row_is_uniform(cuda, dtype, d):
    """A batch-bucket padding row (every key bias -1e30) averages V's first
    S rows: the padding keys from S to the key-tile edge get nothing."""
    b, s, heads = 2, 100, 3
    q, k, v, _ = _inputs(d + s, b, s, heads * d, dtype, cuda)
    bias = torch.zeros(b, s, device=cuda)
    bias[1] = -1e30
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
    torch.cuda.synchronize()
    mean_v = v[1].float().mean(dim=0)  # (H*D,)
    err = (got[1].float() - mean_v[None, :]).abs().max().item()
    assert err <= 2e-2, err


@pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_kernel_at_key_tile_edges(cuda, s, d):
    """S just below, at and above a 64-key tile edge (and the query tile's)."""
    b, heads = 3, 2
    q, k, v, bias = _inputs(s * 7 + d, b, s, heads * d, torch.bfloat16, cuda)
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
        ref = tatt.mha_reference(q, k, v, bias, heads)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2, err


def test_kernel_matches_sdpa_at_rerank_shape(cuda):
    """A second opinion: scaled_dot_product_attention with the key bias as
    an additive mask, at the cross-encoder's rerank shape."""
    b, s, heads, d = 64, 512, 12, 32
    q, k, v, bias = _inputs(7, b, s, heads * d, torch.bfloat16, cuda)
    split = lambda t: t.view(b, s, heads, d).transpose(1, 2)
    with torch.inference_mode():
        got = tatt.mha_kernel(q, k, v, bias, heads)
        lib = torch.nn.functional.scaled_dot_product_attention(
            split(q), split(k), split(v), attn_mask=bias[:, None, None, :].to(q.dtype))
    torch.cuda.synchronize()
    lib = lib.transpose(1, 2).reshape(b, s, heads * d)
    err = (got.float() - lib.float()).abs().max().item()
    assert err <= 2e-2, err


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, bias = _inputs(0, 2, 16, 4 * 32, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        tatt.mha_kernel(q, k, v, bias, 8)  # D = 16
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        tatt.mha_kernel(q.float(), k.float(), v.float(), bias, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tatt.mha_kernel(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, bias, 4)
    long_q = torch.zeros(1, 513, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="sequence length"):
        tatt.mha_kernel(long_q, long_q, long_q, torch.zeros(1, 513, device=cuda), 2)
    qg = q.clone().requires_grad_(True)
    launches, recomputes = tatt.mha_kernel_launches, tatt.mha_backward_recomputes
    tatt.mha_kernel(qg, k, v, bias, 4).float().sum().backward()
    torch.cuda.synchronize()
    assert qg.grad is not None and torch.isfinite(qg.grad.float()).all()
    assert tatt.mha_kernel_launches == launches + 1
    assert tatt.mha_backward_recomputes == recomputes + 1


def _masked_but_one(bias):
    """Row 0: every key masked but the last valid one."""
    bias = bias.clone()
    bias[0] = -1e30
    bias[0, 1] = 0.0
    return bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,s,heads,d", [
    (32, 128, 12, 32), (64, 96, 4, 64), (8, 256, 12, 32),  # bi-encoder, lane, cross-encoder
    (3, 100, 2, 128),  # S not a multiple of the 64-key tile
])
def test_gradients_match_autograd_through_the_reference(cuda, dtype, b, s, heads, d):
    """MhaKernelFn (the kernel forward, the JAX scheme's recompute backward)
    through multihead_attention against autograd through mha_reference on
    the same CUDA tensors: the output and the q, k, v gradients within
    2e-2, one kernel launch and one recompute, a row with every key masked
    but one included."""
    q, k, v, bias = _inputs(b + s + d, b, s, heads * d, dtype, cuda)
    bias = _masked_but_one(bias)
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(s),
                    device=cuda).to(dtype)
    outs, grads = [], []
    launches, recomputes = tatt.mha_kernel_launches, tatt.mha_backward_recomputes
    for impl in ("auto", "reference"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = tatt.multihead_attention(*leaves, bias, heads, impl=impl)
        out.backward(g)
        outs.append(out.detach().float())
        grads.append([t.grad.float() for t in leaves])
    torch.cuda.synchronize()
    assert tatt.mha_kernel_launches == launches + 1
    assert tatt.mha_backward_recomputes == recomputes + 1
    assert (outs[0] - outs[1]).abs().max().item() <= 2e-2
    for name, got, ref in zip("qkv", *grads):
        assert torch.isfinite(got).all(), name
        err = (got - ref).abs().max().item()
        assert err <= 2e-2, (name, err)


def _tiny_pair_batch():
    """A 2-layer, 128-wide bi-encoder init and one 16-pair batch at 32 tokens."""
    from review_recommender_tpu_torch.models.bert import BertConfig, init_state_dict
    from review_recommender_tpu_torch.models.tokenizer import HashTokenizer
    from review_recommender_tpu_torch.train import make_pair_batch

    cfg = BertConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                     intermediate_size=256, max_position=64)
    sd = init_state_dict(cfg, "biencoder", seed=3)
    rng = np.random.default_rng(0)
    words = [f"word{i}" for i in range(80)]
    docs = [" ".join(rng.choice(words, size=20)) for _ in range(16)]
    queries = [" ".join(d.split()[:4]) for d in docs]
    return cfg, sd, make_pair_batch(HashTokenizer(512), queries, docs, max_len=32, pad_to=32)


def _update_cosine(a, b, sd):
    """Cosine of two trainers' parameter updates from the init `sd`."""
    d_a = torch.cat([(a.params[n].cpu() - sd[n]).flatten() for n in sd])
    d_b = torch.cat([(b.params[n].cpu() - sd[n]).flatten() for n in sd])
    return torch.nn.functional.cosine_similarity(d_a, d_b, dim=0).item()


def test_contrastive_step_on_cuda_matches_the_cpu_f32_step(cuda):
    """One bf16 ContrastiveTrainer step on the card (attention through the
    kernel forward and the recompute backward) against the CPU f32 step
    from the same init: loss within 2e-2 (bf16 products), and the update
    points the same way (cosine of the two parameter updates >= 0.95; a
    first AdamW step is lr * g / (|g| + eps), so elements whose gradient is
    rounding noise take either sign)."""
    from review_recommender_tpu_torch.train import ContrastiveTrainer, TrainConfig

    cfg, sd, batch = _tiny_pair_batch()
    tc = TrainConfig(learning_rate=1e-3)
    cpu = ContrastiveTrainer(cfg, sd, train_cfg=tc, dtype=torch.float32, device="cpu")
    gpu = ContrastiveTrainer(cfg, sd, train_cfg=tc, device="cuda")
    launches, recomputes = tatt.mha_kernel_launches, tatt.mha_backward_recomputes
    m_gpu = gpu.train_step(*batch)
    assert tatt.mha_kernel_launches == launches + 4  # 2 layers x (queries, docs)
    assert tatt.mha_backward_recomputes == recomputes + 4
    m_cpu = cpu.train_step(*batch)
    assert abs(m_gpu["loss"] - m_cpu["loss"]) <= 2e-2, (m_gpu, m_cpu)
    cos = _update_cosine(gpu, cpu, sd)
    assert cos >= 0.95, cos
    assert all(p.dtype == torch.float32 for p in gpu.params.values())  # f32 masters


def test_remat_step_on_cuda_relaunches_the_kernel(cuda):
    """remat=True (torch.utils.checkpoint per layer) on the card: the
    backward re-runs each layer's forward, kernel included, before the
    recompute backward, so a step launches the kernel twice for each
    recompute (8 launches and 4 recomputes for 2 layers x queries and
    docs, against 4 and 4 without remat). The step is the same step: the
    loss within 1e-6 and the cosine of the two parameter updates >= 0.9999
    (the re-run forward gives the same activations)."""
    from review_recommender_tpu_torch.train import ContrastiveTrainer, TrainConfig

    cfg, sd, batch = _tiny_pair_batch()
    counts, trainers, losses = {}, {}, {}
    for remat in (False, True):
        tr = ContrastiveTrainer(cfg, sd, train_cfg=TrainConfig(learning_rate=1e-3, remat=remat),
                                device="cuda")
        launches, recomputes = tatt.mha_kernel_launches, tatt.mha_backward_recomputes
        losses[remat] = tr.train_step(*batch)["loss"]
        counts[remat] = (tatt.mha_kernel_launches - launches,
                         tatt.mha_backward_recomputes - recomputes)
        trainers[remat] = tr
    assert counts == {False: (4, 4), True: (8, 4)}, counts
    assert abs(losses[True] - losses[False]) <= 1e-6, losses
    cos = _update_cosine(trainers[True], trainers[False], sd)
    assert cos >= 0.9999, cos


def test_training_steps_do_not_sync_fresh_or_restored(cuda, tmp_path):
    """A trainer's step (batch upload, forward through the kernel, the
    recompute backward, clip and AdamW) queues on the device without a
    host sync (torch's sync debug mode raises on one), fresh and restored
    from a checkpoint; the restored AdamW step counts stay on the host,
    where a fresh optimizer keeps them."""
    from review_recommender_tpu_torch.train import ContrastiveTrainer

    cfg, sd, batch = _tiny_pair_batch()
    fresh = ContrastiveTrainer(cfg, sd, device="cuda")
    fresh.train_step(*batch)
    fresh.save(tmp_path / "ck.pt")
    restored = ContrastiveTrainer(cfg, sd, device="cuda")
    restored.restore(tmp_path / "ck.pt")
    assert all(st["step"].device.type == "cpu" for st in restored.optim.opt.state.values())
    for tr in (fresh, restored):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = [tr.train_step_async(*batch) for _ in range(2)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert all(np.isfinite(float(m["loss"])) for m in metrics)
        assert tr.step == 3


def _postings(seed, n, l, q, device):
    """(N, L) postings with PAD tails, tf >= 128 lanes, and a query with
    repeated and PAD (id 0, idf 0) slots; plus the packed (L, N) words."""
    rng = np.random.default_rng(seed)
    terms = rng.integers(1, 400, (n, l)).astype(np.int32)
    terms[:, l - l // 4:] = 0
    tf = rng.integers(1, 6, (n, l)).astype(np.float32)
    tf[rng.random((n, l)) < 0.05] = 200.0
    tf[terms == 0] = 0
    dl = tf.sum(1).astype(np.float32)
    qt = rng.integers(1, 400, q).astype(np.int32)
    qt[0] = terms[0, 0]  # at least one scored lane, even at N=3, L=1
    qt[1] = qt[0]
    qt[q - q // 4:] = 0
    qi = rng.uniform(0.5, 3, q).astype(np.float32)
    qi[q - q // 4:] = 0
    packed = (tf.astype(np.int64) << 24 | terms).astype(np.uint32).view(np.int32).T
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (put(terms), put(tf), put(dl), put(qt), put(qi), put(packed),
            float(np.float32(dl.mean())))


@pytest.mark.parametrize("n,l,q", [(200_192, 64, 32), (1000, 64, 32), (777, 33, 5),
                                   (4096, 512, 32), (3, 1, 64), (513, 100, 17),
                                   (20_000, 64, 65), (20_000, 64, 128), (5000, 48, 1024)])
def test_bm25_kernels_match_reference(cuda, n, l, q):
    terms, tf, dl, qt, qi, packed, avgdl = _postings(n + l + q, n, l, q, cuda)
    p0, u0 = tbk.bm25_packed_kernel_launches, tbk.bm25_unpacked_kernel_launches
    got_p = tbk.bm25_full_scores_packed_kernel(packed, dl, qt, qi, avgdl)
    got_u = tbk.bm25_full_scores_kernel(terms, tf, dl, qt, qi, avgdl)
    ref_p = tbk.bm25_full_scores_packed_reference(packed, dl, qt, qi, avgdl)
    ref_u = bm25_full_scores(terms, tf, dl, qt, qi, avgdl)
    valid = torch.arange(n, device=cuda) < max(1, n - 7)
    k = min(n, 50)
    top_p = tbk.bm25_topk_packed(packed, dl, valid, qt, qi, avgdl, k)  # CUDA: the kernels
    top_u = tbk.bm25_topk_unpacked(terms, tf, dl, valid, qt, qi, avgdl, k)
    torch.cuda.synchronize()
    assert tbk.bm25_packed_kernel_launches == p0 + 2
    assert tbk.bm25_unpacked_kernel_launches == u0 + 2
    assert torch.equal(ref_p, ref_u)
    assert torch.equal(got_p, ref_p)
    assert torch.equal(got_u, ref_u)
    assert bool((got_p > 0).any())
    ref_top = masked_topk(ref_p, valid, k)
    for top in (top_p, top_u):
        assert torch.equal(top[1], ref_top[1]) and torch.equal(top[0], ref_top[0])


@pytest.mark.parametrize("min_q", [0, 130], ids=["q", "q130"])
@pytest.mark.parametrize("case", CASES)
def test_bm25_kernels_lookup_edge_cases(cuda, case, min_q):
    """The query-term lookup's edge cases (tests/torch_bm25_cases.py), the
    packed postings at the unpadded N: bitwise equal scores, equal top-k;
    each also with its query lengthened to 130 slots (three launches of
    64, 64 and 2 slots)."""
    terms, tf, dl, qt, qi, avgdl = bm25_edge_case(case, min_q)
    n = terms.shape[0]
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    args_p = (put(pack(terms, tf)), put(dl), put(qt), put(qi), float(avgdl))
    args_u = (put(terms), put(tf), put(dl), put(qt), put(qi), float(avgdl))
    got_p = tbk.bm25_full_scores_packed_kernel(*args_p)
    got_u = tbk.bm25_full_scores_kernel(*args_u)
    ref_p = tbk.bm25_full_scores_packed_reference(*args_p)
    ref_u = bm25_full_scores(*args_u)
    torch.cuda.synchronize()
    assert torch.equal(ref_p, ref_u)
    assert torch.equal(got_p, ref_p)
    assert torch.equal(got_u, ref_u)
    valid = torch.arange(n, device=cuda) < n
    k = min(n, 50)
    ref_ids = masked_topk(ref_p, valid, k)[1]
    for got in (got_p, got_u):
        assert torch.equal(masked_topk(got, valid, k)[1], ref_ids)


def test_bm25_kernels_reject_what_they_do_not_take(cuda):
    terms, tf, dl, qt, qi, packed, avgdl = _postings(0, 64, 16, 8, cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbk.bm25_full_scores_packed_kernel(packed.cpu(), dl.cpu(), qt.cpu(), qi.cpu(), avgdl)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbk.bm25_full_scores_kernel(terms, tf, dl.cpu(), qt, qi, avgdl)
    with pytest.raises(ValueError, match="int32"):
        tbk.bm25_full_scores_packed_kernel(packed.long(), dl, qt, qi, avgdl)
    with pytest.raises(ValueError, match="float32"):
        tbk.bm25_full_scores_kernel(terms, tf.double(), dl, qt, qi, avgdl)
    with pytest.raises(ValueError, match="contiguous"):
        tbk.bm25_full_scores_packed_kernel(packed.T.contiguous().T, dl, qt, qi, avgdl)
    with pytest.raises(ValueError, match="contiguous"):
        tbk.bm25_full_scores_kernel(terms.T.contiguous().T, tf, dl, qt, qi, avgdl)
    with pytest.raises(ValueError, match="shape"):
        tbk.bm25_full_scores_kernel(terms, tf[:, :8].contiguous(), dl, qt, qi, avgdl)
    with pytest.raises(ValueError, match="N=0"):
        tbk.bm25_full_scores_packed_kernel(packed[:, :0].contiguous(), dl[:0], qt, qi, avgdl)
    with pytest.raises(ValueError, match="query slots"):
        long_q = torch.zeros(tbk.MAX_QUERY_SLOTS + 1, dtype=torch.int32, device=cuda)
        tbk.bm25_full_scores_packed_kernel(packed, dl, long_q, long_q.float(), avgdl)


def test_engine_refuses_query_terms_cap_above_the_kernel_limit(cuda, monkeypatch):
    """On the card every query has QUERY_TERMS_CAP slots: above the BM25
    kernels' limit SearchEngine refuses at construction, naming the knob."""
    from review_recommender_tpu_torch.config import config
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.build import synth_product_index
    from review_recommender_tpu_torch.index.schema import IndexBundle

    bundle = IndexBundle(products=synth_product_index(300, 64, 200, 8, seed=0, text_chars=50))
    monkeypatch.setattr(config, "QUERY_TERMS_CAP", tbk.MAX_QUERY_SLOTS + 1)
    with pytest.raises(ValueError, match="QUERY_TERMS_CAP"):
        SearchEngine(bundle, device="cuda")
    monkeypatch.setattr(config, "QUERY_TERMS_CAP", tbk.MAX_QUERY_SLOTS)
    eng = SearchEngine(bundle, device="cuda")
    idx, scores = eng.search_bm25("t12 t34 t56", 10)
    torch.cuda.synchronize()
    assert idx.shape == (10,) and bool(torch.isfinite(scores).all())


def _e2e_engine(device):
    """A 2,000-product engine with attach_rerank_tokens' tokens and 2-layer
    bf16 towers of 4 heads of 32 (the kernel's head dims), the same seeded
    weights on either device."""
    from review_recommender_tpu_torch.engine.search import SearchEngine
    from review_recommender_tpu_torch.index.build import (attach_rerank_tokens,
                                                          synth_product_index)
    from review_recommender_tpu_torch.index.schema import IndexBundle
    from review_recommender_tpu_torch.models.bert import BertConfig
    from review_recommender_tpu_torch.models.encoder import BiEncoder, CrossEncoder

    cfg = BertConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                     intermediate_size=256, max_position=128)
    be = BiEncoder.random_init(cfg, seed=1, device=device, dtype=torch.bfloat16)
    ce = CrossEncoder.random_init(cfg, seed=2, device=device, dtype=torch.bfloat16)
    products = synth_product_index(2000, 128, 300, 12, seed=0, text_chars=200)
    attach_rerank_tokens(products, be.tokenizer, max_tokens=64)
    eng = SearchEngine(IndexBundle(products=products), device=device)
    eng.attach_models(be, ce)
    return eng


def test_query_e2e_on_cuda_matches_cpu(cuda):
    """query_e2e on the card (both towers on the attention kernel: 2 + 2
    launches a query at rr_k=8) against the port on the CPU (reference
    attention) with the same weights and corpus: rows equal up to near-tie
    swaps, finals within 2e-2 (bf16 towers, the phase-4 bound of
    chip_smoke.py)."""
    from review_recommender_tpu_torch.ops.fusion import FusionWeights

    w = FusionWeights.make(0.4, 0.25, 0.2, 0.1, 0.0, 20.0, 8.0, 1.0)
    gpu, cpu = _e2e_engine("cuda"), _e2e_engine("cpu")
    for query in ("t12 t34 t56", "t7 t250 t3", "t99"):
        before = tatt.mha_kernel_launches
        rg, sg = gpu.query_e2e(query, w, 150, 10, rr_k=8)
        torch.cuda.synchronize()
        assert tatt.mha_kernel_launches == before + 4
        rc, sc = cpu.query_e2e(query, w, 150, 10, rr_k=8)
        sg, sc = sg.cpu().numpy(), sc.numpy()
        assert np.isfinite(sg).all() and np.abs(sg - sc).max() <= 2e-2, (sg, sc)
        for i, (a, b) in enumerate(zip(rg.cpu().tolist(), rc.tolist())):
            if a != b:
                assert abs(sg[i] - sc[i]) <= 2e-2


def test_device_fetch_on_cuda(cuda):
    """device_fetch copies CUDA tensors through pinned buffers and waits
    once: every value equals a plain .cpu() read, right after a kernel
    that wrote it."""
    from review_recommender_tpu_torch.utils.numerics import device_fetch

    a = torch.arange(1 << 20, device=cuda, dtype=torch.float32).mul_(3.0)
    b = torch.arange(1000, device=cuda).remainder_(7)
    got_a, got_b, got_c = device_fetch(a, b, np.ones(3))
    assert got_a.dtype == np.float32 and got_b.dtype == np.int64
    np.testing.assert_array_equal(got_a, a.cpu().numpy())
    np.testing.assert_array_equal(got_b, b.cpu().numpy())
    np.testing.assert_array_equal(got_c, np.ones(3))


@pytest.mark.parametrize("front_end", ["stdlib", "native"])
def test_server_answers_a_search_on_cuda(cuda, front_end):
    """serve / serve_native on a small CUDA engine: one /search without a
    query vector encodes on the card (2 attention launches, one per layer)
    and answers 10 finite, sorted rows."""
    import json
    import threading
    import urllib.request

    from review_recommender_tpu_torch.serve.api import serve
    from review_recommender_tpu_torch.serve.native_server import serve_native

    eng = _e2e_engine("cuda")
    if front_end == "stdlib":
        srv = serve(eng, host="127.0.0.1", port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        port = srv.server_address[1]
    else:
        srv = serve_native(eng, host="127.0.0.1", port=0)
        port = srv.port
    try:
        before = tatt.mha_kernel_launches
        req = urllib.request.Request(f"http://127.0.0.1:{port}/search", data=json.dumps(
            {"query": "t12 t34 t56", "k": 10, "rerank_k": 0}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert tatt.mha_kernel_launches == before + 2
        finals = [row["_final"] for row in out["results"]]
        assert len(finals) == 10 and all(np.isfinite(finals))
        assert finals == sorted(finals, reverse=True)
    finally:
        if front_end == "stdlib":
            srv.shutdown()
            srv.service.close()
        else:
            srv.close()


def test_cli_search_on_a_saved_bundle_on_cuda(cuda, tmp_path):
    """Build a bundle (native tokenizer), save and load it, then the CLI's
    search on cuda: its rows equal run_search on the engine _load_engine
    builds, and it launches the attention kernel once per bi-encoder layer
    (4 at D=64) plus once per cross-encoder layer (6) for 4 rerank pairs."""
    import json

    from review_recommender_tpu_torch.index.build import build_bundle_from_products
    from review_recommender_tpu_torch.index.io import load_bundle, save_bundle
    from review_recommender_tpu_torch.serve import cli
    from tests.torch_bundle_cases import assert_bundles_equal, corpus

    products, _q, emb = corpus()
    built = build_bundle_from_products(products, emb, doc_terms_cap=64, pad_multiple=16)
    save_bundle(built, tmp_path / "b")
    assert_bundles_equal(load_bundle(tmp_path / "b", verify_checksums=True), built)
    before = tatt.mha_kernel_launches
    argv = ["search", "yellow wireless headphones", "--index-dir", str(tmp_path / "b"),
            "--rerank-k", "4", "--json-out", str(tmp_path / "out.json")]
    assert cli.main(argv) == 0
    assert tatt.mha_kernel_launches == before + 4 + 6
    engine = cli._load_engine(str(tmp_path / "b"), with_rerank=True)
    rows, _s, _d = engine.run_search("yellow wireless headphones", k=10, rerank_k=4)
    assert json.loads((tmp_path / "out.json").read_text())["results"] == rows


def _stage_a_inputs(seed, n, d, b, dtype, device):
    """Unit-norm rows and queries; holes in the validity; when there is a
    second tile, it keeps 5 valid rows only (its later rounds repeat ids)."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    valid = rng.random(n) < 0.97
    if n > tsa.TILE_N:
        hi = min(n, 2 * tsa.TILE_N)
        valid[tsa.TILE_N:hi] = False
        valid[tsa.TILE_N + rng.choice(hi - tsa.TILE_N, 5, replace=False)] = True
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return (torch.from_numpy(emb).to(device, dtype), torch.from_numpy(valid).to(device),
            torch.from_numpy(q).to(device))


def _plain_tile_scores(emb, valid, qvecs, local_ids):
    """The plain version's score of each winner id: (n_tiles, 16, B)."""
    n, b = emb.shape[0], qvecs.shape[0]
    tiles = -(-n // tsa.TILE_N)
    sims = torch.where(valid[:, None], matmul_f32(emb, qvecs.to(emb.dtype).T), tsa.NEG)
    sims = torch.nn.functional.pad(sims, (0, 0, 0, tiles * tsa.TILE_N - n), value=tsa.NEG)
    return torch.gather(sims.reshape(tiles, tsa.TILE_N, b), 1, local_ids.long())


def _check_tile_pass(emb, valid, qvecs):
    """The kernel's tile pass against the plain one; returns both. The
    launch goes to the dtype's kernel and counts once."""
    counter = "stage_a_kernel_launches" if emb.dtype == torch.bfloat16 \
        else "stage_a_f32_kernel_launches"
    before = getattr(tsa, counter), tsa.stage_a_kernel_launches + tsa.stage_a_f32_kernel_launches
    ks, ki = tsa.stage_a_tile_winners_kernel(emb, valid, qvecs)
    ps, pi = tsa.stage_a_tile_winners_reference(emb, valid, qvecs)
    torch.cuda.synchronize()
    assert getattr(tsa, counter) == before[0] + 1
    assert tsa.stage_a_kernel_launches + tsa.stage_a_f32_kernel_launches == before[1] + 1
    n, b = emb.shape[0], qvecs.shape[0]
    tiles = -(-n // tsa.TILE_N)
    assert ks.shape == ki.shape == (tiles, tsa.M_PER_TILE, b)
    assert ks.dtype == torch.float32 and ki.dtype == torch.int32
    assert (ks - ps).abs().max().item() <= 1e-5
    differ = ki != pi
    assert differ.float().mean().item() <= 0.01
    if differ.any():  # near ties only
        gap = _plain_tile_scores(emb, valid, qvecs, ki) - _plain_tile_scores(emb, valid, qvecs, pi)
        assert gap[differ].abs().max().item() <= 1e-5
    exhausted = ps == tsa.NEG  # rounds past a tile's valid rows: exactly (-3.4e38, 0)
    assert torch.equal(ks == tsa.NEG, exhausted) and (ki[exhausted] == 0).all()
    return (ks, ki), (ps, pi)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,b", [(200_704, 384, 32), (2 * 2048 + 10, 64, 1),
                                   (10_000, 128, 128), (5000, 72, 5), (3000, 8, 3),
                                   (4100, 4096, 20), (9000, 384, 300)])
def test_stage_a_kernel_matches_reference(cuda, dtype, n, d, b):
    emb, valid, qvecs = _stage_a_inputs(n + d + b, n, d, b, dtype, cuda)
    (ks, ki), (ps, pi) = _check_tile_pass(emb, valid, qvecs)
    if n > tsa.TILE_N:  # the exhausted tile repeats local row 0, as the plain version does
        assert torch.equal(ki[1, 5:], pi[1, 5:]) and (ki[1, 5:] == 0).all()
        assert (ks[1, 5:] == tsa.NEG).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", STAGE_A_CASES)
def test_stage_a_kernel_on_shared_cases(cuda, case, dtype):
    """tests/torch_stage_a_cases.py on the card: ties to the lower row
    across slabs, more than 16 copies of the best row, exhausted and
    all-invalid tiles, ragged N, B in {1, 5, 33, 130}."""
    emb, valid, qvecs = (torch.from_numpy(x).to(cuda) for x in stage_a_case(case))
    (ks, ki), (ps, pi) = _check_tile_pass(emb.to(dtype), valid, qvecs)
    if case == "dup_best":  # the 16 lowest of the 40 copies, on both sides
        assert torch.equal(ki[0, :, 0], pi[0, :, 0])
    if case == "tie_across_slabs":
        assert int(ki[0, -1, 0]) == 63


@pytest.mark.parametrize("b", [1, 8, 32, 128])
def test_stage_a_kernel_at_main_shape(cuda, b):
    """The main shape, (200,704, 384) bf16, at each batch width phase 8
    times; one launch reads the corpus once (a single query chunk)."""
    emb, valid, qvecs = _stage_a_inputs(b, 200_704, 384, b, torch.bfloat16, cuda)
    _check_tile_pass(emb, valid, qvecs)
    assert tsa.stage_a_query_chunk(384, b) >= b


def test_stage_a_kernel_rejects_what_it_does_not_take(cuda):
    emb, valid, qvecs = _stage_a_inputs(0, 4096, 64, 8, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsa.stage_a_tile_winners_kernel(emb.cpu(), valid.cpu(), qvecs.cpu())
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tsa.stage_a_tile_winners_kernel(emb.half(), valid, qvecs)
    with pytest.raises(ValueError, match="qvecs must be torch.float32"):
        tsa.stage_a_tile_winners_kernel(emb, valid, qvecs.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        tsa.stage_a_tile_winners_kernel(emb.T.contiguous().T, valid, qvecs)
    with pytest.raises(ValueError, match="not taken"):
        tsa.stage_a_tile_winners_kernel(emb[:, :60].contiguous(), valid, qvecs[:, :60].contiguous())
    with pytest.raises(ValueError, match="shape|must be"):
        tsa.stage_a_tile_winners_kernel(emb, valid[:100], qvecs)
    with pytest.raises(ValueError, match="not taken"):
        wide = torch.zeros(64, 4104, dtype=torch.bfloat16, device=cuda)
        tsa.stage_a_tile_winners_kernel(wide, valid[:64], torch.zeros(2, 4104, device=cuda))


# ------------------------------------------------ the int8 corpus, the IVF pool
def _unit_rows(seed, n, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,b", [(200_192, 1), (200_192, 16), (200_192, 128), (1003, 5)])
def test_int8_scores_on_cuda_bit_equal_to_cpu(cuda, n, b):
    """torch._int_mm on the padded single-query (1 row -> 17) and batched
    shapes, and N not a multiple of 8: scores, exact and striped pools
    bit-equal to the CPU int8 path."""
    from review_recommender_tpu_torch.ops import dense as td

    emb = _unit_rows(0, n, 384)
    q = torch.from_numpy(_unit_rows(1, b, 384))
    q = q[0] if b == 1 else q
    e_q, scale = (torch.from_numpy(a) for a in td.quantize_corpus_int8(emb))
    valid = torch.arange(n) < n - 7
    got = td.dense_scores_int8(e_q.to(cuda), scale.to(cuda), q.to(cuda), valid.to(cuda))
    want = td.dense_scores_int8(e_q, scale, q, valid)
    assert torch.equal(got.cpu(), want)
    sl_dev = td.slice_corpus_for_striped_int8(e_q.to(cuda), scale.to(cuda), valid.to(cuda), 8192)
    sl_cpu = td.slice_corpus_for_striped_int8(e_q, scale, valid, 8192)
    gs, gi = td.dense_striped_topk_scan_int8(*sl_dev, q.to(cuda), 150)
    ws, wi = td.dense_striped_topk_scan_int8(*sl_cpu, q, 150)
    assert torch.equal(gi.cpu(), wi) and torch.equal(gs.cpu(), ws)


def test_ivf_topk_on_cuda_matches_cpu(cuda):
    """ivf_topk on the card against its CPU run on the same index (bf16
    blocks): scores within 1e-5, an id differing only at a near tie; the
    batched rows equal their single queries."""
    from review_recommender_tpu_torch.ops import ivf as tivf

    rng = np.random.default_rng(2)
    centers = _unit_rows(3, 64, 128)
    emb = centers[rng.integers(0, 64, 20_000)] + 0.05 * rng.standard_normal((20_000, 128))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    valid = np.arange(20_000) < 19_990
    ix = tivf.build_ivf(emb, valid, device=cuda)
    dev = tivf.ivf_device_arrays(ix, torch.from_numpy(emb).to(cuda, torch.bfloat16))
    cpu = {k: v.cpu() for k, v in dev.items()}
    q = torch.from_numpy(emb[:32] + 0.01)
    for nprobe in (4, 64, 10_000):
        gs, gi = tivf.ivf_topk(*(dev[k] for k in tivf.IVF_KEYS), q.to(cuda), 150, nprobe)
        ws, wi = tivf.ivf_topk(*(cpu[k] for k in tivf.IVF_KEYS), q, 150, nprobe)
        gs, gi = gs.cpu(), gi.cpu()
        live = torch.isfinite(ws)
        assert torch.equal(torch.isfinite(gs), live)  # the same -inf padding
        gap = torch.where(live, gs - ws, 0.0).abs()
        assert gap.max().item() <= 1e-5
        differ = (gi != wi) & live
        assert (gap[differ] <= 1e-5).all()
        for i in (0, 31):
            s1, i1 = tivf.ivf_topk(*(dev[k] for k in tivf.IVF_KEYS), q[i].to(cuda), 150, nprobe)
            assert torch.equal(i1.cpu(), gi[i])


def test_loaded_tower_on_cuda_matches_cpu_f32(cuda, tmp_path):
    """A bge-small-shaped HF snapshot (the full-size golden's manifest and
    seed, written as pytorch_model.bin) loaded through models/load.py on the
    card in bf16, against its CPU f32 forward: within 2e-2; the attention
    kernel runs once per layer."""
    import json

    from review_recommender_tpu_torch.models import load
    from tests.golden_utils import manifest_from_npz, synth_state_arrays

    g = np.load(Path(__file__).parent / "goldens" / "bert_fullsize.npz")
    sd = synth_state_arrays(manifest_from_npz(g, "be_man."), seed=100)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 30522, "hidden_size": 384, "num_hidden_layers": 12,
        "num_attention_heads": 12, "intermediate_size": 1536}))
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(30517)]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    gpu = load.load_biencoder(tmp_path)
    cpu = load.load_biencoder(tmp_path, device="cpu", dtype=torch.float32)
    texts = [" ".join(f"w{i}" for i in range(j, j + 20 * (j + 1))) for j in range(6)]
    before = tatt.mha_kernel_launches
    got = gpu.encode(texts)
    torch.cuda.synchronize()
    assert tatt.mha_kernel_launches > before
    assert np.abs(got - cpu.encode(texts)).max() <= 2e-2


# ------------------------------------------------------------ topic pipeline
TOPIC_TOL = 1e-5  # f32 products summed in another order by cuBLAS and the CPU GEMM


def _knn_case(case):
    from tests.torch_topic_cases import GRAPH_CASES, rand_rows

    if case == "wide_5000":
        return rand_rows(5000, 384, 11), 17, dict(batch_rows=1024, col_chunk=2048)
    make, k, kw = GRAPH_CASES[case]
    return make(), k, kw


@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("case", ["wide_5000", "duplicates", "negative_tails", "ragged_chunks",
                                  "zero_rows"])
def test_knn_graph_on_cuda_matches_cpu(cuda, case, tf32):
    """The graph on the card against the CPU path: sims within TOPIC_TOL,
    ids equal but for near ties; with TF32 turned on by the caller too
    (knn_graph computes in IEEE f32 whatever the process set)."""
    from review_recommender_tpu_torch.topics.density import knn_graph
    from tests.torch_topic_cases import assert_ids_differ_only_at_near_ties

    emb, k, kw = _knn_case(case)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        gs, gi = knn_graph(emb, k=k, device="cuda", **kw)
        # the caller's setting restored (read through the current API: reading the
        # legacy switch raises once both were used)
        assert torch.backends.cuda.matmul.fp32_precision == ("tf32" if tf32 else "ieee")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    cs, ci = knn_graph(emb, k=k, device="cpu", **kw)
    assert gs.dtype == np.float32 and gi.dtype == np.int32 and gs.shape == cs.shape
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(cs))
    np.testing.assert_allclose(gs, cs, atol=TOPIC_TOL, rtol=0)
    assert_ids_differ_only_at_near_ties(emb, gi, ci, TOPIC_TOL)
    if case == "duplicates":
        assert (gi[:25] == np.arange(11)).all()


def test_density_cluster_on_cuda_labels_equal_cpu(cuda):
    from review_recommender_tpu_torch.topics.density import density_cluster
    from tests.torch_topic_cases import blobs_with_noise

    emb, truth = blobs_with_noise(n_per=400, k=6, d=64, noise=300, spread=0.06, seed=5)
    kw = dict(min_samples=10, min_cluster_size=40, batch_rows=512, col_chunk=1000)
    gl, ginfo = density_cluster(emb, device="cuda", **kw)
    cl, cinfo = density_cluster(emb, device="cpu", **kw)
    np.testing.assert_array_equal(gl, cl)
    assert ginfo["n_clusters"] == cinfo["n_clusters"] == 6
    assert ginfo["eps"] == pytest.approx(cinfo["eps"], abs=TOPIC_TOL)


def test_rrt_topics_on_cuda_writes_the_cpu_cards(cuda, tmp_path, capsys):
    from review_recommender_tpu_torch.index.build import build_bundle_from_products
    from review_recommender_tpu_torch.index.io import save_bundle
    from review_recommender_tpu_torch.serve import cli
    from tests.torch_topic_cases import rand_rows, topic_reviews

    products = [{"sku": f"P{i}", "agg_text": f"product {i} socks", "n_reviews": 10.0,
                 "avg_stars": 4.0} for i in range(24)]
    rows, remb = topic_reviews([p["sku"] for p in products])
    save_bundle(build_bundle_from_products(products, rand_rows(24, 32, 0), reviews=rows,
                                           review_embeddings=remb, pad_multiple=8,
                                           doc_terms_cap=32), tmp_path / "b")
    lanes = (["--k", "4", "--iters", "8", "--min-reviews", "1"],
             ["--cluster", "density", "--min-samples", "5", "--min-cluster-size", "20",
              "--llm", "dry"])
    for i, lane in enumerate(lanes):
        for dev in ("cuda", "cpu"):
            assert cli.main(["topics", "--index-dir", str(tmp_path / "b"), "--out",
                             str(tmp_path / f"{dev}{i}"), "--device", dev, *lane]) == 0
        for f in ("topic_cards.jsonl", "aspect_metrics.json"):
            assert (tmp_path / f"cuda{i}" / f).read_text() == (tmp_path / f"cpu{i}" / f).read_text()
        assert len((tmp_path / f"cuda{i}" / "topic_cards.jsonl").read_text().splitlines()) >= 3
    capsys.readouterr()
