"""The port's sparse-layout CausalGAT against the JAX package.

The keep-bit hash against cal_tpu's ``_keep_mask``; the plain twins of the
row statistics (K8), the coefficient SpMM and its transposed mode (K9, K9T)
and the SDDMM chain (K10) against cal_tpu's Pallas kernels (interpret mode
on the CPU, small tile plans as in tests/test_torch_port_sparse.py);
``gat_aggregate_sparse_fused``'s forward and backward against ``jax.vjp`` of
cal_tpu's, against the [E, heads] references and against torch.autograd of
its twins; the sparse CausalGAT forward and train step against cal_tpu's on
a tiled GraphBatch and against the port's dense layout; ``main_syn
--model CausalGAT --layout sparse`` train, save, serve and resume.  Small
sizes (hidden 16-32, 2-4 heads, V <= 256)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_sparse import (
    CLASSES,
    FWD_TOL,
    HIDDEN,
    LAYERS,
    NB,
    _host_graphs,
    _jax_sparse_graph,
    _plans,
    _sparse_budgets,
    _workload,
)
from test_torch_port_sparse_train import (
    CO_W,
    C_W,
    EPOCHS,
    LR,
    MIN_LR,
    O_W,
    WD,
    _jax_grads,
    _METRICS,
)

from cal_tpu.data.loader import Loader as JaxLoader
from cal_tpu.ops.gat import _head_ids, _keep_mask
from cal_tpu.ops.gat import gat_aggregate_sparse as jax_gat_sparse
from cal_tpu.ops.gat import gat_aggregate_sparse_fused as jax_gat_fused
from cal_tpu.ops.pallas_spmm import (
    _gat_coef_spmm_call,
    _gat_den_call,
    _gat_max_call,
    _gat_sddmm_chain_call,
)
from cal_tpu.train.optim import make_optimizer as jax_make_optimizer
from cal_tpu.train.steps import TrainState as JaxTrainState
from cal_tpu.train.steps import _causal_step_fn
from test_torch_port_model import _models
from test_torch_port_train import _flat

from cal_tpu_torch.data.loader import Loader
from cal_tpu_torch.graph import sparse_batch, to_dense
from cal_tpu_torch.main_syn import main
from cal_tpu_torch.models.causal import CausalGNN
from cal_tpu_torch.ops.gat import NEG_SLOPE, gat_aggregate_sparse, head_ids, keep_mask, seed_words
from cal_tpu_torch.ops.gat_sparse import (
    gat_aggregate_sparse_fused,
    gat_aggregate_sparse_fused_plain,
    gat_coef_spmm,
    gat_coef_spmm_t,
    gat_row_stats,
    gat_sddmm_chain,
)
from cal_tpu_torch.train.optim import cosine_lr, make_optimizer
from cal_tpu_torch.train.steps import TrainState, make_causal_train_step
from cal_tpu_torch.utils.checkpoint import Checkpointer

HEADS = 4
WORDS = (0x9E3779B9, 0x7F4A7C15)            # two uint32 dropout seed words
RATE = 0.2
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Twins against the Pallas kernels on f32 tile plans: the same f32 math with
# sums in another order (tile slots against CSR rows, XLA's exp against
# PyTorch's): 2e-5.  On bf16 plans cal_tpu rounds the gathered planes (tj,
# ti, m, dD), x, w and each message before its receiver sum to bf16
# (pallas_spmm.py:1669, :1725, :1812); the port rounds only x.  At scores of
# ~10 a plane's rounding moves an exponent by up to ~3e-2, so each exp term
# by ~3% of its size, and an output sums a few such terms that may cancel:
# measured up to 3.1% of the output's largest magnitude (dti at rate 0.2).
# So bf16: 3e-2 relative plus an absolute 4e-2 of that magnitude.
TWIN_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=4e-2)}


def _close(got, ref, dtype, err_msg=""):
    ref = np.asarray(ref, np.float32)
    tol = dict(TWIN_TOL[dtype])
    if dtype == "bfloat16":
        tol["atol"] *= float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, err_msg=err_msg, **tol)


# The Function's VJP against jax.vjp of cal_tpu's on f32 plans: the same
# formulas with sums in another order and outputs of order 10 (dxh, datt):
# 1e-4 relative, 1e-5 absolute.
VJP_TOL = dict(rtol=1e-4, atol=1e-5)
# The Function's backward against torch.autograd of the forward twins: the
# same f32 math, the VJP written out instead of derived.
AUTOGRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _gat_inputs(rng, heads=HEADS, d=8):
    """A CSR workload (hub, self loops, padded run) and GAT inputs on it."""
    g, _, _ = _workload(rng, h=heads * d)
    v = g.num_nodes
    xh = rng.standard_normal((v, heads, d)).astype(np.float32)
    ad = (0.6 * rng.standard_normal((heads, d))).astype(np.float32)
    asr = (0.6 * rng.standard_normal((heads, d))).astype(np.float32)
    return g, xh, ad, asr


def _walk_inputs(rng, shape, heads=HEADS, d=8):
    """GAT inputs on a graph of one of the shapes the sparse GAT walk treats
    apart, at tests/test_pallas_spmm.py's sizes (V 256, E 700, a 15% masked
    tail at node V-1): "sender_hub", node 11 sending ~100 edges (several
    chunks of the sender CSR) beside the receiver hub; "masked_rows", receivers 20
    and 21 (and the padded V-1) whose in-edges are all masked out, beside
    receivers without an in-edge."""
    v, e, hub = 256, 700, 90
    senders = rng.integers(0, v, e)
    receivers = rng.integers(0, v - 1, e)
    receivers[:hub] = 7                                  # receiver hub: several chunks
    if shape == "sender_hub":
        senders[hub:hub + 100] = 11                      # sender hub: several chunks
    idx = rng.choice(e, e // 20, replace=False)
    senders[idx] = receivers[idx]                        # self loops, dropped
    n_real = int(e * 0.85)
    order = np.argsort(receivers[:n_real], kind="stable")
    senders = np.concatenate([senders[:n_real][order], np.full(e - n_real, v - 1)])
    receivers = np.concatenate([receivers[:n_real][order], np.full(e - n_real, v - 1)])
    edge_mask = np.arange(e) < n_real
    if shape == "masked_rows":
        edge_mask &= ~np.isin(receivers, (20, 21))
        assert np.isin(receivers, (20, 21)).any()
    g = sparse_batch(np.zeros((v, 1), np.float32), senders, receivers, edge_mask,
                     np.ones(v, bool), np.zeros(v, np.int32), np.zeros(1, np.int32),
                     np.ones(1, bool))
    xh = rng.standard_normal((v, heads, d)).astype(np.float32)
    ad = (0.6 * rng.standard_normal((heads, d))).astype(np.float32)
    asr = (0.6 * rng.standard_normal((heads, d))).astype(np.float32)
    return g, xh, ad, asr


def _planes(xh, ad, asr, dtype):
    """tj, ti [heads, V] f32 from xh in the model dtype, as the aggregate
    forms them."""
    xf = torch.from_numpy(xh).to(TDT[dtype]).float()
    return (torch.einsum("vhd,hd->hv", xf, torch.from_numpy(asr)).contiguous(),
            torch.einsum("vhd,hd->hv", xf, torch.from_numpy(ad)).contiguous())


@pytest.mark.parametrize("salt", [0, 1])
def test_keep_mask_matches_jax_bit_for_bit(salt):
    rng = np.random.default_rng(salt)
    ids = rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    ids[:3] = (0, 1, 2**31 - 1)
    for words in (WORDS, (0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (12345, 2**32 - 7)):
        for rate in (0.2, 0.5, 1e-9):
            ref = _keep_mask(jnp.asarray(ids), jnp.asarray(words, jnp.uint32), rate, salt)
            got = keep_mask(torch.from_numpy(ids), words, rate, salt)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    base = torch.arange(7)
    np.testing.assert_array_equal(head_ids(base, 3).numpy(),
                                  np.asarray(_head_ids(jnp.arange(7), 3)))
    assert seed_words((5 << 32) | 9) == (9, 5)


@pytest.mark.parametrize("dtype,rate,shape", [
    pytest.param("float32", 0.0, "hub", id="float32-0.0"),
    pytest.param("float32", RATE, "hub", id="float32-0.2"),
    pytest.param("bfloat16", 0.0, "hub", id="bfloat16-0.0"),
    pytest.param("bfloat16", RATE, "hub", id="bfloat16-0.2"),
    pytest.param("float32", RATE, "sender_hub", id="float32-0.2-sender_hub"),
    pytest.param("bfloat16", 0.0, "sender_hub", id="bfloat16-0.0-sender_hub"),
    pytest.param("float32", 0.0, "masked_rows", id="float32-0.0-masked_rows"),
    pytest.param("bfloat16", RATE, "masked_rows", id="bfloat16-0.2-masked_rows"),
])
def test_kernel_twins_match_pallas(dtype, rate, shape):
    """K8 against _gat_max_call (with the self score) and _gat_den_call, K9
    and K9T against _gat_coef_spmm_call on the forward and the transposed
    plan, K10 against _gat_sddmm_chain_call; the same injected seed words.
    On the receiver hub and padded run of ``_gat_inputs`` ("hub") and on
    ``_walk_inputs``' shapes: a sender hub over several chunks, receivers
    whose in-edges are all masked (m the self score, den and dti 0)."""
    rng = np.random.default_rng(1)
    g, xh, ad, asr = _gat_inputs(rng) if shape == "hub" else _walk_inputs(rng, shape)
    v = g.num_nodes
    assert g.recv.num_chunks > v + 1                    # the hub and the padded run
    if shape == "sender_hub":
        assert g.send.chunk_ptr[12] - g.send.chunk_ptr[11] > 1
    tf, tb = _plans(g, "bf16" if dtype == "bfloat16" else "f32")
    gt = g.to("cpu")
    tj, ti = _planes(xh, ad, asr, dtype)
    jp = lambda t: jnp.asarray(t.numpy())
    seed = jnp.asarray(WORDS, jnp.uint32)

    m, den = gat_row_stats(tj, ti, gt)
    jm = jnp.maximum(_gat_max_call(jp(tj), jp(ti), tf, v, NB, NEG_SLOPE),
                     jax.nn.leaky_relu(jp(ti) + jp(tj), NEG_SLOPE))
    _close(m.numpy(), jm, dtype, "m")
    tim = jnp.concatenate([jp(ti), jp(m)])               # both packages use the port's m
    _close(den.numpy(), _gat_den_call(jp(tj), tim, tf, v, NB, NEG_SLOPE), dtype, "den")

    x = torch.from_numpy(xh.reshape(v, -1)).to(TDT[dtype])
    got = gat_coef_spmm(x, tj, ti, m, WORDS, rate, gt)
    assert got.dtype == torch.float32 and got.shape == x.shape
    ref = _gat_coef_spmm_call(jnp.asarray(x.float().numpy(), JDT[dtype]), jp(tj), tim, seed, tf,
                              NB, HEADS, NEG_SLOPE, True, rate)
    _close(got.numpy(), ref, dtype, "K9")

    w = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    got = gat_coef_spmm_t(w, tj, ti, m, WORDS, rate, gt)
    ref = _gat_coef_spmm_call(jp(w), tim, jp(tj), seed, tb, NB, HEADS, NEG_SLOPE, False, rate)
    _close(got.numpy(), ref, dtype, "K9T")

    dD = torch.from_numpy(rng.standard_normal((HEADS, v)).astype(np.float32))
    dtj, dti = gat_sddmm_chain(x, w, tj, ti, m, dD, WORDS, rate, gt)
    rext = jnp.concatenate([jp(ti), jp(m), jp(dD)])
    rtj, rti = _gat_sddmm_chain_call(jnp.asarray(x.float().numpy(), JDT[dtype]), jp(w), jp(tj),
                                     rext, seed, tf, NB, HEADS, NEG_SLOPE, rate)
    _close(dtj.numpy(), rtj, dtype, "dtj")
    _close(dti.numpy(), rti, dtype, "dti")
    if shape == "masked_rows":
        dead = [20, 21, v - 1]
        np.testing.assert_array_equal(m.numpy()[:, dead], np.asarray(jm)[:, dead])
        assert not den[:, dead].any() and not dti[:, dead].any()


@pytest.mark.parametrize("heads,dtype,rate,shape", [
    (1, "float32", RATE, "sender_hub"),
    (1, "bfloat16", 0.0, "masked_rows"),
    (2, "bfloat16", RATE, "sender_hub"),
    (2, "float32", 0.0, "masked_rows"),
    (8, "float32", 0.0, "sender_hub"),
    (8, "bfloat16", RATE, "masked_rows"),
])
def test_coef_spmm_twins_match_pallas_at_heads(heads, dtype, rate, shape):
    """K9 and K9T's twins against _gat_coef_spmm_call on the forward and the
    transposed plan at the other head counts the kernels take (1, 2, 8; 8
    features a head), on ``_walk_inputs``' shapes (V 256, E 700), to
    TWIN_TOL as at HEADS; m is K8's twin's, handed to both packages."""
    rng = np.random.default_rng(10 + heads)
    g, xh, ad, asr = _walk_inputs(rng, shape, heads=heads)
    v = g.num_nodes
    tf, tb = _plans(g, "bf16" if dtype == "bfloat16" else "f32")
    gt = g.to("cpu")
    tj, ti = _planes(xh, ad, asr, dtype)
    m, _ = gat_row_stats(tj, ti, gt)
    jp = lambda t: jnp.asarray(t.numpy())
    seed = jnp.asarray(WORDS, jnp.uint32)
    tim = jnp.concatenate([jp(ti), jp(m)])
    x = torch.from_numpy(xh.reshape(v, -1)).to(TDT[dtype])
    got = gat_coef_spmm(x, tj, ti, m, WORDS, rate, gt)
    assert got.dtype == torch.float32 and got.shape == x.shape
    ref = _gat_coef_spmm_call(jnp.asarray(x.float().numpy(), JDT[dtype]), jp(tj), tim, seed, tf,
                              NB, heads, NEG_SLOPE, True, rate)
    _close(got.numpy(), ref, dtype, "K9")
    w = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    got = gat_coef_spmm_t(w, tj, ti, m, WORDS, rate, gt)
    ref = _gat_coef_spmm_call(jp(w), tim, jp(tj), seed, tb, NB, heads, NEG_SLOPE, False, rate)
    _close(got.numpy(), ref, dtype, "K9T")


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_fused_aggregate_matches_jax_vjp(rate):
    """gat_aggregate_sparse_fused's forward and its VJP (dxh, datt_dst,
    datt_src) against cal_tpu's on f32 plans, the same seed words."""
    rng = np.random.default_rng(2)
    g, xh, ad, asr = _gat_inputs(rng)
    tf, tb = _plans(g, "f32")
    gout = rng.standard_normal(xh.shape).astype(np.float32)
    seed = jnp.asarray(WORDS, jnp.uint32)
    ref, vjp = jax.vjp(lambda a, b, c: jax_gat_fused(a, b, c, seed, tf, tb, rate, NB),
                       *map(jnp.asarray, (xh, ad, asr)))
    ref_grads = vjp(jnp.asarray(gout))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xh, ad, asr)]
    out = gat_aggregate_sparse_fused(*leaves, WORDS, g.to("cpu"), rate)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TWIN_TOL["float32"])
    got = torch.autograd.grad(out, leaves, torch.from_numpy(gout))
    for name, a, b in zip(("dxh", "datt_dst", "datt_src"), got, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **VJP_TOL)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_fused_backward_matches_autograd_of_twins(rate):
    """The Function's written-out VJP (K9T, K10 and the plain self terms)
    against torch.autograd of the same forward built from the twins."""
    rng = np.random.default_rng(3)
    g, xh, ad, asr = _gat_inputs(rng, heads=2, d=16)
    gt = g.to("cpu")
    a = [torch.from_numpy(u).requires_grad_() for u in (xh, ad, asr)]
    b = [torch.from_numpy(u).requires_grad_() for u in (xh, ad, asr)]
    got = gat_aggregate_sparse_fused(*a, WORDS, gt, rate)
    ref = gat_aggregate_sparse_fused_plain(*b, WORDS, gt, rate)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    cot = torch.from_numpy(rng.standard_normal(xh.shape).astype(np.float32))
    for u, w in zip(torch.autograd.grad(got, a, cot), torch.autograd.grad(ref, b, cot)):
        torch.testing.assert_close(u, w, **AUTOGRAD_TOL)


def test_fused_twin_matches_the_edge_references():
    """At rate 0 the fused twin equals the port's [E, heads] reference and
    cal_tpu's XLA ``gat_aggregate_sparse``."""
    rng = np.random.default_rng(4)
    g, xh, ad, asr = _gat_inputs(rng)
    gt = g.to("cpu")
    t = [torch.from_numpy(u) for u in (xh, ad, asr)]
    got = gat_aggregate_sparse_fused(*t, (0, 0), gt)
    ours = gat_aggregate_sparse(t[0], gt.senders, gt.receivers, gt.edge_mask, t[1], t[2])
    ref = jax_gat_sparse(*map(jnp.asarray, (xh, g.senders, g.receivers, g.edge_mask, ad, asr)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TWIN_TOL["float32"])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TWIN_TOL["float32"])


def test_dropout_law_and_replay():
    """Keep fraction of the edge hash near 1 - rate over (edge, head), the
    output unbiased on |xh|, and the same seed words replay the same
    output while other words move it."""
    rng = np.random.default_rng(5)
    g, xh, ad, asr = _gat_inputs(rng)
    gt = g.to("cpu")
    e = g.senders.shape[0]
    keep = keep_mask(head_ids(torch.arange(200 * e), HEADS), WORDS, RATE, 0)
    assert abs(float(keep.mean()) - (1 - RATE)) < 5e-3
    t = [torch.from_numpy(u) for u in (np.abs(xh), ad, asr)]
    base = gat_aggregate_sparse_fused(*t, WORDS, gt).sum()
    draws = [gat_aggregate_sparse_fused(*t, (w, 3 * w + 1), gt, RATE) for w in range(1, 9)]
    ratio = float(sum(d.sum() for d in draws) / (8 * base))
    assert abs(ratio - 1.0) < 0.02, ratio
    torch.testing.assert_close(gat_aggregate_sparse_fused(*t, (1, 4), gt, RATE), draws[0],
                               rtol=0, atol=0)
    assert not torch.equal(draws[0], draws[1])


def test_large_score_spread_stays_finite():
    """Scores ~hundreds apart (large attention vectors): the max is taken
    over live edges and the self loop, every weight stays finite, and the
    forward and gradients match cal_tpu's on f32 plans."""
    rng = np.random.default_rng(6)
    g, xh, ad, asr = _gat_inputs(rng)
    ad, asr = 40 * ad, 40 * asr
    tf, tb = _plans(g, "f32")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xh, ad, asr)]
    out = gat_aggregate_sparse_fused(*leaves, (0, 0), g.to("cpu"))
    assert torch.isfinite(out).all()
    seed = jnp.zeros((2,), jnp.uint32)
    ref, vjp = jax.vjp(lambda a, b, c: jax_gat_fused(a, b, c, seed, tf, tb, 0.0, NB),
                       *map(jnp.asarray, (xh, ad, asr)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    got = torch.autograd.grad(out.sum(), leaves)
    for a, b in zip(got, vjp(jnp.ones(xh.shape, jnp.float32))):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-3)


def _gat_batches(dtype, **kw):
    jg, tg = _host_graphs(seed=2, count=7, hub=50)
    budgets = _sparse_budgets(tg, 8)
    jb = next(JaxLoader(jg, 8, layout="sparse", budgets=budgets, prefetch=0).host_batches())
    tb = next(Loader(tg, 8, budgets=budgets, layout="sparse").host_batches())
    g_j = _jax_sparse_graph(jb, "bf16" if dtype == "bfloat16" else "f32")
    jm, variables, tm = _models(dtype, g_j, 6, backbone="gat", heads=HEADS, **kw)
    return g_j, tb, jm, variables, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_gat_eval_forward_matches_jax(dtype):
    """Sparse CausalGAT built from a cal_tpu sparse CausalGAT's params
    (``params_from_jax``): log-probs on a tiled batch with a padded slot."""
    g_j, tb, jm, variables, tm = _gat_batches(dtype)
    assert set(dict(tm.named_parameters())) >= {"convs_0.kernel", "convs_0.att", "convs_0.bias"}
    ref = jm.apply(variables, g_j, eval_random=False, train=False)
    with torch.no_grad():
        ours = tm(tb.to("cpu"), eval_random=False, train=False)
    real = tb.graph_mask
    assert not real.all()
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy()[real], np.asarray(b)[real], **FWD_TOL[dtype])


def test_sparse_gat_forward_equals_dense_forward():
    """The port's two layouts compute the same CausalGAT at eval."""
    _, tg = _host_graphs(seed=4, count=10, hub=40)
    tm = CausalGNN(num_features=6, hidden=HIDDEN, num_classes=CLASSES, num_layers=LAYERS,
                   backbone="gat", heads=HEADS, seed=3).eval()
    sparse = list(Loader(tg, 4, layout="sparse").host_batches())
    dense = list(Loader(tg, 4).host_batches())
    with torch.no_grad():
        for sb, db in zip(sparse, dense, strict=True):
            a = tm(sb.to("cpu"), eval_random=False)
            b = tm(to_dense(db.to("cpu")), eval_random=False)
            real = sb.graph_mask
            for u, w in zip(a, b):
                torch.testing.assert_close(u[real], w[real], rtol=1e-5, atol=1e-5)


def test_sparse_gat_train_step_matches_jax_f32():
    """gat_dropout 0: gradients name by name, the step's loss sums and the
    parameters after one Adam step, against _causal_step_fn on f32 plans
    (the Pallas fused GAT, pair and pool VJPs)."""
    g_j, tb, jm, variables, tm = _gat_batches("float32", gat_dropout=0.0)
    tx = jax_make_optimizer(LR, MIN_LR, EPOCHS, 3, WD)
    jstate = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32))
    state = TrainState(tm, make_optimizer(tm.parameters(), WD))
    step = make_causal_train_step(state, cosine_lr(LR, MIN_LR, EPOCHS, 3), C_W, O_W, CO_W,
                                  False, seed=0)
    ref_grads = _jax_grads(jm, jstate, g_j)
    jstate, jm_out = jax.jit(_causal_step_fn(jm, tx, C_W, O_W, CO_W, False))(
        jstate, g_j, jax.random.PRNGKey(0))
    ours = step(tb, None)
    assert np.abs(ref_grads["convs_0.att"]).max() > 0
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(ours.numpy(), [float(jm_out[k]) for k in _METRICS], rtol=1e-5)
    assert state.step == int(jstate.step) == 1
    # Adam's first update is ~lr * sign(g): an entry whose gradient sits at
    # the rounding-noise floor may move 2 lr apart (test_torch_port_train.py)
    ref_p = _flat(jstate.params)
    diffs = np.concatenate([np.abs(p.detach().numpy() - ref_p[n]).ravel()
                            for n, p in state.model.named_parameters()])
    assert diffs.max() <= 2 * LR and np.mean(diffs <= 1e-5) >= 0.999


def test_sparse_gat_step_runs_dropout_and_differs_from_eval():
    """With gat_dropout on (no intervention shuffle), the sparse step draws
    the layers' keep bits from (seed, step, layer): two runs of one step
    agree, another seed differs."""
    _, tg = _host_graphs(seed=4, count=10, hub=40)
    batch = next(Loader(tg, 8, layout="sparse").host_batches())
    sums = []
    for seed in (1, 1, 2):
        model = CausalGNN(num_features=6, hidden=HIDDEN, num_classes=CLASSES,
                          num_layers=LAYERS, backbone="gat", heads=HEADS, seed=3)
        state = TrainState(model, make_optimizer(model.parameters(), WD))
        step = make_causal_train_step(state, lambda s: LR, C_W, O_W, CO_W, False, seed=seed)
        sums.append(step(batch, None))
        assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    torch.testing.assert_close(sums[0], sums[1], rtol=0, atol=0)
    assert not torch.equal(sums[0], sums[2])


def test_main_syn_sparse_gat_train_save_serve_resume(tmp_path, capsys):
    """main_syn --model CausalGAT --layout sparse on the CPU: a rerun gives
    the same losses; --inference of the checkpoint gives the saved
    accuracies on both layouts; --resume continues after it."""
    argv = ["--model", "CausalGAT", "--device", "cpu", "--data_num", "20", "--node_num", "4",
            "--hidden", str(HIDDEN), "--layers", str(LAYERS), "--batch_size", "8",
            "--lr", "0.01", "--seed", "5", "--save_dir", str(tmp_path)]
    trained = main(argv + ["--layout", "sparse", "--epochs", "3", "--save_model", "true"])
    again = main(argv + ["--layout", "sparse", "--epochs", "3"])
    assert [h["loss"] for h in trained["history"]] == [h["loss"] for h in again["history"]]
    assert all(np.isfinite(h["loss"]) for h in trained["history"])
    served = {lay: main(argv + ["--inference", "true", "--layout", lay])
              for lay in ("sparse", "dense")}
    assert served["sparse"]["graphs"] == served["dense"]["graphs"] > 8
    for k in ("test_acc_co", "test_acc_c", "test_acc_o"):
        assert served["sparse"][k] == served["dense"][k] == trained[k], k
    meta = Checkpointer(str(tmp_path)).restore(
        CausalGNN(10, HIDDEN, CLASSES, num_layers=LAYERS, backbone="gat"))
    capsys.readouterr()
    resumed = main(argv + ["--layout", "sparse", "--epochs", "5", "--save_model", "true",
                           "--resume", "true"])
    assert "resumed from checkpoint at epoch {}".format(meta["epoch"]) in capsys.readouterr().out
    assert [h["epoch"] for h in resumed["history"]] == list(range(meta["epoch"] + 1, 6))
