"""The port's CausalGIN and GCN/GIN/GAT baselines against the JAX package.

The plain twins of the coefficient SpMM kernels (K11 forward, K11T
transposed, K12 SDDMM) against cal_tpu's ``coo_spmm`` and ``jax.vjp`` of it
(Pallas in interpret mode on the CPU, small f32 and bf16 tile plans as in
tests/test_torch_port_sparse.py) and the Function's backward against
torch.autograd of the twins; ``gin_aggregate`` on both layouts; the eval
forwards of CausalGIN and of each baseline on both layouts and dtypes from
the same flax weights; one train step of each
against cal_tpu's step functions; both trainers against cal_tpu's; and
``main_syn`` for the new models.  Small sizes (hidden 16, 2 layers,
V <= 1024)."""
import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_model import _batches, _flat_bn, _graphs, _unflat
from test_torch_port_sparse import (
    CLASSES,
    FWD_TOL,
    HIDDEN,
    LAYERS,
    NB,
    _host_graphs,
    _jax_sparse_graph,
    _plans,
    _randomize,
    _sparse_budgets,
    _workload,
)
from test_torch_port_train import _flat

import cal_tpu.ops.pallas_spmm as jax_pallas_spmm
import cal_tpu.train.baseline as jax_baseline_mod
import cal_tpu.train.causal as jax_causal_train_mod
import cal_tpu_torch.ops.coo_spmm as coo_mod
import cal_tpu_torch.train.steps as steps_mod
from cal_tpu.data.loader import Loader as JaxLoader
from cal_tpu.data.synthetic import dataset_bias_split as jax_split
from cal_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from cal_tpu.models.baselines import BaselineGNN as JaxBaselineGNN
from cal_tpu.models.causal import CausalGNN as JaxCausalGNN
from cal_tpu.ops.gin import gin_aggregate as jax_gin_aggregate
from cal_tpu.ops.pallas_spmm import coo_spmm as jax_coo_spmm
from cal_tpu.train.baseline import train_baseline_syn as jax_train_baseline_syn
from cal_tpu.train.causal import train_causal_syn as jax_train_causal_syn
from cal_tpu.train.losses import causal_losses as jax_causal_losses
from cal_tpu.train.optim import make_optimizer as jax_make_optimizer
from cal_tpu.train.steps import TrainState as JaxTrainState
from cal_tpu.train.steps import _as_graph, _baseline_step_fn, _causal_step_fn, to_device
from cal_tpu.utils.config import Config as JaxConfig
from cal_tpu_torch.data.loader import Loader
from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
from cal_tpu_torch.graph import sparse_batch, to_dense
from cal_tpu_torch.main_syn import main
from cal_tpu_torch.models.baselines import BaselineGNN
from cal_tpu_torch.models.causal import CausalGNN
from cal_tpu_torch.ops.gin import gin_aggregate
from cal_tpu_torch.train.baseline import train_baseline_syn
from cal_tpu_torch.train.causal import train_causal_syn
from cal_tpu_torch.train.optim import cosine_lr, make_optimizer
from cal_tpu_torch.train.steps import (
    TrainState,
    make_baseline_train_step,
    make_causal_train_step,
)
from cal_tpu_torch.utils.checkpoint import Checkpointer, params_from_jax
from cal_tpu_torch.utils.config import Config

C_W, O_W, CO_W = 0.5, 1.0, 0.5
LR, MIN_LR, EPOCHS, WD = 1e-3, 1e-5, 2, 1e-3
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODELS = ("CausalGIN", "GCN", "GIN", "GAT")
# Kernel twins against coo_spmm, f32 plans: the same f32 products summed in
# another order (tile slots vs CSR rows).
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 plans: cal_tpu rounds every per-edge product coef * x (and, in the
# VJP, the cotangent g and then coef * g) to bf16 before its f32 sums
# (pallas_spmm.py:364-375, :586-590); the port keeps them f32.  A rounding
# to nearest bf16 (8 significant bits) moves a value by at most 2^-8 of it,
# two of them (g, then the product) by at most (1 + 2^-8)^2 - 1 < 2^-7 +
# 2^-15, so each output lies within that much of the sum of its terms'
# magnitudes (plus f32 summation noise, 1e-5) of the port's; K12's dot
# products likewise over |g_h x_h|.
BF16_TERM_TOL = 2.0 ** -7 * (1 + 2.0 ** -8)


def _coo_workload(seed, h=16):
    """``_workload`` (self loops, a hub row of 90 in-edges, a masked padded
    run at V-1) plus five copies of one edge (a multigraph edge)."""
    rng = np.random.default_rng(seed)
    g, (x, _), _ = _workload(rng, h=h)
    s, r, m = np.asarray(g.senders), np.asarray(g.receivers), np.asarray(g.edge_mask)
    n_real = int(m.sum())
    dup = np.full(5, 11)
    s = np.concatenate([s[:n_real], dup, s[n_real:]])
    r = np.concatenate([r[:n_real], dup + 3, r[n_real:]])
    m = np.concatenate([m[:n_real], np.ones(5, bool), m[n_real:]])
    o = np.argsort(r, kind="stable")
    s, r, m = s[o], r[o], m[o]
    v = g.num_nodes
    g = sparse_batch(np.zeros((v, 1), np.float32), s, r, m, np.ones(v, bool),
                     np.zeros(v, np.int32), np.zeros(1, np.int32), np.ones(1, bool))
    assert ((s == r) & m).any() and g.recv.num_chunks > v + 1
    return g, x, rng


def _coefs(which, g, rng):
    e = g.senders.shape[0]
    if which == "mask":
        return np.asarray(g.edge_mask, np.float32)
    return rng.standard_normal(e).astype(np.float32)          # dead edges too


def _assert_term_bound(got, ref, terms, what):
    """|got - ref| <= BF16_TERM_TOL * terms + 1e-5, elementwise."""
    excess = np.abs(got - ref) - (BF16_TERM_TOL * terms + 1e-5)
    assert excess.max() <= 0, f"{what}: over the bf16 term bound by {excess.max()}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["mask", "random"])
def test_coo_twins_match_pallas(dtype, which):
    """K11, K11T and K12 twins against coo_spmm and jax.vjp(coo_spmm) on f32
    and bf16 tile plans, at coef = edge mask (GIN) and at a random coef on
    every edge; dcoef covers the dead edges as cal_tpu's plan does."""
    g, x, rng = _coo_workload(0)
    coef = _coefs(which, g, rng)
    if dtype == "bfloat16":
        x = np.asarray(torch.from_numpy(x).bfloat16().float())   # bf16-valued x
    gout = rng.standard_normal(x.shape).astype(np.float32)
    tf, tb = _plans(g, "bf16" if dtype == "bfloat16" else "f32")
    coef_ext = jnp.asarray(np.concatenate([coef, [0.0]]).astype(np.float32))
    ref, vjp = jax.vjp(lambda a, c: jax_coo_spmm(a, c, tf, tb, NB), jnp.asarray(x), coef_ext)
    ref_dx, ref_dcoef = (np.asarray(a) for a in vjp(jnp.asarray(gout)))
    assert ref_dcoef[-1] == 0.0
    gt = g.to("cpu")
    tx = torch.from_numpy(x).to(TDT[dtype])
    tc, tg = torch.from_numpy(coef), torch.from_numpy(gout)
    out = coo_mod.coo_spmm(tx, tc, gt)
    dx = coo_mod.coo_spmm_t(tg, tc, gt)
    dcoef = coo_mod.coo_sddmm(tx, tg, gt)
    assert out.dtype == dx.dtype == dcoef.dtype == torch.float32
    assert dcoef.shape == (g.senders.shape[0],)
    dead = ~np.asarray(g.edge_mask)
    assert np.abs(ref_dcoef[:-1][dead]).min() > 0          # dead edges get their dcoef
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
        np.testing.assert_allclose(dx.numpy(), ref_dx, **F32_TOL)
        np.testing.assert_allclose(dcoef.numpy(), ref_dcoef[:-1], **F32_TOL)
        return
    s, r = np.asarray(g.senders), np.asarray(g.receivers)
    ac = np.abs(coef)[:, None]
    fwd_terms = np.zeros_like(x)
    np.add.at(fwd_terms, r, ac * np.abs(x[s]))
    bwd_terms = np.zeros_like(x)
    np.add.at(bwd_terms, s, ac * np.abs(gout[r]))
    _assert_term_bound(out.numpy(), np.asarray(ref), fwd_terms, "K11")
    _assert_term_bound(dx.numpy(), ref_dx, bwd_terms, "K11T")
    _assert_term_bound(dcoef.numpy(), ref_dcoef[:-1],
                       (np.abs(gout[r]) * np.abs(x[s])).sum(-1), "K12")
    if which == "mask":       # 0/1 coefficients on bf16 values: exact products
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


def test_coo_aggregate_backward_matches_autograd():
    """The Function's f32 backward (K11T twin for dx, K12 twin for dcoef)
    against torch.autograd of the forward twin; K12 runs only when coef
    needs a gradient."""
    g, x, rng = _coo_workload(1)
    gt = g.to("cpu")
    coef = rng.standard_normal(g.senders.shape[0]).astype(np.float32)
    a = [torch.from_numpy(u).requires_grad_() for u in (x, coef)]
    b = [torch.from_numpy(u).requires_grad_() for u in (x, coef)]
    out = coo_mod.coo_aggregate(a[0], a[1], gt)
    ref = coo_mod.coo_spmm_plain(b[0], b[1], gt)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    cot = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    for u, w in zip(torch.autograd.grad(out, a, cot), torch.autograd.grad(ref, b, cot)):
        torch.testing.assert_close(u, w, rtol=1e-5, atol=1e-5)
    calls = []
    real = coo_mod.coo_sddmm
    with mock.patch.object(coo_mod, "coo_sddmm", lambda *z: calls.append(1) or real(*z)):
        leaf = torch.from_numpy(x).bfloat16().requires_grad_()
        agg = coo_mod.coo_aggregate(leaf, torch.from_numpy(coef), gt)
        (dx,) = torch.autograd.grad(agg, leaf, cot)
    assert not calls and dx.dtype == torch.bfloat16


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gin_aggregate_matches_jax(layout, dtype):
    """x + neighbour sum (GIN's fixed eps 0) against cal_tpu's
    gin_aggregate on the same batch
    (sparse: a tiled batch, so cal_tpu runs coo_spmm); self loops and
    duplicate edges count as edges.  Both layouts agree in f32."""
    jg, tg = _host_graphs(seed=3, count=7, hub=50)
    bs = 8
    feat = 16
    rng = np.random.default_rng(5)
    if layout == "sparse":
        budgets = _sparse_budgets(tg, bs)
        jb = next(JaxLoader(jg, bs, layout="sparse", budgets=budgets, prefetch=0).host_batches())
        tb = next(Loader(tg, bs, budgets=budgets, layout="sparse").host_batches()).to("cpu")
        g_j = _jax_sparse_graph(jb, "bf16" if dtype == "bfloat16" else "f32")
        x = rng.standard_normal((tb.num_nodes, feat)).astype(np.float32)
        g_t = tb
    else:
        (jb, tb), = _batches(jg, tg, bs)[:1]
        g_j = _as_graph(to_device(jb), JDT[dtype] if dtype == "bfloat16" else None)
        g_t = to_dense(tb.to("cpu"), TDT[dtype])
        x = rng.standard_normal(tuple(g_t.x.shape[:2]) + (feat,)).astype(np.float32)
    tx = torch.from_numpy(x).to(TDT[dtype])
    ref = jax_gin_aggregate(jnp.asarray(x, JDT[dtype]), g_j)
    got = gin_aggregate(tx, g_t)
    assert got.dtype == TDT[dtype]
    tol = F32_TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)


def _jax_model(name, dtype, **kw):
    jdt = JDT[dtype]
    if name.startswith("Causal"):
        bb = name[len("Causal"):].lower()
        return JaxCausalGNN(backbone=bb, hidden=HIDDEN, num_classes=CLASSES,
                            num_layers=LAYERS, dtype=jdt, **kw), True
    bb = name.lower()
    return JaxBaselineGNN(backbone=bb, hidden=HIDDEN, num_classes=CLASSES, num_layers=LAYERS,
                          dtype=jdt, **kw), False


def _port_model(name, dtype, num_features, **kw):
    tdt = TDT[dtype]
    if name.startswith("Causal"):
        return CausalGNN(num_features, HIDDEN, CLASSES, num_layers=LAYERS,
                         backbone=name[len("Causal"):].lower(), dtype=tdt, **kw)
    return BaselineGNN(num_features, HIDDEN, CLASSES, num_layers=LAYERS,
                       backbone=name.lower(), dtype=tdt, **kw)


def _model_pair(name, dtype, g_j, num_features, **kw):
    """cal_tpu and port models of ``name`` with the same perturbed weights
    and BatchNorm statistics (``params_from_jax``, strict load)."""
    jm, causal = _jax_model(name, dtype, **kw)
    key = jax.random.PRNGKey(0)
    extra = {"eval_random": False} if causal else {}
    variables = jax.jit(lambda k: jm.init({"params": k, "intervention": k, "dropout": k},
                                          g_j, train=False, **extra))(key)
    rng = np.random.default_rng(0)
    params = _randomize(variables["params"], rng)
    stats = _unflat({k: {"mean": rng.normal(0, 0.5, v["mean"].shape).astype(np.float32),
                         "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
                     for k, v in _flat_bn(variables["batch_stats"]).items()})
    tm = _port_model(name, dtype, num_features, **kw)
    tm.load_state_dict(params_from_jax(params, stats))
    return jm, {"params": params, "batch_stats": stats}, tm, causal


def _dropout_free(name):
    return {"dropout": 0.0} if name == "GAT" else {}


def _layout_batches(layout, dtype, seed=2):
    jg, tg = _host_graphs(seed=seed, count=7, hub=50)
    if layout == "sparse":
        budgets = _sparse_budgets(tg, 8)
        jb = next(JaxLoader(jg, 8, layout="sparse", budgets=budgets, prefetch=0).host_batches())
        tb = next(Loader(tg, 8, budgets=budgets, layout="sparse").host_batches())
        return _jax_sparse_graph(jb, "bf16" if dtype == "bfloat16" else "f32"), tb
    (jb, tb), = _batches(jg, tg, 8)[:1]
    return _as_graph(to_device(jb), JDT[dtype] if dtype == "bfloat16" else None), tb


def _port_graph(tb, dtype):
    return tb.to("cpu") if hasattr(tb, "recv") else to_dense(tb.to("cpu"), TDT[dtype])


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_matches_jax(name, layout, dtype):
    """Eval log-probs of each new model from a cal_tpu model's weights, on a
    batch with a padded graph slot (sparse: a tiled batch)."""
    g_j, tb = _layout_batches(layout, dtype)
    jm, variables, tm, causal = _model_pair(name, dtype, g_j, 6, **_dropout_free(name))
    g_t = _port_graph(tb, dtype)
    with torch.no_grad():
        if causal:
            ref = jm.apply(variables, g_j, eval_random=False, train=False)
            ours = tm(g_t, eval_random=False, train=False)
        else:
            ref, ours = (jm.apply(variables, g_j, train=False),), (tm(g_t, train=False),)
    real = np.asarray(g_t.graph_mask)
    assert not real.all()
    for a, b in zip(ours, ref, strict=True):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy()[real], np.asarray(b)[real], **FWD_TOL[dtype])


@pytest.mark.parametrize("name", MODELS)
def test_sparse_forward_equals_dense_forward(name):
    """The port's two layouts compute the same model at eval, f32."""
    _, tg = _host_graphs(seed=4, count=10, hub=40)
    tm = _port_model(name, "float32", 6, seed=3).eval()
    with torch.no_grad():
        for sb, db in zip(Loader(tg, 4, layout="sparse").host_batches(),
                          Loader(tg, 4).host_batches(), strict=True):
            outs = []
            for g in (sb.to("cpu"), to_dense(db.to("cpu"))):
                out = (tm(g, eval_random=False) if name.startswith("Causal") else (tm(g),))
                outs.append(out)
            real = sb.graph_mask
            for u, w in zip(*outs):
                torch.testing.assert_close(u[real], w[real], rtol=1e-5, atol=1e-5)


def test_params_from_jax_covers_gin_and_baseline_trees():
    """Every leaf of cal_tpu's CausalGIN and baseline trees, MaskedBatchNorm
    statistics nested under ``convs_i.bn`` included, names a port tensor,
    and the port has no tensor without a leaf."""
    g_j, _ = _layout_batches("dense", "float32")
    for name in MODELS:
        jm, causal = _jax_model(name, "float32")
        extra = {"eval_random": False} if causal else {}
        key = jax.random.PRNGKey(1)
        shapes = jax.eval_shape(lambda k: jm.init(
            {"params": k, "intervention": k, "dropout": k}, g_j, train=False, **extra), key)
        zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
        sd = params_from_jax(zeros["params"], zeros["batch_stats"])
        port = _port_model(name, "float32", 6).state_dict()
        assert set(sd) == set(port), name
        for k, v in sd.items():
            assert v.shape == port[k].shape, (name, k)
        if name.endswith("GIN"):
            assert {"convs_0.bn.mean", "convs_0.bn.var", "convs_1.lin2.kernel"} <= set(sd)


def _jax_state(variables, tx):
    return JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                         opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))


# Step gradients against cal_tpu: rtol 1e-4, atol 1e-5 as the CausalGCN step
# tests.  A GIN stack sums neighbours unnormalized (a hub row of 50+
# in-edges here) before each BatchNorm, which leaves its gradients
# ill-conditioned: cal_tpu's own gradients move by up to 7e-5 of a tensor's
# largest entry when each weight moves by one f32 ulp (measured on this
# batch: convs_0.lin1.kernel 6.8e-5, conv_feat.kernel 2.7e-5).  For GIN
# models atol is 1e-4 of the tensor's largest entry.
GIN_GRAD_ATOL = 1e-4


def _assert_step_matches(state, jstate, ref_grads, gin: bool = False):
    for name, p in state.model.named_parameters():
        ref = ref_grads[name]
        atol = max(1e-5, GIN_GRAD_ATOL * np.abs(ref).max()) if gin else 1e-5
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-4, atol=atol, err_msg=name)
    assert state.step == int(jstate.step) == 1
    # Adam's first update is ~lr * sign(g): an entry whose gradient sits at
    # the rounding-noise floor may move 2 lr apart (test_torch_port_train.py)
    ref_p, ref_s = _flat(jstate.params), _flat(jstate.batch_stats)
    diffs = np.concatenate([np.abs(p.detach().numpy() - ref_p[n]).ravel()
                            for n, p in state.model.named_parameters()])
    assert diffs.max() <= 2 * LR and np.mean(diffs <= 1e-5) >= 0.999
    for name, b in state.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref_s[name], rtol=1e-4, atol=1e-4, err_msg=name)


def test_causal_gin_sparse_train_step_matches_jax():
    """One sparse CausalGIN step on f32 tile plans against _causal_step_fn:
    gradients name by name, loss sums, parameters and BatchNorm running
    stats (the GIN layers' own BN included) after one Adam step."""
    g_j, tb = _layout_batches("sparse", "float32")
    jm, variables, tm, _ = _model_pair("CausalGIN", "float32", g_j, 6)
    tx = jax_make_optimizer(LR, MIN_LR, EPOCHS, 3, WD)
    jstate = _jax_state(variables, tx)
    key = jax.random.PRNGKey(0)

    def loss_fn(params):
        (c, o, co), _ = jm.apply({"params": params, "batch_stats": jstate.batch_stats}, g_j,
                                 eval_random=False, train=True,
                                 rngs={"intervention": key, "dropout": key},
                                 mutable=["batch_stats"])
        return jax_causal_losses(c, o, co, g_j.y, g_j.graph_mask, C_W, O_W, CO_W)[0]

    ref_grads = _flat(jax.jit(jax.grad(loss_fn))(jstate.params))
    jstate, jm_out = jax.jit(_causal_step_fn(jm, tx, C_W, O_W, CO_W, False))(jstate, g_j, key)
    state = TrainState(tm, make_optimizer(tm.parameters(), WD))
    step = make_causal_train_step(state, cosine_lr(LR, MIN_LR, EPOCHS, 3), C_W, O_W, CO_W,
                                  False, seed=0)
    ours = step(tb, None)
    np.testing.assert_allclose(
        ours.numpy(), [float(jm_out[k]) for k in ("loss", "loss_c", "loss_o", "loss_co",
                                                  "correct_o", "n")], rtol=1e-5)
    assert np.abs(ref_grads["convs_0.lin1.kernel"]).max() > 0
    _assert_step_matches(state, jstate, ref_grads, gin=True)


@pytest.mark.parametrize("name", ["GCN", "GIN", "GAT"])
def test_baseline_train_step_matches_jax(name):
    """One sparse baseline step (GAT at dropout 0) against _baseline_step_fn
    on f32 tile plans: the loss and correct sums, gradients, parameters and
    BatchNorm stats after one Adam step."""
    g_j, tb = _layout_batches("sparse", "float32")
    jm, variables, tm, _ = _model_pair(name, "float32", g_j, 6, **_dropout_free(name))
    tx = jax_make_optimizer(LR, MIN_LR, EPOCHS, 3, WD)
    jstate = _jax_state(variables, tx)
    key = jax.random.PRNGKey(0)

    def loss_fn(params):
        out, _ = jm.apply({"params": params, "batch_stats": jstate.batch_stats}, g_j,
                          train=True, rngs={"dropout": key}, mutable=["batch_stats"])
        picked = jnp.take_along_axis(out, g_j.y[:, None], 1)[:, 0]
        m = g_j.graph_mask.astype(out.dtype)
        return -(picked * m).sum() / m.sum()

    ref_grads = _flat(jax.jit(jax.grad(loss_fn))(jstate.params))
    jstate, aux = jax.jit(_baseline_step_fn(jm, tx))(jstate, g_j, key)
    state = TrainState(tm, make_optimizer(tm.parameters(), WD))
    step = make_baseline_train_step(state, cosine_lr(LR, MIN_LR, EPOCHS, 3), seed=0)
    ours = step(tb, None)
    np.testing.assert_allclose(ours.numpy(), [float(aux[k]) for k in ("loss", "correct", "n")],
                               rtol=1e-5)
    _assert_step_matches(state, jstate, ref_grads, gin=name == "GIN")


def test_baseline_step_skips_a_batch_without_real_graphs():
    _, tg = _host_graphs(seed=4, count=3)
    batch = next(Loader(tg, 4, layout="sparse").host_batches())
    model = _port_model("GIN", "float32", 6)
    state = TrainState(model, make_optimizer(model.parameters(), WD))
    step = make_baseline_train_step(state, lambda s: LR, seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    empty = dataclasses.replace(batch, graph_mask=np.zeros_like(batch.graph_mask))
    sums = torch.arange(3.0)
    assert step(empty, sums) is sums and state.step == 0
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert step(batch, None) is not None and state.step == 1


def test_gat_baseline_head_dropout_law():
    """The GAT baseline's dropout before the classifier (rate 0.2, training
    only): each entry of the classifier's input is 0 or its undropped value
    / 0.8, kept with frequency 0.8 (8,192 entries over 64 generator seeds:
    sd 0.0044, held within 0.02); eval draws nothing.  Attention dropout off
    (no layer seeds), so the undropped value is the same forward."""
    _, tg = _host_graphs(seed=4, count=8)
    g = next(Loader(tg, 8, layout="sparse").host_batches()).to("cpu")
    model = _port_model("GAT", "float32", 6, dropout=0.2)
    seen = []
    model.lin_class.register_forward_pre_hook(lambda m, a: seen.append(a[0].detach()))
    gen = torch.Generator()
    kept = total = 0
    for seed in range(64):
        model.dropout = 0.0
        model(g, train=True)
        model.dropout = 0.2
        model(g, train=True, generator=gen.manual_seed(seed))
        base, dropped = seen[-2], seen[-1]
        keep = dropped != 0
        torch.testing.assert_close(dropped[keep], base[keep] / 0.8)
        kept += int(keep[base != 0].sum())
        total += int((base != 0).sum())
    assert abs(kept / total - 0.8) <= 0.02
    with torch.no_grad():
        model(g, train=False, generator=gen.manual_seed(0))
        model.dropout = 0.0
        model(g, train=False)
    torch.testing.assert_close(seen[-2], seen[-1], rtol=0, atol=0)


def _tiny_split(pkg):
    gen, split = (jax_generate, jax_split) if pkg == "jax" else (
        generate_synthetic_dataset, dataset_bias_split)
    ds = gen(data_num=30, node_num=4, max_degree=6, seed=5)
    return split(ds, bias=0.7, total=120, seed=0)[:3]


def _record_init(mod):
    """Patch ``mod.init_state`` to record the initial weights it draws."""
    init = {}
    real = mod.init_state

    def record(*a, **k):
        st = real(*a, **k)
        init.update(params=jax.tree.map(np.asarray, st.params),
                    stats=jax.tree.map(np.asarray, st.batch_stats))
        return st

    return init, mock.patch.object(mod, "init_state", record)


def _from_init(init, name):
    def build(cfg, num_features, num_classes):
        m = (CausalGNN(num_features, cfg.hidden, num_classes, num_layers=cfg.layers,
                       backbone="gin", with_random=cfg.with_random)
             if name == "CausalGIN" else
             BaselineGNN(num_features, cfg.hidden, num_classes, num_layers=cfg.layers,
                         backbone=name.lower()))
        m.load_state_dict(params_from_jax(init["params"], init["stats"]))
        return m

    return build


# A GIN layer's lin1 bias has a zero gradient (a BatchNorm follows it), so
# each package's gradient there is rounding noise of random sign, and Adam
# turns it into a step of ~lr: the two runs part in that bias and in the
# BatchNorm running mean that tracks it, which the eval sweeps read (train
# losses still agree: BatchNorm absorbs the bias in training).  With weight
# decay the bias's gradient is wd * b, far above the noise, so both runs
# take the same steps: the trainer comparisons of GIN models run with it.
GIN_TRAIN_WD = 1e-3


@pytest.mark.parametrize("name,layout", [("GIN", "sparse"), ("GCN", "dense")])
def test_train_baseline_syn_matches_jax(name, layout, capsys):
    """The baseline trainer on the CPU, f32, from cal_tpu's initial weights:
    per-epoch losses within 1e-4 and the same per-epoch and ``syd:`` lines
    but the loss digits (cal_tpu's trainer batches these small splits
    without tile plans: its XLA sparse path)."""
    kw = dict(model=name, epochs=3, batch_size=32, hidden=16, layers=1, lr=0.01, seed=3,
              layout=layout, weight_decay=GIN_TRAIN_WD if name == "GIN" else 0.0)
    jtrain, jval, jtest = _tiny_split("jax")
    init, patch = _record_init(jax_baseline_mod)
    losses = []
    real_epoch = jax_baseline_mod._run_epoch

    def run_epoch(*a):
        out = real_epoch(*a)
        losses.append(out[1])
        return out

    with patch, mock.patch.object(jax_baseline_mod, "_run_epoch", run_epoch):
        capsys.readouterr()
        ref = jax_train_baseline_syn(jtrain, jval, jtest, JaxConfig(scan_epochs=False, **kw))
        ref_out = capsys.readouterr().out
    train, val, test = _tiny_split("torch")
    with mock.patch.object(steps_mod, "get_model", _from_init(init, name)):
        res = train_baseline_syn(train, val, test, Config(device="cpu", **kw))
    out = capsys.readouterr().out
    np.testing.assert_allclose([h["loss"] for h in res["history"]], losses, rtol=1e-4)
    for k in ("best_val_acc", "test_acc", "epoch"):
        assert res[k] == pytest.approx(ref[k], abs=1e-12), k
    strip = lambda text: [ln.split("Loss:")[0] + ln.split("Train:")[-1]
                          for ln in text.splitlines() if ln.startswith(("BIAS:", "syd:"))]
    assert strip(out) == strip(ref_out) and len(strip(out)) == 4


# What a GIN trainer comparison at weight decay 0 leaves out: each GIN
# layer's lin1 bias (zero gradient: rounding noise that Adam turns into
# steps of ~lr in either package) and the BatchNorm running mean that tracks
# it, and so the eval accuracies, which read that running mean.  BatchNorm
# absorbs the bias in training, so the losses, the train accuracies and
# every other parameter follow the same path.
def _gin_noise_param(key):
    return key.endswith(".lin1.bias") or (".bn." in key and key.endswith(".mean"))


def _bias_grads(model) -> dict:
    """Per GIN layer (the module path of its lin1), the (bias, gradient)
    pairs of its lin1 bias at every backward of ``model``: the gradient as
    autograd gives it, before Adam adds the weight-decay term."""
    out = {}
    for name, mod in model.named_modules():
        if name.endswith(".lin1"):
            rec = out[name[:-len(".lin1")]] = []
            mod.bias.register_hook(lambda g, p=mod.bias, rec=rec: rec.append(
                (p.detach().numpy().copy(), g.detach().numpy().copy())))
    return out


def _wd_determined(steps, wd):
    """(channels whose weight-decay term wd * |b| stayed at least 1000 times
    the gradient's rounding at every step, the other channels' tolerance 2
    max |rounding| / wd) from a layer's (bias, gradient) pairs; the
    gradient without weight decay is 0 in theory, so all of it is
    rounding."""
    b = np.stack([s[0] for s in steps])
    g = np.abs(np.stack([s[1] for s in steps]))
    det = (wd * np.abs(b) >= 1000.0 * g).all(0)
    return det, 2.0 * g.max() / wd


def _jax_gin_baseline_reference(tiled, wd, kw, path):
    """cal_tpu's GIN baseline trainer with ``kw`` (tile plans on when
    ``tiled``), pickled to ``path``: the initial weights, each epoch's (loss,
    train accuracy), the loaders' tile flags, whether coo_spmm was traced,
    the result's accuracies and epoch, its final parameters and statistics
    as the port's state dict (NumPy), and the trainer's stdout."""
    import contextlib
    import io
    import pickle

    jtrain, jval, jtest = _tiny_split("jax")
    init, patch = _record_init(jax_baseline_mod)
    epochs, tiles, traced = [], [], []
    real_epoch, real_coo = jax_baseline_mod._run_epoch, jax_pallas_spmm.coo_spmm

    def run_epoch(*a):
        out = real_epoch(*a)
        epochs.append(tuple(float(v) for v in out[1:]))
        return out

    def loader(*a, **k):
        ld = JaxLoader(*a, **{**k, "spmm_tiles": tiled})
        tiles.append(ld.spmm_tiles)
        return ld

    def coo(*a):
        traced.append(1)
        return real_coo(*a)

    out = io.StringIO()
    with patch, mock.patch.object(jax_baseline_mod, "_run_epoch", run_epoch), \
            mock.patch.object(jax_baseline_mod, "Loader", loader), \
            mock.patch.object(jax_pallas_spmm, "coo_spmm", coo), contextlib.redirect_stdout(out):
        ref = jax_train_baseline_syn(jtrain, jval, jtest, JaxConfig(scan_epochs=False, **kw))
    want = params_from_jax(ref["state"].params, ref["state"].batch_stats)
    with open(path, "wb") as f:
        pickle.dump({"init": init, "epochs": epochs, "tiles": tiles, "traced": bool(traced),
                     "result": {k: ref[k] for k in ("best_val_acc", "test_acc", "epoch")},
                     "want": {k: v.numpy() for k, v in want.items()},
                     "stdout": out.getvalue()}, f)


def _single_thread_reference(fn, *args):
    """``fn(*args, path)`` run in a fresh Python with XLA's CPU Eigen pool
    off, and what it pickled to ``path``.  XLA splits a CPU reduction over
    as many threads as the machine has cores, so cal_tpu's f32 numbers
    depend on the core count; one thread makes the reference the same
    everywhere."""
    import os
    import pickle
    import subprocess
    import sys
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.pkl")
        code = (f"import sys; sys.path.insert(0, {here!r}); import conftest; "
                f"import {__name__.rsplit('.', 1)[-1]} as m; "
                f"m.{fn.__name__}(*{args!r}, {path!r})")
        run = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.path.dirname(here),
                             capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stderr[-4000:]
        with open(path, "rb") as f:
            return pickle.load(f)


@pytest.mark.parametrize("tiled,wd", [(False, 0.0), (True, GIN_TRAIN_WD)],
                         ids=["default_wd", "tiled"])
def test_train_gin_baseline_matches_jax_params(tiled, wd, capsys):
    """The GIN baseline trainer, sparse, f32, from cal_tpu's initial
    weights, holding the final parameters and BatchNorm statistics too.
    ``default_wd``: weight decay 0, the canonical setting; losses within
    1e-4, equal train accuracies, and the parameters but those that
    ``_gin_noise_param`` names.  ``tiled``: cal_tpu's loaders build tile
    plans, so its GIN aggregates through coo_spmm (Pallas in interpret
    mode), the function that K11 ports; at GIN_TRAIN_WD every line but the
    loss digits and every parameter are held, the two that
    ``_gin_noise_param`` names channel by channel (``_wd_determined``).
    cal_tpu's run is made in a subprocess with one XLA CPU thread
    (``_single_thread_reference``): with XLA's multi-threaded reductions
    its rounding followed the core count.

    The lin1 bias's gradient is its weight-decay term wd * b plus a term
    that is 0 in theory (BatchNorm takes the batch mean out) and in float
    the rounding of the conv's product (MKL's code path, which differs
    between x86 machines) carried through BatchNorm's mean.  Adam divides
    each step by the gradient's own size, so where wd * b is not far above
    that rounding, the rounding sets the step.  A channel whose wd * b
    stayed 1000 times above its gradient's rounding at every step (measured
    on the port's run) follows wd * b: its lin1 bias and its BatchNorm
    running mean are held at the same tolerance as every parameter.  On the
    others (a bias that crosses 0) the port determines the step only up to
    that rounding: they are held within 2 max |rounding| / wd of cal_tpu's,
    the bias below which wd * b no longer exceeds the rounding of either
    run, and not left out."""
    kw = dict(model="GIN", epochs=3, batch_size=32, hidden=16, layers=1, lr=0.01, seed=3,
              layout="sparse", weight_decay=wd)
    ref = _single_thread_reference(_jax_gin_baseline_reference, tiled, wd, kw)
    epochs = ref["epochs"]
    assert ref["tiles"] == [tiled] * 3 and ref["traced"] == tiled
    train, val, test = _tiny_split("torch")
    built, grads = [], {}
    build = _from_init(ref["init"], "GIN")

    def get_model(*a):
        built.append(build(*a))
        grads.update(_bias_grads(built[-1]))
        return built[-1]

    capsys.readouterr()
    with mock.patch.object(steps_mod, "get_model", get_model):
        res = train_baseline_syn(train, val, test, Config(device="cpu", **kw))
    out = capsys.readouterr().out
    np.testing.assert_allclose([h["loss"] for h in res["history"]], [e[0] for e in epochs],
                               rtol=1e-4)
    assert [h["train_acc"] for h in res["history"]] == pytest.approx([e[1] for e in epochs],
                                                                     abs=1e-12)
    want = ref["want"]
    got = built[0].state_dict()
    held = [k for k in want if not _gin_noise_param(k)]
    assert set(got) == set(want) and len(held) == len(want) - 2
    for k in held:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    if wd > 0:
        for k in want:
            if _gin_noise_param(k):
                det, noise_tol = _wd_determined(grads[k.rsplit(".", 2)[0]], wd)
                diff = np.abs(got[k].numpy() - np.asarray(want[k]))
                tol = np.where(det, 1e-5 + 1e-3 * np.abs(np.asarray(want[k])), noise_tol)
                assert det.sum() >= len(det) // 4 and (diff <= tol).all(), (k, det, diff)
        for k in ("best_val_acc", "test_acc", "epoch"):
            assert res[k] == pytest.approx(ref["result"][k], abs=1e-12), k
        strip = lambda text: [ln.split("Loss:")[0] + ln.split("Train:")[-1]
                              for ln in text.splitlines() if ln.startswith(("BIAS:", "syd:"))]
        assert strip(out) == strip(ref["stdout"]) and len(strip(out)) == 4


def test_train_causal_syn_gin_sparse_matches_jax(tmp_path):
    """The causal trainer with CausalGIN on the sparse layout, f32, without
    the intervention shuffle, from cal_tpu's initial weights (weight decay:
    GIN_TRAIN_WD)."""
    kw = dict(model="CausalGIN", epochs=3, batch_size=32, hidden=16, layers=1, lr=0.01,
              with_random=False, seed=3, layout="sparse", weight_decay=GIN_TRAIN_WD)
    jtrain, jval, jtest = _tiny_split("jax")
    init, patch = _record_init(jax_causal_train_mod)
    with patch:
        ref = jax_train_causal_syn(jtrain, jval, jtest, JaxConfig(
            scan_epochs=False, metrics_path=str(tmp_path / "jax.jsonl"), **kw), verbose=False)
    ref_losses = [r["loss"] for r in map(json.loads, open(tmp_path / "jax.jsonl"))
                  if r["event"] == "epoch"]
    train, val, test = _tiny_split("torch")
    with mock.patch.object(steps_mod, "get_model", _from_init(init, "CausalGIN")):
        res = train_causal_syn(train, val, test, Config(device="cpu", **kw), verbose=False)
    np.testing.assert_allclose([h["loss"] for h in res["history"]], ref_losses, rtol=1e-4)
    for k in ("best_val_acc", "test_acc_co", "test_acc_c", "test_acc_o", "epoch"):
        assert res[k] == pytest.approx(ref[k], abs=1e-12), k


_ARGV = ["--device", "cpu", "--data_num", "20", "--node_num", "4", "--hidden", str(HIDDEN),
         "--layers", str(LAYERS), "--batch_size", "8", "--lr", "0.01", "--seed", "5"]


def test_main_syn_causal_gin_sparse_train_save_serve_resume(tmp_path, capsys):
    """main_syn --model CausalGIN --layout sparse: train and save; the
    checkpoint serves its saved accuracies on both layouts; --resume
    continues after it."""
    argv = ["--model", "CausalGIN", *_ARGV, "--save_dir", str(tmp_path)]
    trained = main(argv + ["--layout", "sparse", "--epochs", "3", "--save_model", "true"])
    assert all(np.isfinite(h["loss"]) for h in trained["history"])
    served = {lay: main(argv + ["--inference", "true", "--layout", lay])
              for lay in ("sparse", "dense")}
    assert served["sparse"]["graphs"] == served["dense"]["graphs"] > 8
    for k in ("test_acc_co", "test_acc_c", "test_acc_o"):
        assert served["sparse"][k] == served["dense"][k] == trained[k], k
    meta = Checkpointer(str(tmp_path)).restore(
        CausalGNN(10, HIDDEN, CLASSES, num_layers=LAYERS, backbone="gin"))
    capsys.readouterr()
    resumed = main(argv + ["--layout", "sparse", "--epochs", "5", "--save_model", "true",
                           "--resume", "true"])
    assert "resumed from checkpoint at epoch {}".format(meta["epoch"]) in capsys.readouterr().out
    assert [h["epoch"] for h in resumed["history"]] == list(range(meta["epoch"] + 1, 6))


@pytest.mark.parametrize("name,extra", [("GIN", ["--layout", "sparse"]),
                                        ("GCN", ["--layout", "sparse", "--pack_batches", "true"]),
                                        ("GAT", ["--inference", "true"])])
def test_main_syn_baselines_train(name, extra, tmp_path, capsys):
    """Baselines train through main_syn, never pack (--pack_batches is not
    theirs), and train even under --inference, as cal_tpu's entry point."""
    capsys.readouterr()
    res = main(["--model", name, *_ARGV, "--save_dir", str(tmp_path), "--epochs", "2", *extra])
    out = capsys.readouterr().out
    assert len(res["history"]) == 2 and all(np.isfinite(h["loss"]) for h in res["history"])
    assert "syd: BIAS:[0.50] | Best Val acc:" in out and "inference:" not in out


def test_causal_gin_unported_paths_raise(tmp_path):
    """--use_pallas false and multi-GPU training still raise for CausalGIN;
    budget-packed sparse batches, once refused here, train."""
    base = ["--model", "CausalGIN", *_ARGV, "--save_dir", str(tmp_path), "--epochs", "1"]
    packed = main(base + ["--layout", "sparse", "--pack_batches", "true"])
    assert all(np.isfinite(h["loss"]) for h in packed["history"])
    with pytest.raises(NotImplementedError, match="use_pallas"):
        main(base + ["--use_pallas", "false"])
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        main(base + ["--mesh_dp", "2"])
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        main(["--model", "GIN", *_ARGV, "--mesh_dp", "2"])
