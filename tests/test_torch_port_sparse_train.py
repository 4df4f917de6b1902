"""The port's sparse-layout training (CausalGCN) against the JAX package.

The backward twins of the pair aggregate (K2T, K5, K6), the plain aggregate
(K3T) and the pool (K7) against ``jax.vjp`` of cal_tpu's Pallas functions
(interpret mode on the CPU, small tile plans as in
tests/test_torch_port_sparse.py) and against torch.autograd of the port's
forward twins; one sparse train step against ``_causal_step_fn`` and
``make_optimizer`` on a tiled GraphBatch and against the port's own dense
step; the sparse trainer against cal_tpu's; ``main_syn --layout sparse``
train, save and serve on both layouts; the ablation flags through the sparse
step.  Small sizes (hidden 16, 2 layers, V <= 1024)."""
import copy
import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_sparse import (
    CLASSES,
    HIDDEN,
    LAYERS,
    NB,
    SPMM_TOL,
    _host_graphs,
    _jax_sparse_graph,
    _models,
    _plans,
    _sparse_budgets,
    _workload,
)
from test_torch_port_train import _flat

import cal_tpu_torch.ops.spmm as spmm_mod
import cal_tpu_torch.train.steps as steps_mod
from cal_tpu.data.loader import Loader as JaxLoader
from cal_tpu.data.synthetic import dataset_bias_split as jax_split
from cal_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from cal_tpu.ops.pallas_pool import mxu_pool
from cal_tpu.ops.pallas_spmm import (
    _pair_dpre_call,
    _pair_sddmm_chain_call,
    gcn_aggregate_sparse_plain_pallas,
    gcn_aggregate_sparse_sigmoid_pair_pallas,
)
from cal_tpu.train.causal import train_causal_syn as jax_train_causal_syn
from cal_tpu.train.losses import causal_losses as jax_causal_losses
from cal_tpu.train.optim import make_optimizer as jax_make_optimizer
from cal_tpu.train.steps import TrainState as JaxTrainState
from cal_tpu.train.steps import _causal_step_fn
from cal_tpu.utils.config import Config as JaxConfig
from cal_tpu_torch.data.loader import Loader
from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
from cal_tpu_torch.main_syn import main
from cal_tpu_torch.models.causal import CausalGNN
from cal_tpu_torch.ops.pool import segment_pool, segment_pool_plain
from cal_tpu_torch.train.causal import train_causal_syn
from cal_tpu_torch.train.optim import cosine_lr, make_optimizer
from cal_tpu_torch.train.steps import TrainState, make_causal_train_step
from cal_tpu_torch.utils.checkpoint import params_from_jax
from cal_tpu_torch.utils.config import Config

C_W, O_W, CO_W = 0.5, 1.0, 0.5
LR, MIN_LR, EPOCHS, WD = 1e-3, 1e-5, 2, 1e-3
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# A backward twin against torch.autograd of the forward twins: the same f32
# math, the VJP written out instead of derived (sums in another order).
AUTOGRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _plan_precision(dtype):
    return "bf16" if dtype == "bfloat16" else "f32"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_backward_twins_match_jax(dtype):
    """dxc, dxo (K2T) and dsrc, ddst (K5, the degree chain, K6) against
    jax.vjp of gcn_aggregate_sparse_sigmoid_pair_pallas.  bf16: cal_tpu's
    bf16 plans round the gathered planes and each slot term (SPMM_TOL)."""
    rng = np.random.default_rng(0)
    g, (xc, xo), (src, dst) = _workload(rng)
    gc, go = (rng.standard_normal(xc.shape).astype(np.float32) for _ in range(2))
    tf, tb = _plans(g, _plan_precision(dtype))
    j = lambda a: jnp.asarray(a, JDT[dtype])
    t = lambda a: torch.from_numpy(a).to(TDT[dtype])
    _, vjp = jax.vjp(lambda a, b, c, d: gcn_aggregate_sparse_sigmoid_pair_pallas(
        a, b, c, d, tf, tb, NB), j(xc), j(xo), j(src), j(dst))
    ref = vjp((j(gc), j(go)))
    leaves = [t(a).requires_grad_() for a in (xc, xo, src, dst)]
    oc, oo = spmm_mod.gcn_aggregate_sparse_pair(*leaves, g.to("cpu"))
    got = torch.autograd.grad((oc, oo), leaves, (t(gc), t(go)))
    for name, a, b in zip(("dxc", "dxo", "dsrc", "ddst"), got, ref):
        assert a.dtype == TDT[dtype] and torch.isfinite(a.float()).all(), name
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   err_msg=name, **SPMM_TOL[dtype])


@pytest.mark.parametrize("send_hub", [0, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_chain_twins_match_pallas_calls(dtype, send_hub):
    """K5's twin against ``_pair_sddmm_chain_call`` and K6's against
    ``_pair_dpre_call`` on their node outputs: ddis_s, ddis_r, then dsrc and
    ddst.  Each package's K6 takes its own K5's vec (cal_tpu's is in
    tile-slot order) and the same ddeg, formed from the twins' ddis sums as
    the aggregate's backward forms it.  The workload has a 90-edge hub
    receiver and a masked padded run at node V-1; ``send_hub`` gives node 11
    40 more out-edges, a sender of two chunks.  bf16: cal_tpu's plans round
    the gathered planes, x, g and each slot term (SPMM_TOL)."""
    rng = np.random.default_rng(4)
    g, (xc, xo), (src, dst) = _workload(rng, send_hub=send_hub)
    gc, go = (rng.standard_normal(xc.shape).astype(np.float32) for _ in range(2))
    gt = g.to("cpu")
    assert int((np.diff(gt.send.chunk_ptr.numpy()) > 1).sum()) == 1 + (send_hub > 0)
    v, h = xc.shape
    tf, _ = _plans(g, _plan_precision(dtype))
    t = lambda a: torch.from_numpy(a).to(TDT[dtype])
    deg = spmm_mod.pair_sender_degree_plain(t(src), t(dst), gt) + 1.0
    dis = torch.rsqrt(deg)
    vec, ddis_s, ddis_r = spmm_mod.pair_sddmm_chain(t(xc), t(xo), t(gc), t(go), t(src), t(dst),
                                                    dis, gt)
    j = lambda a: jnp.asarray(np.asarray(t(a).float()), JDT[dtype])
    vecs, ref_s, ref_r = _pair_sddmm_chain_call(
        jnp.concatenate([j(xc), j(xo)], 1), jnp.concatenate([j(gc), j(go)], 1), j(src), j(dst),
        jnp.asarray(dis.numpy()), tf, NB, h)
    inv = 1.0 / deg
    gx = torch.stack([(t(gc).float() * t(xc).float()).sum(1),
                      (t(go).float() * t(xo).float()).sum(1)])
    ddeg = -gx * inv * inv + (ddis_s + ddis_r) * (-0.5) * dis * inv
    dsrc, ddst = spmm_mod.pair_dpre(vec, ddeg, gt)
    ref_src, ref_dst = _pair_dpre_call(vecs, jnp.asarray(ddeg.numpy()), tf, v, NB)
    for name, a, b in (("ddis_s", ddis_s, ref_s), ("ddis_r", ddis_r, ref_r),
                       ("dsrc", dsrc, ref_src[0]), ("ddst", ddst, ref_dst[0])):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), err_msg=name,
                                   **SPMM_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_twin_matches_jax(dtype):
    rng = np.random.default_rng(1)
    g, (x, _), _ = _workload(rng)
    gout = rng.standard_normal(x.shape).astype(np.float32)
    tf, tb = _plans(g, _plan_precision(dtype))
    _, vjp = jax.vjp(lambda a: gcn_aggregate_sparse_plain_pallas(a, tf, tb, node_block=NB),
                     jnp.asarray(x, JDT[dtype]))
    (ref,) = vjp(jnp.asarray(gout, JDT[dtype]))
    leaf = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    out = spmm_mod.gcn_aggregate_sparse_plain(leaf, g.to("cpu"))
    (got,) = torch.autograd.grad(out, leaf, torch.from_numpy(gout).to(TDT[dtype]))
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **SPMM_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_backward_twin_matches_mxu_pool(dtype):
    """dx[v] = dpooled[node_graph[v]]: both packages round the same f32 row
    once to x's dtype, so the gradients are equal."""
    rng = np.random.default_rng(2)
    v, h, g = 1024, 128, 9
    ng = np.repeat(np.arange(g), rng.integers(0, 150, g))[:v - 5]
    ng = np.concatenate([ng, np.full(v - ng.size, g)]).astype(np.int32)
    x = rng.standard_normal((v, h)).astype(np.float32)
    dp = rng.standard_normal((g + 1, h)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: mxu_pool(a, jnp.asarray(ng), g + 1), jnp.asarray(x, JDT[dtype]))
    (ref,) = vjp(jnp.asarray(dp))
    leaf = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    (got,) = torch.autograd.grad(segment_pool(leaf, torch.from_numpy(ng), g + 1), leaf,
                                 torch.from_numpy(dp))
    assert got.dtype == TDT[dtype]
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def _autograd_case(which, g, rng):
    """(the Function's output, the forward twins' output, leaves of each)."""
    v = g.num_nodes
    arr = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    if which == "pool":
        ng = torch.from_numpy(np.minimum(np.arange(v) // 40, 6).astype(np.int32))
        x = arr(v, 16)
        a, b = (torch.from_numpy(x).requires_grad_() for _ in range(2))
        return segment_pool(a, ng, 7), segment_pool_plain(b, ng, 7), [a], [b]
    xs = [arr(v, 16), arr(v, 16), arr(v), 2 * arr(v)]
    a = [torch.from_numpy(u).requires_grad_() for u in xs]
    b = [torch.from_numpy(u).requires_grad_() for u in xs]
    if which == "plain":
        deg = 2.0 * spmm_mod.pair_sender_degree_plain(None, None, g)[:1] + 1.0
        ref = spmm_mod.coef_spmm_plain(b[:1], None, None, deg, torch.rsqrt(deg), g)[0]
        return spmm_mod.gcn_aggregate_sparse_plain(a[0], g), ref, a[:1], b[:1]
    deg = spmm_mod.pair_sender_degree_plain(b[2], b[3], g) + 1.0
    ref = torch.cat(spmm_mod.coef_spmm_plain(b[:2], b[2], b[3], deg, torch.rsqrt(deg), g), 1)
    return torch.cat(spmm_mod.gcn_aggregate_sparse_pair(*a, g), 1), ref, a, b


@pytest.mark.parametrize("which", ["pair", "plain", "pool"])
def test_backward_twins_match_autograd(which):
    """Each backward twin (the VJP written out) against torch.autograd of
    its forward twin (index_add_ and gathers), f32."""
    rng = np.random.default_rng(3)
    g, _, _ = _workload(rng)
    got_out, ref_out, got_leaves, ref_leaves = _autograd_case(which, g.to("cpu"), rng)
    torch.testing.assert_close(got_out, ref_out, rtol=0, atol=0)
    cot = torch.from_numpy(rng.standard_normal(tuple(got_out.shape)).astype(np.float32))
    got = torch.autograd.grad(got_out, got_leaves, cot)
    ref = torch.autograd.grad(ref_out, ref_leaves, cot)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, **AUTOGRAD_TOL)


def _sparse_setup(dtype, **flags):
    """cal_tpu and port models with the same (perturbed) weights, one sparse
    batch of seven graphs and a padded slot in both packages' form, and each
    package's optimizer and train step."""
    jg, tg = _host_graphs(seed=2, count=7, hub=50)
    budgets = _sparse_budgets(tg, 8)
    jb = next(JaxLoader(jg, 8, layout="sparse", budgets=budgets, prefetch=0).host_batches())
    tb = next(Loader(tg, 8, budgets=budgets, layout="sparse").host_batches())
    g_j = _jax_sparse_graph(jb, _plan_precision(dtype))
    jm, variables, tm = _models(dtype, g_j, 6, **flags)
    tx = jax_make_optimizer(LR, MIN_LR, EPOCHS, 3, WD)
    jstate = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32))
    state = TrainState(tm, make_optimizer(tm.parameters(), WD))
    step = make_causal_train_step(state, cosine_lr(LR, MIN_LR, EPOCHS, 3), C_W, O_W, CO_W,
                                  False, seed=0)
    return g_j, tb, jm, tx, jstate, state, step


def _jax_grads(jm, jstate, g):
    key = jax.random.PRNGKey(0)

    def loss_fn(params):
        (c, o, co), _ = jm.apply({"params": params, "batch_stats": jstate.batch_stats}, g,
                                 eval_random=False, train=True,
                                 rngs={"intervention": key, "dropout": key},
                                 mutable=["batch_stats"])
        return jax_causal_losses(c, o, co, g.y, g.graph_mask, C_W, O_W, CO_W)[0]

    return _flat(jax.jit(jax.grad(loss_fn))(jstate.params))


_METRICS = ("loss", "loss_c", "loss_o", "loss_co", "correct_o", "n")


def test_sparse_train_step_matches_jax_f32():
    """Gradients name by name, the step's loss sums, and parameters and
    BatchNorm running stats after one Adam step, against _causal_step_fn on
    f32 tile plans (the Pallas pair, plain and pool VJPs)."""
    g_j, tb, jm, tx, jstate, state, step = _sparse_setup("float32")
    ref_grads = _jax_grads(jm, jstate, g_j)
    jstate, jm_out = jax.jit(_causal_step_fn(jm, tx, C_W, O_W, CO_W, False))(
        jstate, g_j, jax.random.PRNGKey(0))
    ours = step(tb, None)
    assert not ref_grads["conv_feat.bias"].any()
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(ours.numpy(), [float(jm_out[k]) for k in _METRICS], rtol=1e-5)
    assert state.step == int(jstate.step) == 1
    # Adam's first update is ~lr * sign(g): an entry whose gradient sits at
    # the rounding-noise floor may move 2 lr apart (test_torch_port_train.py)
    ref_p, ref_s = _flat(jstate.params), _flat(jstate.batch_stats)
    diffs = []
    for name, p in state.model.named_parameters():
        d = np.abs(p.detach().numpy() - ref_p[name])
        assert d.max() <= 2 * LR, name
        diffs.append(d.ravel())
    assert np.mean(np.concatenate(diffs) <= 1e-5) >= 0.999
    for name, b in state.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref_s[name], rtol=1e-4, atol=1e-4, err_msg=name)


def test_sparse_train_step_matches_jax_bf16():
    """One bf16 step on bf16 plans: the loss sums within 5e-2, as the dense
    bf16 step test (bf16 rounds at other points in the two packages)."""
    g_j, tb, jm, tx, jstate, state, step = _sparse_setup("bfloat16")
    _, jm_out = jax.jit(_causal_step_fn(jm, tx, C_W, O_W, CO_W, False))(
        jstate, g_j, jax.random.PRNGKey(0))
    ours = step(tb, None)
    assert torch.isfinite(ours).all()
    assert all(torch.isfinite(p.grad).all() for p in state.model.parameters())
    np.testing.assert_allclose(ours[:4].numpy(), [float(jm_out[k]) for k in _METRICS[:4]],
                               rtol=5e-2, atol=5e-2)


def _sparse_and_dense_steps(flags):
    """One f32 train step of the same model on the same graphs, sparse and
    dense layout; returns both models (gradients in ``.grad``) and sums."""
    _, tg = _host_graphs(seed=4, count=10, hub=40)
    sb = next(Loader(tg, 8, layout="sparse").host_batches())
    db = next(Loader(tg, 8).host_batches())
    base = CausalGNN(num_features=6, hidden=HIDDEN, num_classes=CLASSES, num_layers=LAYERS,
                     seed=3, **flags)
    out = []
    for batch in (sb, db):
        model = copy.deepcopy(base)
        state = TrainState(model, make_optimizer(model.parameters(), WD))
        step = make_causal_train_step(state, lambda s: LR, C_W, O_W, CO_W, True, seed=1)
        out.append((model, step(batch, None)))
    return out


def _assert_same_step(sparse, dense):
    (ms, sums_s), (md, sums_d) = sparse, dense
    torch.testing.assert_close(sums_s, sums_d, rtol=1e-5, atol=1e-5)
    for (name, a), b in zip(ms.named_parameters(), md.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5, msg=name)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


def test_sparse_step_equals_dense_step():
    """The port's own layouts agree: one f32 step (intervention shuffle on,
    the same (seed, step) stream) gives the same sums, gradients and
    updated parameters on the sparse and the dense layout."""
    _assert_same_step(*_sparse_and_dense_steps({}))


@pytest.mark.parametrize("flags", [{"without_edge_attention": True},
                                   {"without_node_attention": True},
                                   {"without_edge_attention": True,
                                    "without_node_attention": True}],
                         ids=["no_edge_att", "no_node_att", "both"])
def test_sparse_step_ablation_flags(flags):
    """The ablation flags through the sparse step: equal to the dense step;
    constant edge weights (no logit gradient) skip the chain kernels."""
    calls = []
    real = spmm_mod.pair_sddmm_chain

    def spy(*a):
        calls.append(1)
        return real(*a)

    with mock.patch.object(spmm_mod, "pair_sddmm_chain", spy):
        sparse, dense = _sparse_and_dense_steps(flags)
    assert len(calls) == (0 if flags.get("without_edge_attention") else 1)
    _assert_same_step(sparse, dense)


def test_sparse_step_skips_a_batch_without_real_graphs():
    _, tg = _host_graphs(seed=4, count=3)
    batch = next(Loader(tg, 4, layout="sparse").host_batches())
    model = CausalGNN(num_features=6, hidden=HIDDEN, num_classes=CLASSES, num_layers=LAYERS)
    state = TrainState(model, make_optimizer(model.parameters(), WD))
    step = make_causal_train_step(state, lambda s: LR, C_W, O_W, CO_W, True, seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    empty = dataclasses.replace(batch, graph_mask=np.zeros_like(batch.graph_mask))
    sums = torch.arange(6.0)
    assert step(empty, sums) is sums and state.step == 0
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert step(batch, None) is not None and state.step == 1


def _tiny_split(pkg):
    gen, split = (jax_generate, jax_split) if pkg == "jax" else (
        generate_synthetic_dataset, dataset_bias_split)
    ds = gen(data_num=30, node_num=4, max_degree=6, seed=5)
    return split(ds, bias=0.7, total=120, seed=0)[:3]


def test_train_causal_syn_sparse_matches_jax(tmp_path, capsys):
    """The sparse trainer on the CPU, f32, without the intervention shuffle,
    from cal_tpu's initial weights: per-epoch losses within 1e-4 and the
    same selected accuracies and epoch (cal_tpu's trainer batches these
    small splits without tile plans: its XLA sparse path)."""
    kw = dict(model="CausalGCN", epochs=3, batch_size=32, hidden=16, layers=1, lr=0.01,
              with_random=False, seed=3, layout="sparse")
    jtrain, jval, jtest = _tiny_split("jax")
    init = {}
    import cal_tpu.train.causal as jax_train_mod

    real_init = jax_train_mod.init_state

    def record(*a, **k):
        st = real_init(*a, **k)
        init.update(params=jax.tree.map(np.asarray, st.params),
                    stats=jax.tree.map(np.asarray, st.batch_stats))
        return st

    with mock.patch.object(jax_train_mod, "init_state", record):
        ref = jax_train_causal_syn(jtrain, jval, jtest, JaxConfig(
            scan_epochs=False, metrics_path=str(tmp_path / "jax.jsonl"), **kw), verbose=False)
    ref_losses = [r["loss"] for r in map(json.loads, open(tmp_path / "jax.jsonl"))
                  if r["event"] == "epoch"]

    def jax_weights(cfg, num_features, num_classes):
        m = CausalGNN(num_features, cfg.hidden, num_classes, num_layers=cfg.layers,
                      with_random=cfg.with_random)
        m.load_state_dict(params_from_jax(init["params"], init["stats"]))
        return m

    train, val, test = _tiny_split("torch")
    capsys.readouterr()
    with mock.patch.object(steps_mod, "get_model", jax_weights):
        res = train_causal_syn(train, val, test, Config(device="cpu", **kw), verbose=False)
    assert "pack_batches auto:" in capsys.readouterr().out      # "auto" keeps fixed budgets
    np.testing.assert_allclose([h["loss"] for h in res["history"]], ref_losses, rtol=1e-4)
    for k in ("best_val_acc", "test_acc_co", "test_acc_c", "test_acc_o", "epoch"):
        assert res[k] == pytest.approx(ref[k], abs=1e-12), k


def test_main_syn_sparse_train_save_serve_both_layouts(tmp_path):
    """main_syn --layout sparse trains and saves; --inference of that
    checkpoint gives the saved accuracies on both layouts."""
    argv = ["--model", "CausalGCN", "--device", "cpu", "--data_num", "20", "--node_num", "4",
            "--hidden", str(HIDDEN), "--layers", str(LAYERS), "--batch_size", "8",
            "--seed", "5", "--save_dir", str(tmp_path)]
    trained = main(argv + ["--layout", "sparse", "--epochs", "2", "--save_model", "true"])
    assert all(np.isfinite(h["loss"]) for h in trained["history"])
    served = {lay: main(argv + ["--inference", "true", "--layout", lay])
              for lay in ("sparse", "dense")}
    assert served["sparse"]["graphs"] == served["dense"]["graphs"] > 8
    for k in ("test_acc_co", "test_acc_c", "test_acc_o"):
        assert served["sparse"][k] == served["dense"][k] == trained[k], k
