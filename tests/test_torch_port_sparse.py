"""The port's sparse layout (CausalGCN serving) against the JAX package.

Host batches against ``cal_tpu.data.loader.Loader(layout="sparse")``; the
plain twins of the sender-degree, pair SpMM, plain SpMM and pool kernels
against cal_tpu's Pallas kernels (interpret mode on the CPU, small tile
plans as in tests/test_pallas_spmm.py) and the XLA reference; the sparse
CausalGCN eval forward against ``CausalGNN(backbone="gcn")`` on a tiled
GraphBatch; and ``main_syn --layout sparse --inference`` against the dense
path.  Small sizes (hidden 16, 2 layers, V <= 1024)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cal_tpu.data.loader import Loader as JaxLoader
from cal_tpu.graph import HostGraph as JaxHostGraph
from cal_tpu.models.causal import CausalGNN as JaxCausalGNN
from cal_tpu.ops.gcn import gcn_aggregate_sparse as jax_gcn_sparse
from cal_tpu.ops.pallas_pool import mxu_pool
from cal_tpu.ops.pallas_spmm import (
    _pair_stats_call,
    build_tiles,
    gcn_aggregate_sparse_plain_pallas,
    gcn_aggregate_sparse_sigmoid_pair_pallas,
)
from cal_tpu_torch.data.loader import Loader, compute_budgets, want_pack
from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
from cal_tpu_torch.graph import (
    CHUNK_EDGES, MAX_CHUNKS, HostGraph, batch_graphs, sparse_batch)
from cal_tpu_torch.main_syn import main
from cal_tpu_torch.models.causal import CausalGNN
from cal_tpu_torch.ops.gcn import gcn_aggregate_sparse
from cal_tpu_torch.ops.pool import segment_pool
import cal_tpu_torch.ops.spmm as spmm_mod
from cal_tpu_torch.ops.spmm import (
    gcn_aggregate_sparse_pair,
    gcn_aggregate_sparse_plain,
    pair_sender_degree,
    plain_sender_degree,
)
from cal_tpu_torch.utils.checkpoint import params_from_jax

NB, T = 64, 32                 # small tile plans for interpret mode
HIDDEN, LAYERS, CLASSES = 16, 2, 4
# Port twins against cal_tpu's kernels.  f32: the same f32 math with sums in
# another order (tile slots vs CSR rows) and XLA's vs PyTorch's rsqrt.  bf16
# plans: cal_tpu rounds the gathered logit and dis planes, the per-slot
# weights and every message to bf16 (pallas_spmm.py:1206-1218, :1265-1281),
# the port only x and the output: each rounding moves a term by up to 2^-9
# relative, four of them compound on each message, the sums cancel, and the
# outputs (|out| up to ~4 here) are bf16 themselves (2^-8).
SPMM_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# sparse CausalGCN log-probs against cal_tpu (as tests/test_torch_port_model.py)
FWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _host_graphs(seed=0, count=11, feat=6, hub=None):
    """Random multigraphs with self loops and an isolated node; ``hub``
    gives graph 0 a node with that many in- and out-edges."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = int(rng.integers(4, 30))
        e = int(rng.integers(n, 3 * n))
        s = rng.integers(0, n - 1, e)            # node n-1 stays isolated
        r = rng.integers(0, n - 1, e)
        if i == 0 and hub:
            s = np.concatenate([s, rng.integers(1, n - 1, hub)])
            r = np.concatenate([r, np.zeros(hub, np.int64)])
        s, r = np.concatenate([s, r]).astype(np.int32), np.concatenate([r, s]).astype(np.int32)
        x = rng.standard_normal((n, feat)).astype(np.float32)
        out.append((x, s, r, int(rng.integers(CLASSES))))
    return ([JaxHostGraph(x=x, senders=s, receivers=r, y=y) for x, s, r, y in out],
            [HostGraph(x=x, senders=s, receivers=r, y=y) for x, s, r, y in out])


def _presorted(graphs):
    """The graphs with their edges sorted by (receiver, sender), as the
    packers of both packages lay them out."""
    out = []
    for g in graphs:
        o = np.lexsort((g.senders, g.receivers))
        out.append(HostGraph(x=g.x, senders=g.senders[o], receivers=g.receivers[o], y=g.y))
    return out


@pytest.mark.parametrize("bs,shuffle", [(4, True), (5, False)])
def test_sparse_host_batches_match_jax(bs, shuffle):
    jg, tg = _host_graphs(hub=70)
    budgets = compute_budgets(tg, bs, "sparse")
    jl = JaxLoader(jg, bs, shuffle=shuffle, seed=3, layout="sparse", prefetch=0)
    assert jl.budgets == budgets
    tl = Loader(tg, bs, shuffle=shuffle, seed=3, layout="sparse")
    order = (np.random.default_rng(3).permutation(len(tg)) if shuffle
             else np.arange(len(tg)))
    sorted_graphs = _presorted(tg)
    n = 0
    for i, (jb, tb) in enumerate(zip(jl.host_batches(), tl.host_batches(), strict=True)):
        for f in ("x", "senders", "receivers", "edge_mask", "node_mask", "node_graph", "y",
                  "graph_mask"):
            np.testing.assert_array_equal(getattr(tb, f), np.asarray(getattr(jb, f)), f)
        ref = batch_graphs([sorted_graphs[j] for j in order[i * bs:(i + 1) * bs]], bs,
                           budgets["node_budget"], budgets["edge_budget"])
        v = tb.num_nodes
        for csr_t, csr_r in ((tb.recv, ref.recv), (tb.send, ref.send)):
            for f in ("ptr", "chunk_ptr", "chunk_row", "heavy_chunks", "heavy_masked",
                      "heavy_count", "arrivals", "perm"):
                a, b = getattr(csr_t, f), getattr(csr_r, f)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tb.send.perm, np.argsort(tb.senders, kind="stable"))
        np.testing.assert_array_equal(tb.recv.ptr, np.searchsorted(tb.receivers, np.arange(v + 1)))
        groups = np.maximum(1, -(-np.diff(tb.recv.ptr) // CHUNK_EDGES))
        chunks = np.diff(tb.recv.chunk_ptr)
        assert (chunks >= 1).all() and (chunks <= MAX_CHUNKS).all()
        per = -(-groups // chunks)             # groups per chunk: all chunks but the last full
        assert ((chunks - 1) * per < groups).all() and (chunks * per >= groups).all()
        assert chunks.max() > 1                # the hub and the padded run
        n += 1
    assert n == len(tl) and len(tg) % bs     # the last batch is partial


def _workload(rng, v=256, e=700, h=16, pad_frac=0.15, hub=90, send_hub=0):
    """Receiver-sorted random edges with self loops, a hub receiver and a
    masked padded tail at node V-1, as tests/test_pallas_spmm.py builds;
    ``send_hub`` more out-edges of node 11 make it a hub sender."""
    senders = rng.integers(0, v, e)
    receivers = rng.integers(0, v - 1, e)
    receivers[:hub] = 7                                  # hub row: several chunks
    senders[hub:hub + send_hub] = 11                     # hub sender: several chunks
    idx = rng.choice(e, e // 20, replace=False)
    senders[idx] = receivers[idx]                        # self loops, dropped
    n_real = int(e * (1 - pad_frac))
    order = np.argsort(receivers[:n_real], kind="stable")
    senders = np.concatenate([senders[:n_real][order], np.full(e - n_real, v - 1)])
    receivers = np.concatenate([receivers[:n_real][order], np.full(e - n_real, v - 1)])
    edge_mask = np.arange(e) < n_real
    g = sparse_batch(np.zeros((v, 1), np.float32), senders, receivers, edge_mask,
                     np.ones(v, bool), np.zeros(v, np.int32), np.zeros(1, np.int32),
                     np.ones(1, bool))
    xs = [rng.standard_normal((v, h)).astype(np.float32) for _ in range(2)]
    logits = [rng.standard_normal(v).astype(np.float32) * s for s in (1.0, 2.0)]
    return g, xs, logits


def _plans(g, precision):
    v = g.num_nodes
    kw = dict(node_block=NB, tile_edges=T, edge_mask=g.edge_mask, precision=precision)
    return (build_tiles(g.senders, g.receivers, v, **kw),
            build_tiles(g.receivers, g.senders, v, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_twins_match_jax(dtype):
    """K1 twin against _pair_stats_call, the plain (K1 + K3) and pair (K1 +
    K2) aggregates against gcn_aggregate_sparse_{plain,sigmoid_pair}_pallas
    on f32 / bf16 tile plans, and all three against the XLA reference."""
    rng = np.random.default_rng(0)
    g, (xc, xo), (src, dst) = _workload(rng)
    assert g.recv.num_chunks > g.num_nodes + 1     # the hub and the padded run
    tf, tb = _plans(g, "bf16" if dtype == "bfloat16" else "f32")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    gt = g.to("cpu")
    j = lambda a: jnp.asarray(a, jdt)
    t = lambda a: torch.from_numpy(a).to(tdt)
    tol = SPMM_TOL[dtype]

    degs = pair_sender_degree(t(src), t(dst), gt)
    ref = _pair_stats_call(j(src), j(dst), tf, g.num_nodes, NB)
    np.testing.assert_allclose(degs.numpy(), np.asarray(ref),
                               **(tol if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-4)))

    got = gcn_aggregate_sparse_plain(t(xc), gt)
    assert got.dtype == tdt
    ref = gcn_aggregate_sparse_plain_pallas(j(xc), tf, tb, node_block=NB)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **tol)

    oc, oo = gcn_aggregate_sparse_pair(t(xc), t(xo), t(src), t(dst), gt)
    rc, ro = gcn_aggregate_sparse_sigmoid_pair_pallas(j(xc), j(xo), j(src), j(dst), tf, tb, NB)
    np.testing.assert_allclose(oc.float().numpy(), np.asarray(rc, np.float32), **tol)
    np.testing.assert_allclose(oo.float().numpy(), np.asarray(ro, np.float32), **tol)

    if dtype == "float32":
        s, r, em = (jnp.asarray(a) for a in (g.senders, g.receivers, g.edge_mask))
        w = jax.nn.sigmoid(j(src)[s] + j(dst)[r])
        for x, weight, ours in ((xc, None, got), (xc, w, oc), (xo, 1.0 - w, oo)):
            xla = jax_gcn_sparse(j(x), s, r, em, weight)
            np.testing.assert_allclose(ours.numpy(), np.asarray(xla), **tol)
            tw = None if weight is None else torch.from_numpy(np.array(weight))
            plain_ref = gcn_aggregate_sparse(t(x), gt.senders, gt.receivers, gt.edge_mask, tw)
            np.testing.assert_allclose(plain_ref.numpy(), np.asarray(xla), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sender_degree_norm_matches_pair_stats(dtype):
    """K1's twin with its epilogue (deg = 1 + the sums, dis = deg^-1/2, as
    the pair aggregate takes them from the kernel) against cal_tpu's
    _pair_stats_call + 1 and jax.lax.rsqrt (``_pair_fwd``), and the plain
    conv's degree (``plain_sender_degree``: a count of live edges) against
    ``_plain_fwd``'s 2 x _pair_stats_call at zero logits + 1 bit for bit
    (counts are exact in any order, on f32 and bf16 plans alike), with a
    hub sender; the epilogue equals the sums + 1 and torch.rsqrt bit for
    bit."""
    rng = np.random.default_rng(5)
    g, _, (src, dst) = _workload(rng, send_hub=120)
    assert g.send.n_heavy > g.recv.n_heavy   # the hub sender
    bf16 = dtype == "bfloat16"
    tf, _ = _plans(g, "bf16" if bf16 else "f32")
    v = g.num_nodes
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    gt = g.to("cpu")
    src_t, dst_t = (torch.from_numpy(a).to(tdt) for a in (src, dst))
    deg, dis = pair_sender_degree(src_t, dst_t, gt, norm=True)
    assert deg.shape == dis.shape == (2, v) and deg.dtype == dis.dtype == torch.float32
    ref = _pair_stats_call(jnp.asarray(src, jdt), jnp.asarray(dst, jdt), tf, v, NB) + 1.0
    tol = SPMM_TOL[dtype] if bf16 else dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(deg.numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(dis.numpy(), np.asarray(jax.lax.rsqrt(ref)), **tol)
    sums = pair_sender_degree(src_t, dst_t, gt)
    torch.testing.assert_close(deg, sums + 1.0, rtol=0, atol=0)
    torch.testing.assert_close(dis, torch.rsqrt(sums + 1.0), rtol=0, atol=0)

    pdeg, pdis = plain_sender_degree(gt)
    assert pdeg.shape == pdis.shape == (1, v)
    zeros = jnp.zeros(v, jnp.float32)
    pref = 2.0 * _pair_stats_call(zeros, zeros, tf, v, NB)[0] + 1.0
    np.testing.assert_array_equal(pdeg.numpy()[0], np.asarray(pref))
    np.testing.assert_allclose(pdis.numpy()[0], np.asarray(jax.lax.rsqrt(pref)), rtol=1e-6)
    torch.testing.assert_close(pdeg, 2.0 * pair_sender_degree(None, None, gt)[:1] + 1.0,
                               rtol=0, atol=0)


def test_spmm_twins_empty_graph_and_padding_only():
    """A batch whose edges are all padding: the aggregate is the self term."""
    v, h = 96, 32
    g = sparse_batch(np.zeros((v, 1), np.float32), np.full(40, v - 1), np.full(40, v - 1),
                     np.zeros(40, bool), np.arange(v) < 10, np.zeros(v, np.int32),
                     np.zeros(1, np.int32), np.ones(1, bool)).to("cpu")
    x = torch.randn(v, h)
    torch.testing.assert_close(gcn_aggregate_sparse_plain(x, g), x)
    oc, oo = gcn_aggregate_sparse_pair(x, 2 * x, torch.randn(v), torch.randn(v), g)
    torch.testing.assert_close(oc, x)
    torch.testing.assert_close(oo, 2 * x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_twin_matches_mxu_pool(dtype):
    rng = np.random.default_rng(1)
    v, h, g = 1024, 128, 9
    sizes = rng.integers(0, 150, g)                  # an empty graph or two
    ng = np.repeat(np.arange(g), sizes)[:v - 5]
    ng = np.concatenate([ng, np.full(v - ng.size, g)]).astype(np.int32)   # trash segment
    x = rng.standard_normal((v, h)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = mxu_pool(jnp.asarray(x, jdt), jnp.asarray(ng), g + 1)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = segment_pool(tx, torch.from_numpy(ng), g + 1)
    assert got.dtype == torch.float32 and got.shape == (g + 1, h)
    # both sum the same (bf16-exact) values in f32, in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_twin_matches_mxu_pool_wide_segment(dtype):
    """One graph of ~3,000 rows (a REDDIT-sized segment, many of K4's runs)
    between two small ones, the trash segment after them, V = 4,096."""
    rng = np.random.default_rng(2)
    v, h = 4096, 128
    sizes = np.array([37, 3001, 5])
    ng = np.concatenate([np.repeat(np.arange(3), sizes),
                         np.full(v - sizes.sum(), 3)]).astype(np.int32)
    x = rng.standard_normal((v, h)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = mxu_pool(jnp.asarray(x, jdt), jnp.asarray(ng), 4)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = segment_pool(tx, torch.from_numpy(ng), 4)
    assert got.dtype == torch.float32 and got.shape == (4, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def _jax_sparse_graph(jb, precision, dtype=None):
    """A cal_tpu GraphBatch on the device with small tile plans."""
    v = jb.x.shape[0]
    kw = dict(node_block=NB, tile_edges=T, edge_mask=np.asarray(jb.edge_mask),
              precision=precision)
    s, r = np.asarray(jb.senders), np.asarray(jb.receivers)
    tiles = (build_tiles(s, r, v, **kw), build_tiles(r, s, v, **kw))
    return dataclasses.replace(jax.tree.map(jnp.asarray, jb), tiles=tiles)


def _randomize(tree, rng):
    return jax.tree.map(lambda a: (np.asarray(a, np.float32)
                                   + rng.normal(0, 0.3, np.shape(a))).astype(np.float32), tree)


def _bn_stats(tree, rng):
    if "mean" in tree:
        return {"mean": rng.normal(0, 0.5, tree["mean"].shape).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, tree["var"].shape).astype(np.float32)}
    return {k: _bn_stats(v, rng) for k, v in tree.items()}


def _models(dtype, g_j, num_features, layers=LAYERS, **kw):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jm = JaxCausalGNN(backbone="gcn", hidden=HIDDEN, num_classes=CLASSES, num_layers=layers,
                      dtype=jdt, **kw)
    key = jax.random.PRNGKey(0)
    variables = jm.init({"params": key, "intervention": key}, g_j, eval_random=False)
    rng = np.random.default_rng(0)
    variables = {"params": _randomize(variables["params"], rng),
                 "batch_stats": _bn_stats(variables["batch_stats"], rng)}
    tm = CausalGNN(num_features=num_features, hidden=HIDDEN, num_classes=CLASSES,
                   num_layers=layers, dtype=torch.bfloat16 if dtype == "bfloat16"
                   else torch.float32, **kw)
    tm.load_state_dict(params_from_jax(variables["params"], variables["batch_stats"]))
    return jm, variables, tm.eval()


def _sparse_budgets(graphs, bs):
    b = compute_budgets(graphs, bs, "sparse")
    return {**b, "node_budget": -(-b["node_budget"] // NB) * NB}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flags", [{}, {"without_edge_attention": True,
                                        "without_node_attention": True}],
                         ids=["default", "ablations"])
def test_sparse_eval_forward_matches_jax(dtype, flags):
    jg, tg = _host_graphs(seed=2, count=7, hub=50)
    bs = 8
    budgets = _sparse_budgets(tg, bs)
    jb = next(JaxLoader(jg, bs, layout="sparse", budgets=budgets, prefetch=0).host_batches())
    tb = next(Loader(tg, bs, budgets=budgets, layout="sparse").host_batches())
    g_j = _jax_sparse_graph(jb, "bf16" if dtype == "bfloat16" else "f32")
    jm, variables, tm = _models(dtype, g_j, 6, **flags)
    ref = jm.apply(variables, g_j, eval_random=False, train=False)
    with torch.no_grad():
        ours = tm(tb.to("cpu"), eval_random=False, train=False)
    real = tb.graph_mask
    assert not real.all()                            # a padded graph slot
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy()[real], np.asarray(b)[real], **FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_forward_plain_degree_once_a_batch(dtype, monkeypatch):
    """A sparse CausalGCN forward of 3 layers runs its 3 plain convs on one
    degree: ``plain_sender_degree`` runs once a batch (kept in the batch's
    ``derived``), not again for a second forward of the batch, and once more
    for a new batch; the log-probs hold against cal_tpu as before."""
    jg, tg = _host_graphs(seed=2, count=7, hub=50)
    bs = 8
    budgets = _sparse_budgets(tg, bs)
    jb = next(JaxLoader(jg, bs, layout="sparse", budgets=budgets, prefetch=0).host_batches())
    tb = next(Loader(tg, bs, budgets=budgets, layout="sparse").host_batches())
    g_j = _jax_sparse_graph(jb, "bf16" if dtype == "bfloat16" else "f32")
    jm, variables, tm = _models(dtype, g_j, 6, layers=3)
    ref = jm.apply(variables, g_j, eval_random=False, train=False)
    degrees, convs = [], []
    real_degree, real_conv = spmm_mod.plain_sender_degree, spmm_mod.plain_coef_spmm
    monkeypatch.setattr(spmm_mod, "plain_sender_degree",
                        lambda g: degrees.append(g) or real_degree(g))
    monkeypatch.setattr(spmm_mod, "plain_coef_spmm", lambda *a: convs.append(1) or real_conv(*a))
    g = tb.to("cpu")
    with torch.no_grad():
        ours = tm(g, eval_random=False, train=False)
        again = tm(g, eval_random=False, train=False)
        assert len(convs) == 6 and len(degrees) == 1 and degrees[0] is g
        assert set(g.derived) == {"plain_norm"}
        tm(tb.to("cpu"), eval_random=False, train=False)
    assert len(convs) == 9 and len(degrees) == 2
    real = tb.graph_mask
    for a, b, c in zip(ours, again, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_allclose(a.numpy()[real], np.asarray(c)[real], **FWD_TOL[dtype])


def test_sparse_forward_equals_dense_forward():
    _, tg = _host_graphs(seed=4, count=10, hub=40)
    bs = 4
    tm = CausalGNN(num_features=6, hidden=HIDDEN, num_classes=CLASSES, num_layers=LAYERS,
                   seed=3).eval()
    sparse = list(Loader(tg, bs, layout="sparse").host_batches())
    dense = list(Loader(tg, bs).host_batches())
    from cal_tpu_torch.graph import to_dense

    with torch.no_grad():
        for sb, db in zip(sparse, dense, strict=True):
            a = tm(sb.to("cpu"), eval_random=False)
            b = tm(to_dense(db.to("cpu")), eval_random=False)
            real = sb.graph_mask
            for u, w in zip(a, b):
                torch.testing.assert_close(u[real], w[real], rtol=1e-5, atol=1e-5)


def test_main_syn_sparse_inference_matches_dense(tmp_path):
    """A checkpoint of dense training serves through --layout sparse with
    the dense path's accuracies."""
    ds = generate_synthetic_dataset(data_num=20, node_num=4, seed=5)
    _, _, test, _ = dataset_bias_split(ds, bias=0.5, total=80, seed=5)
    argv = ["--model", "CausalGCN", "--save_dir", str(tmp_path), "--device", "cpu",
            "--hidden", str(HIDDEN), "--layers", str(LAYERS), "--batch_size", "8",
            "--data_num", "20", "--node_num", "4", "--seed", "5"]
    trained = main(argv + ["--epochs", "2", "--save_model", "true"])
    dense = main(argv + ["--inference", "true"])
    sparse = main(argv + ["--inference", "true", "--layout", "sparse"])
    assert sparse["graphs"] == dense["graphs"] == len(test) > 8
    assert sparse["ckpt_step"] == dense["ckpt_step"] == trained["epoch"]
    for k in ("test_acc_co", "test_acc_c", "test_acc_o"):
        assert sparse[k] == dense[k] == trained[k]


def test_sparse_paths_not_ported_raise(tmp_path, capsys):
    """Budget-packed sparse batches, once refused here, are ported:
    --pack_batches true trains (with checkpoints) and serves packed batches
    for both models, and serving gives the trained run's test accuracies."""
    base = ["--device", "cpu", "--data_num", "20", "--node_num", "4", "--batch_size", "8",
            "--layout", "sparse", "--hidden", str(HIDDEN), "--layers", str(LAYERS),
            "--seed", "5", "--pack_batches", "true"]
    for model in ("CausalGCN", "CausalGAT"):
        argv = ["--model", model, *base, "--save_dir", str(tmp_path / model)]
        capsys.readouterr()
        trained = main(argv + ["--epochs", "1", "--save_model", "true"])
        served = main(argv + ["--inference", "true"])
        assert capsys.readouterr().out.count("packed sparse budgets") == 2
        assert all(np.isfinite(h["loss"]) for h in trained["history"])
        for k in ("test_acc_co", "test_acc_c", "test_acc_o"):
            assert served[k] == trained[k], (model, k)
    _, tg = _host_graphs(count=3)
    assert want_pack("sparse", "true", tg, 2) and not want_pack("dense", "true", tg, 2)
    assert not want_pack("sparse", "false", tg, 2)


def test_reddit_threads_match_the_benchmark_generator():
    from benchmarks.gen_reddit_synthetic import make_graph as bench_make_graph

    from cal_tpu_torch.data.reddit_synthetic import make_graph, reddit_graphs

    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for label in (0, 1, 1, 0):
        assert make_graph(a, label) == bench_make_graph(b, label)
    graphs = reddit_graphs(4, seed=3, feat=5)
    assert [g.y for g in graphs] == [0, 1, 0, 1]
    for g in graphs:
        assert g.x.shape == (g.num_nodes, 5) and g.num_nodes >= 60
        pairs = set(zip(g.senders.tolist(), g.receivers.tolist()))
        assert all((v, u) in pairs for u, v in pairs)


def _live_lists(csr):
    """(heavy_chunks, heavy_masked, chunk_row): the live prefixes."""
    n = csr.n_heavy
    return csr.heavy_chunks[:n], csr.heavy_masked[:n], csr.chunk_row[:csr.num_chunks]


def _assert_walk_lists(csr, v, edge_mask=None):
    """EdgeCsr's heavy list: the chunks of the rows of more than one, so
    that the light rows (one chunk each, taken by row) and the listed chunks
    cover every row exactly once; heavy_masked marks the listed chunks whose
    edges are all masked out (none without a mask).  The lists are padded
    to lengths fixed by the edge count alone (heavy_capacity), with zeros
    past the live count, which heavy_count holds."""
    from cal_tpu_torch.graph import heavy_capacity

    cap = heavy_capacity(int(csr.ptr[-1]))
    assert csr.heavy_chunks.shape == csr.heavy_masked.shape == csr.arrivals.shape == (cap,)
    assert csr.chunk_row.shape == (v + cap,) and csr.heavy_count.shape == (1,)
    assert csr.heavy_count.dtype == np.int32 and 0 <= csr.n_heavy <= cap
    assert csr.num_chunks == csr.chunk_ptr[-1]
    for pad in (csr.heavy_chunks[csr.n_heavy:], csr.heavy_masked[csr.n_heavy:],
                csr.chunk_row[csr.num_chunks:]):
        assert not pad.any()
    full = csr
    heavy_chunks, heavy_masked, chunk_row = _live_lists(csr)
    csr = dataclasses.replace(csr, heavy_chunks=heavy_chunks, heavy_masked=heavy_masked,
                              chunk_row=chunk_row)
    chunks = np.diff(csr.chunk_ptr)
    heavy_rows = np.unique(csr.chunk_row[csr.heavy_chunks])
    np.testing.assert_array_equal(heavy_rows, np.flatnonzero(chunks > 1))
    assert csr.heavy_chunks.dtype == np.int32 and (np.diff(csr.heavy_chunks) > 0).all()
    # each light row by row alone, each heavy row by all its chunks, once each
    light = chunks == 1
    listed = np.bincount(csr.chunk_row[csr.heavy_chunks], minlength=v)
    assert (listed[light] == 0).all() and (listed[~light] == chunks[~light]).all()
    # a light row holds at most CHUNK_EDGES edges, a heavy one more
    np.testing.assert_array_equal(light, np.diff(csr.ptr) <= CHUNK_EDGES)
    # heavy row q's chunks sit at places chunk_ptr[r] - (r - q) on the list
    for q, r in enumerate(heavy_rows):
        at = csr.chunk_ptr[r] - (r - q)
        np.testing.assert_array_equal(csr.heavy_chunks[at:at + chunks[r]],
                                      np.arange(csr.chunk_ptr[r], csr.chunk_ptr[r + 1]))
    # a chunk's edges: edge_csr's split of its row, edge by edge
    live = np.ones(csr.ptr[-1], bool) if edge_mask is None else np.asarray(edge_mask)
    live = live if csr.perm is None else live[csr.perm]
    want = []
    for c in csr.heavy_chunks:
        r = csr.chunk_row[c]
        groups = -(-(csr.ptr[r + 1] - csr.ptr[r]) // CHUNK_EDGES)
        span = -(-groups // MAX_CHUNKS) * CHUNK_EDGES
        beg = csr.ptr[r] + (c - csr.chunk_ptr[r]) * span
        assert beg < csr.ptr[r + 1]
        want.append(not live[beg:min(beg + span, csr.ptr[r + 1])].any())
    np.testing.assert_array_equal(csr.heavy_masked, np.array(want, bool))
    assert csr.heavy_masked.dtype == bool
    np.testing.assert_array_equal(full.arrivals, np.zeros(cap, np.int32))


@pytest.mark.parametrize("bs,orientation", [(4, "recv"), (4, "send"), (16, "recv"),
                                            (16, "send")])
def test_walk_heavy_lists_on_reddit_batches(bs, orientation):
    """The heavy-row lists of REDDIT-shaped batches (hub rows of hundreds of
    edges, the padded run at V-1) as the sparse Loader builds them."""
    from cal_tpu_torch.data.reddit_synthetic import reddit_graphs

    graphs = reddit_graphs(2 * bs, seed=5, feat=3)
    n = 0
    for b in Loader(graphs, bs, layout="sparse").host_batches():
        csr = getattr(b, orientation)
        _assert_walk_lists(csr, b.num_nodes, b.edge_mask)
        assert csr.n_heavy > 0
        t = csr.to("cpu")
        assert t.heavy_chunks.dtype == torch.int32 and t.heavy_masked.dtype == torch.bool
        np.testing.assert_array_equal(t.heavy_chunks.numpy(), csr.heavy_chunks)
        n += 1
    assert n == 2


@pytest.mark.parametrize("lengths", [(), (0, 1, 32), (33,), (32, 33, 2048, 2049, 4100),
                                     (5, 0, 70000)])
def test_walk_heavy_lists_by_row_length(lengths):
    """Rows of given lengths (0, 1, 32: light; 33 up: heavy, 2,049 and up
    past the 64-chunk cap), with a light row between each."""
    from cal_tpu_torch.graph import edge_csr

    counts = [c for n in lengths for c in (n, 1)]
    rows = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    for mask in (None, np.arange(rows.size) % 97 < 90):
        csr = edge_csr(rows, len(counts) + 1, None, mask)
        _assert_walk_lists(csr, len(counts) + 1, mask)
        heavy_chunks, _, chunk_row = _live_lists(csr)
        assert np.unique(chunk_row[heavy_chunks]).tolist() == [
            2 * i for i, n in enumerate(lengths) if n > CHUNK_EDGES]
        assert (np.diff(csr.chunk_ptr) <= MAX_CHUNKS).all()
    assert (csr.n_heavy == 0) == all(n <= CHUNK_EDGES for n in lengths)


def test_walk_masks_the_padded_run():
    """A padded batch's run at node V-1 (masked-out edges alone) is marked in
    both CSRs, chunk by chunk, and no chunk holding a real edge is."""
    graphs = _host_graphs(seed=4, count=6, hub=80)[1]
    b = batch_graphs(graphs, 6, 400, 2000)
    for csr in (b.recv, b.send):
        _assert_walk_lists(csr, b.num_nodes, b.edge_mask)
        heavy_chunks, heavy_masked, chunk_row = _live_lists(csr)
        last = chunk_row[heavy_chunks] == b.num_nodes - 1
        assert last.sum() > 1 and heavy_masked[last].all()
        assert not heavy_masked[~last].any()


def _unpadded(csr):
    """The CSR as edge_csr built it before its lists had a fixed capacity:
    the heavy lists and the arrival counters cut to the live count (at
    least one entry) and chunk_row to the live chunks."""
    n = max(csr.n_heavy, 1)
    return dataclasses.replace(csr, chunk_row=csr.chunk_row[:csr.num_chunks],
                               heavy_chunks=csr.heavy_chunks[:n],
                               heavy_masked=csr.heavy_masked[:n], arrivals=csr.arrivals[:n])


def _walk_twin_calls():
    """name -> fn(g, rng): the outputs of every plain twin of the walk
    (K1, the plain conv's degree, K2/K3 and their transposed modes, K5, K6,
    K13-K16, K8-K10, K11/K11T, K12, K19/K19T, K20, K21) on graph g, with
    inputs drawn from rng."""
    from cal_tpu_torch.ops import coo_spmm as coo
    from cal_tpu_torch.ops import gat_sparse as gs
    from cal_tpu_torch.ops import spmm

    def inputs(g, rng, h=16, heads=2):
        v, e = g.num_nodes, int(g.senders.shape[0])
        t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return v, e, h, heads, t

    def degree(g, rng):
        v, *_, t = inputs(g, rng)
        return [*spmm.pair_sender_degree_plain(t(v), t(v), g, norm=True),
                *spmm.plain_sender_degree_plain(g)]

    def pair(g, rng):
        v, e, h, _, t = inputs(g, rng)
        src, dst = t(v), t(v)
        deg, dis = spmm.pair_sender_degree_plain(src, dst, g, norm=True)
        xs, gs_ = [t(v, h), t(v, h)], [t(v, h), t(v, h)]
        vec, ddis_s, ddis_r = spmm.pair_sddmm_chain_plain(*xs, *gs_, src, dst, dis, g)
        return (spmm.coef_spmm_plain(xs, src, dst, deg, dis, g)
                + spmm.coef_spmm_plain(gs_, src, dst, deg, dis, g, transpose=True)
                + [vec, ddis_s, ddis_r, *spmm.pair_dpre_plain(vec, t(2, v), g)])

    def sigmoid(g, rng):
        v, e, h, _, t = inputs(g, rng)
        x, gout, src, dst = t(v, h), t(v, h), t(v), t(v)
        deg, dis = spmm.sigmoid_sender_degree_plain(src, dst, g, negate=True)
        vec, ddis_s, ddis_r = spmm.sigmoid_sddmm_chain_plain(x, gout, src, dst, dis, g, True)
        return [deg, dis, spmm.sigmoid_coef_spmm_plain(x, src, dst, deg, dis, g, True),
                spmm.sigmoid_coef_spmm_plain(gout, src, dst, deg, dis, g, True, transpose=True),
                vec, ddis_s, ddis_r, *spmm.sigmoid_dpre_plain(vec, t(v), g, True)]

    def gat(g, rng):
        v, e, h, heads, t = inputs(g, rng)
        tj, ti, dD = t(heads, v), t(heads, v), t(heads, v)
        x, w = t(v, h), t(v, h)
        m, den = gs.gat_row_stats_plain(tj, ti, g)
        words = (0x9E3779B9, 0x7F4A7C15)
        return [m, den, gs.gat_coef_spmm_plain(x, tj, ti, m, words, 0.2, g),
                gs.gat_coef_spmm_plain(w, tj, ti, m, words, 0.2, g, transpose=True),
                *gs.gat_sddmm_chain_plain(x, w, tj, ti, m, dD, words, 0.2, g)]

    def coo_rows(g, rng):
        v, e, h, heads, t = inputs(g, rng)
        x, gout = t(v, h), t(v, h)
        return [coo.coo_spmm_plain(x, t(e), g), coo.coo_spmm_t_plain(gout, t(e), g),
                coo.coo_sddmm_plain(x, gout, g), coo.coo_spmm_plain(x, t(e, heads), g),
                coo.coo_spmm_t_plain(gout, t(e, heads), g),
                coo.coo_sddmm_plain(x, gout, g, heads), coo.segment_max_plain(t(3, e), g)]

    return {"K1_degree": degree, "K2_K3_K5_K6": pair, "K13_K16": sigmoid,
            "K8_K10": gat, "K11_K12_K19_K21": coo_rows}


@pytest.mark.parametrize("name", list(_walk_twin_calls()))
def test_padded_csr_equals_unpadded_under_the_walk_twins(name):
    """Every plain twin of the walk gives the same bits on a REDDIT-shaped
    batch (hub rows, the padded run at V-1) with its CSRs in their padded
    form (heavy lists of heavy_capacity(E) entries, chunk_row of V +
    heavy_capacity(E)) and cut to their live prefixes."""
    from cal_tpu_torch.data.reddit_synthetic import reddit_graphs

    graphs = reddit_graphs(6, seed=9, feat=3)
    padded = next(Loader(graphs, 6, layout="sparse").host_batches()).to("cpu")
    assert padded.recv.n_heavy > 0 and padded.send.n_heavy > 0
    assert padded.recv.heavy_chunks.shape[0] > padded.recv.n_heavy
    cut = dataclasses.replace(padded, recv=_unpadded(padded.recv), send=_unpadded(padded.send))
    fn = _walk_twin_calls()[name]
    got = fn(padded, np.random.default_rng(3))
    ref = fn(cut, np.random.default_rng(3))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_stack_and_ship_round_trip_a_graph_batch_epoch():
    """A sparse epoch (packed, so with its pad batches) stacked on the host
    and shipped: every step's batch equals the loader's, leaf for leaf
    (both CSRs' padded lists and heavy counts included), the gate holds the
    real steps, and the heavy counts differ between steps."""
    from cal_tpu_torch.data.reddit_synthetic import reddit_graphs
    from cal_tpu_torch.train.steps import has_real_graph, ship, stack_batches_host

    graphs = reddit_graphs(24, seed=4, feat=3)
    loader = Loader(graphs, 8, shuffle=True, layout="sparse", seed=2,
                    budgets=compute_budgets(graphs, 8, "sparse", pack=True))
    batches = list(loader.host_batches())
    stacked = stack_batches_host(batches)
    assert stacked.steps == len(batches) == len(loader)
    np.testing.assert_array_equal(stacked.real, [has_real_graph(b) for b in batches])
    assert not stacked.real.all() and stacked.real.any()
    assert len(set(np.asarray(stacked.batch.recv.heavy_count)[:, 0].tolist())) > 1
    shipped = ship(stacked, torch.device("cpu"))
    assert all(isinstance(t, torch.Tensor) for t in shipped.leaves())
    for s, b in enumerate(batches):
        got = shipped.at(s)
        assert got.num_nodes == b.num_nodes and got.num_graphs == b.num_graphs
        assert len(got.leaves()) == len(b.leaves()) == 8 + 7 + 8
        for a, want in zip(got.leaves(), b.leaves()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="one layout"):
        stack_batches_host(batches[:1] + [next(Loader(graphs, 8).host_batches())])
