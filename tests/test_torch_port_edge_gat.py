"""The port's edge-formulated dense GAT (ops/edge_gat.py) against the JAX
package on the CPU: the plain twins (the path CPU tensors take) against
cal_tpu's edge kernel and its VJP in interpret mode, on the shapes of
tests/test_pallas_gat_sparse.py (duplicate slots, self loops, padded nodes,
an empty last graph); the large-score-spread case; the dropout law; the
backward replaying the forward's mask; and GATConvLayer's dispatch between
the edge and flash kernels against cal_tpu's layer.

Inputs are made with NumPy from a seed and handed to both packages."""
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cal_tpu.ops.pallas_gat as jax_flash_mod
import cal_tpu.ops.pallas_gat_sparse as jax_edge_mod
import cal_tpu_torch.nn.layers as layers_mod
from cal_tpu.graph import DenseGraphBatch as JaxDenseGraphBatch
from cal_tpu.graph import HostGraph as JaxHostGraph
from cal_tpu.graph import pack_dense as jax_pack_dense
from cal_tpu.graph import to_dense as jax_to_dense
from cal_tpu.nn.layers import GATConvLayer as JaxGATConvLayer
from cal_tpu.ops.gat import gat_aggregate_dense as jax_gat_dense
from cal_tpu.ops.pallas_gat_sparse import _edge_gat_core
from cal_tpu.ops.pallas_gat_sparse import edge_gat_dense as jax_edge_gat_dense
from cal_tpu_torch.graph import HostGraph, pack_dense, to_dense
from cal_tpu_torch.nn.layers import GATConvLayer, takes_edge_kernel
from cal_tpu_torch.ops.edge_gat import (
    SELF_COUNTER,
    edge_gat_bwd,
    edge_gat_bwd_plain,
    edge_gat_dense_flat,
    edge_gat_fwd,
    edge_gat_fwd_plain,
    edge_keep,
)

B, N, HEADS, D = 4, 24, 4, 8
EG = 64
# f32: the same f32 math, sums in another order (2e-5 / 5e-5 as cal_tpu's
# own edge-kernel tests).  bf16: cal_tpu's bf16 mode rounds the gathered
# scores, the max, 1/den and the messages to bf16 (2^-8 relative each) where
# the port keeps them f32, and the port rounds its output to bf16 once.
TOL = {"float32": dict(fwd=2e-5, grad=5e-5), "bfloat16": dict(fwd=5e-2, grad=5e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _edges(seed=0, dup=True, empty_last=True):
    """cal_tpu's test list: per graph a few random edges among the first N-2
    nodes, plus two duplicates and a self loop at node 3; the last graph
    empty; padding B*N*N to B*EG slots."""
    rng = np.random.default_rng(seed)
    flat = []
    for g in range(B - (1 if empty_last else 0)):
        e = rng.integers(4, EG - 8)
        r = rng.integers(0, N - 2, e)
        s = rng.integers(0, N - 2, e)
        if dup:
            r = np.concatenate([r, r[:2], [3]])
            s = np.concatenate([s, s[:2], [3]])
        flat.append((g * N + r) * N + s)
    flat = np.sort(np.concatenate(flat))
    ef = np.full(B * EG, B * N * N, np.int64)
    ef[:len(flat)] = flat
    return ef.astype(np.int32), rng


def _inputs(seed=0, dup=True, spread=1.0):
    """(edge_flat, ti, tj [B, N, heads], xh [B, N, heads*d], g) with the
    padded node rows of xh zero."""
    ef, rng = _edges(seed, dup)
    xh = rng.standard_normal((B, N, HEADS * D)).astype(np.float32)
    xh[:, N - 2:] = 0.0
    ti = (spread * rng.standard_normal((B, N, HEADS))).astype(np.float32)
    tj = (spread * rng.standard_normal((B, N, HEADS))).astype(np.float32)
    g = rng.standard_normal((B, N, HEADS * D)).astype(np.float32)
    return ef, ti, tj, xh, g


def _jax_core(ef, precision):
    """cal_tpu's kernel core on the port's layouts (ti, tj [B, N, heads];
    its planes are [B, heads, N]), with the window cal_tpu's wrapper builds."""
    e = ef.shape[0]
    rb = -(-EG // 128) + 2
    rows = -(-e // 128) + rb
    ef2 = np.concatenate([ef, np.full(rows * 128 - e, B * N * N, ef.dtype)]).reshape(rows, 128)
    starts = np.searchsorted(ef, np.arange(B) * N * N).astype(np.int32)
    seed = jnp.zeros((1, 128), jnp.int32)
    return lambda ti, tj, xh: _edge_gat_core(
        jnp.asarray(ef2), jnp.asarray(starts), ti.transpose(0, 2, 1), tj.transpose(0, 2, 1),
        xh, seed, EG, 0.0, precision)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dup", [True, False], ids=["multigraph", "simple"])
def test_twins_match_pallas_kernel_and_vjp(dtype, dup):
    ef, ti, tj, xh, g = _inputs(seed=3, dup=dup)
    xj = jnp.asarray(xh, JDT[dtype])
    out, vjp = jax.vjp(_jax_core(ef, "f32" if dtype == "float32" else "bf16"),
                       jnp.asarray(ti), jnp.asarray(tj), xj)
    gj = jnp.asarray(g, JDT[dtype])
    dti_j, dtj_j, dxh_j = vjp(gj.astype(jnp.float32))
    tx = torch.from_numpy(xh).to(TDT[dtype])
    ef_t, ti_t, tj_t = torch.from_numpy(ef), torch.from_numpy(ti), torch.from_numpy(tj)
    got = edge_gat_fwd(ti_t, tj_t, tx, ef_t)
    assert got.dtype == TDT[dtype]
    tol = TOL[dtype]
    _close(got.float(), out, tol["fwd"], "out")
    dti, dtj, dxh = edge_gat_bwd(ti_t, tj_t, tx, ef_t, torch.from_numpy(np.array(
        gj.astype(jnp.float32))).to(TDT[dtype]))
    _close(dti, dti_j, tol["grad"], "dti")
    _close(dtj, dtj_j, tol["grad"], "dtj")
    _close(dxh.float(), jnp.asarray(dxh_j, jnp.float32), tol["grad"], "dxh")
    # the padded node rows and the empty graph keep their self term only
    np.testing.assert_array_equal(got.float().numpy()[:, N - 2:], 0.0)


def test_entry_matches_jax_entry_and_dense_reference():
    """edge_gat_dense_flat against cal_tpu's edge_gat_dense and the XLA dense
    reference: output and the gradients of xh and both attention halves."""
    ef, _, _, xh, _ = _inputs(seed=5)
    rng = np.random.default_rng(5)
    ad, asr = ((0.3 * rng.standard_normal((HEADS, D))).astype(np.float32) for _ in range(2))
    x4 = jnp.asarray(xh.reshape(B, N, HEADS, D))
    loss_j = lambda x, a, b: jnp.sum(jax_edge_gat_dense(x, jnp.asarray(ef), EG, a, b) ** 2)
    ref = jax_edge_gat_dense(x4, jnp.asarray(ef), EG, jnp.asarray(ad), jnp.asarray(asr))
    adj = np.zeros(B * N * N, np.float32)
    np.add.at(adj, ef[ef < B * N * N], 1.0)
    dense = jax_gat_dense(x4, jnp.asarray(adj.reshape(B, N, N)), jnp.asarray(ad),
                          jnp.asarray(asr))
    grads = jax.grad(loss_j, argnums=(0, 1, 2))(x4, jnp.asarray(ad), jnp.asarray(asr))
    leaves = [torch.tensor(a, requires_grad=True) for a in (xh, ad, asr)]
    out = edge_gat_dense_flat(leaves[0], torch.from_numpy(ef), leaves[1], leaves[2])
    _close(out.detach().reshape(B, N, HEADS, D), ref, 2e-5, "out vs edge_gat_dense")
    _close(out.detach().reshape(B, N, HEADS, D), dense, 2e-5, "out vs gat_aggregate_dense")
    (out ** 2).sum().backward()
    for name, t, r in zip(("xh", "att_dst", "att_src"), leaves, grads):
        _close(t.grad.reshape(r.shape), r, 5e-5, name)


def test_large_score_spread_stays_finite():
    """Score spreads of order 100 must not underflow the denominator
    (cal_tpu's regression test: same tolerance against the XLA reference)."""
    ef, ti, tj, xh, g = _inputs(seed=11, spread=40.0)
    ti_t, tj_t, x_t, ef_t = (torch.from_numpy(a) for a in (ti, tj, xh, ef))
    out = edge_gat_fwd(ti_t, tj_t, x_t, ef_t)
    assert torch.isfinite(out).all()
    want = np.asarray(_jax_core(ef, "f32")(jnp.asarray(ti), jnp.asarray(tj), jnp.asarray(xh)))
    _close(out, want, 1e-3, "out")
    assert all(torch.isfinite(t).all() for t in edge_gat_bwd(ti_t, tj_t, x_t, ef_t,
                                                              torch.from_numpy(g)))


def test_dropout_law_per_slot():
    """Keep fraction 1 - rate within 5 binomial sd over (slot, head) pairs and
    over self terms; the two slots of a duplicated edge draw independent
    bits (P(both kept) = 0.64); self counters lie above every slot's."""
    rate, seed = 0.2, 0x9E3779B97F4A7C15
    slots = torch.arange(200_000)
    keep_e, keep_v = edge_keep(slots, 50_000, HEADS, seed, rate)
    for k in (keep_e, keep_v):
        p = float(k.float().mean())
        assert abs(p - (1 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / k.numel()), p
    # slots 2i and 2i + 1: the two copies of one edge in a multigraph's list
    both = float((keep_e[0::2] & keep_e[1::2]).float().mean())
    n_pairs = keep_e[0::2].numel()
    assert abs(both - 0.64) <= 5 * np.sqrt(0.64 * 0.36 / n_pairs), both
    assert SELF_COUNTER > slots.numel() * HEADS
    # the same bits for another seed differ, and a zero rate keeps everything
    assert not torch.equal(keep_e, edge_keep(slots, 50_000, HEADS, seed + 1, rate)[0])
    # a duplicated edge drops its copies one at a time in the forward twin
    ef, ti, tj, xh, _ = _inputs(seed=3)
    args = [torch.from_numpy(a) for a in (ti, tj, np.abs(xh))] + [torch.from_numpy(ef)]
    ratios = [float(edge_gat_fwd_plain(*args, s, rate).sum() / edge_gat_fwd_plain(*args).sum())
              for s in range(64)]
    assert abs(np.mean(ratios) - 1.0) <= 0.02


def test_backward_replays_forward_mask():
    """With dropout on, the backward (its twin) equals autograd of the
    forward twin under the same seed, and differs from it under another."""
    ef, ti, tj, xh, g = _inputs(seed=7)
    seed, rate = 12345, 0.2
    leaves = [torch.tensor(a, requires_grad=True) for a in (ti, tj, xh)]
    out = edge_gat_fwd_plain(*leaves, torch.from_numpy(ef), seed, rate)
    auto = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    args = [torch.from_numpy(a) for a in (ti, tj, xh)] + [torch.from_numpy(ef),
                                                          torch.from_numpy(g)]
    got = edge_gat_bwd_plain(*args, seed, rate)
    for name, a, r in zip(("dti", "dtj", "dxh"), got, auto):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=5e-5, atol=5e-5, err_msg=name)
    other = edge_gat_bwd_plain(*args, seed + 1, rate)
    assert not torch.allclose(other[2], got[2])


def _layer_graphs(n_nodes, n_edges, seed=0, feat=8):
    """Host graphs (both packages) with duplicates and self loops."""
    rng = np.random.default_rng(seed)
    out = []
    for n, e in zip(n_nodes, n_edges):
        s = rng.integers(0, n, e).astype(np.int32)
        r = rng.integers(0, n, e).astype(np.int32)
        s[:3], r[:3] = s[3:6], r[3:6]                 # duplicate slots
        r[6] = s[6]                                   # a self loop
        x = rng.standard_normal((n, feat)).astype(np.float32)
        out.append((x, s, r, 0))
    return ([JaxHostGraph(x=x, senders=s, receivers=r, y=y) for x, s, r, y in out],
            [HostGraph(x=x, senders=s, receivers=r, y=y) for x, s, r, y in out])


def _layer_pair(n_nodes, n_edges, node_budget):
    jg, tg = _layer_graphs(n_nodes, n_edges)
    e_budget = -(-sum(n_edges) // 128) * 128
    gj = jax_to_dense(jax_pack_dense(jg, 2, node_budget, e_budget))
    gt = to_dense(pack_dense(tg, 2, node_budget, e_budget).to("cpu"))
    jl = JaxGATConvLayer(out_per_head=4, heads=4)
    variables = jl.init(jax.random.PRNGKey(0), gj.x, gj)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.3, a.shape).astype(
        np.float32), variables["params"])
    tl = GATConvLayer(8, 4, heads=4)
    tl.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return gj, gt, jl, params, tl


def _spies():
    return (mock.patch.object(layers_mod, "edge_gat_dense_flat",
                              wraps=layers_mod.edge_gat_dense_flat),
            mock.patch.object(layers_mod, "flash_gat_dense_flat",
                              wraps=layers_mod.flash_gat_dense_flat))


def test_layer_at_384_takes_edge_kernel_and_matches_jax():
    """A dense batch at N = 384 within the edge window runs the edge kernel
    in both packages and gives the same output and input gradient."""
    gj, gt, jl, params, tl = _layer_pair([384, 290], [700, 520], 384)
    assert gt.edge_flat is not None and gt.eg_budget == 700
    ref = jl.apply({"params": params}, gj.x, gj)
    x = gt.x.clone().requires_grad_()
    edge, flash = _spies()
    with edge as e_spy, flash as f_spy:
        out = tl(x, gt)
    assert e_spy.call_count == 1 and f_spy.call_count == 0
    _close(out.detach(), ref, 2e-5, "layer out")
    gref = jax.grad(lambda xx: jnp.sum(jl.apply({"params": params}, xx, gj) ** 2))(gj.x)
    (out ** 2).sum().backward()
    _close(x.grad, gref, 5e-5, "layer dx")


@pytest.mark.parametrize("case", ["n256", "window_exceeded"])
def test_layer_takes_flash_outside_the_switch(case):
    """At N = 256, or at N = 384 with eg_budget above the window (ceil(eg /
    128) + 2 rows of 128 > 3N), the layer runs flash, as cal_tpu's."""
    n_nodes, n_edges, nb = (([250, 200], [600, 400], 256) if case == "n256"
                            else ([384, 300], [1000, 500], 384))
    gj, gt, jl, params, tl = _layer_pair(n_nodes, n_edges, nb)
    ref = jl.apply({"params": params}, gj.x, gj)
    edge, flash = _spies()
    with edge as e_spy, flash as f_spy, torch.no_grad():
        out = tl(gt.x, gt)
    assert e_spy.call_count == 0 and f_spy.call_count == 1
    _close(out, ref, 2e-5, "layer out")


def test_predicate_matches_cal_tpu_dispatch():
    """takes_edge_kernel equals the choice cal_tpu's GATConvLayer makes, read
    from which of its two kernels it calls, over a grid of (N, eg_budget)."""
    calls = []

    def edge_stub(xh, *a, **k):
        calls.append("edge")
        return jnp.zeros_like(xh)

    def flash_stub(xh, *a, **k):
        calls.append("flash")
        return jnp.zeros_like(xh)

    layer = JaxGATConvLayer(out_per_head=2, heads=2)
    with mock.patch.object(jax_edge_mod, "edge_gat_dense", edge_stub), \
            mock.patch.object(jax_flash_mod, "flash_gat_dense_flat", flash_stub):
        for n in (128, 256, 383, 384, 400, 512, 1024, 3840):
            for eg in (None, 1, 128, 640, 896, 897, 1000, 3000, 8752, 11264):
                x = jnp.zeros((1, n, 3), jnp.float32)
                ef = None if eg is None else jnp.zeros((4,), jnp.int32)
                gj = JaxDenseGraphBatch(x=x, adj=None, node_mask=None, y=None,
                                        graph_mask=None, edge_flat=ef, eg_budget=eg or 0)
                layer.init(jax.random.PRNGKey(0), x, gj)
                ours = takes_edge_kernel(SimpleNamespace(edge_flat=ef, eg_budget=eg or 0), n)
                assert calls.pop() == ("edge" if ours else "flash"), (n, eg)
    assert not calls
