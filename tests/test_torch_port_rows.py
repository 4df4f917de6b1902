"""The port's kernels for the last four TPU kernel rows against the JAX
package, on their plain twins (CPU tensors).

Row 4 (``fused_gcn_dense``, K17/K17T) and row 3 (``fused_gcn_dense_att``,
K18/K18B, both ``negate``s) against cal_tpu/ops/pallas_gcn.py's functions and
``jax.vjp`` of them, f32 and bf16; row 9 (``coo_spmm_mh``, K19/K19T/K20)
against ``coo_spmm_mh`` and its VJP on f32 tile plans; row 14
(``segment_max``, K21) against ``tile_scatter_max``, exact; and the two
aggregates over them, ``gat_aggregate_sparse_mh`` and
``gcn_aggregate_sparse_coo``, against cal_tpu's ``*_pallas`` functions.  The
Pallas kernels run in interpret mode on the CPU, at tests/test_pallas_spmm.py's
sizes (V 256, E 700; dense B 3, N 40, H 32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_sparse import NB, T, _workload

from cal_tpu.ops.gat import gat_aggregate_sparse_pallas as jax_gat_mh
from cal_tpu.ops.gcn import gcn_aggregate_dense as jax_gcn_dense
from cal_tpu.ops.pallas_gcn import SigmoidEdgeWeight as JaxSigmoidEdgeWeight
from cal_tpu.ops.pallas_gcn import fused_gcn_dense as jax_fused_gcn_dense
from cal_tpu.ops.pallas_gcn import fused_gcn_dense_att as jax_fused_gcn_dense_att
from cal_tpu.ops.pallas_spmm import build_tiles
from cal_tpu.ops.pallas_spmm import coo_spmm_mh as jax_coo_spmm_mh
from cal_tpu.ops.pallas_spmm import gcn_aggregate_sparse_pallas as jax_gcn_coo
from cal_tpu.ops.pallas_spmm import tile_scatter_max
from cal_tpu_torch.ops import coo_spmm as coo
from cal_tpu_torch.ops.fused_gcn import (
    SigmoidEdgeWeight,
    fused_gcn_dense,
    fused_gcn_dense_att,
    fused_gcn_dense_att_bwd,
    fused_gcn_dense_t,
    plain_cluster_size,
)
from cal_tpu_torch.ops.gat import gat_aggregate_sparse_mh
from cal_tpu_torch.ops.gcn import gcn_aggregate_dense, gcn_aggregate_sparse_coo

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Twins against the Pallas kernels in interpret mode.  f32: the same f32
# math with sums in another order.  bf16: the same rounding points (norm, m,
# x * dis and g * dis rounded to bf16, f32 sums, one cast at the end), so
# the gap is a bf16 rounding of a result whose f32 sum differs in its last
# bits (2^-8 relative), carried through the gradients' sums.
DENSE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# Row 9 on f32 plans: f32 products summed in another order (slots vs CSR).
MH_TOL = dict(rtol=1e-5, atol=1e-5)
B, N, H = 3, 40, 32


def _dense_inputs(seed, dtype, b=B, n=N):
    rng = np.random.default_rng(seed)
    adj = (rng.random((b, n, n)) < 0.15).astype(np.float32)
    adj += rng.random((b, n, n)) < 0.03                  # duplicate edges
    adj[b - 1] = 0.0                                     # a padded graph slot
    x = rng.standard_normal((b, n, H)).astype(np.float32)
    src, dst = (rng.standard_normal((b, n)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, n, H)).astype(np.float32)
    j = [jnp.asarray(a, JDT[dtype]) for a in (x, adj, src, dst, g)]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in (x, adj, src, dst, g)]
    return j, t


def _close(got, ref, dtype, what):
    tol = DENSE_TOL[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


# N = 40 (the Pallas tests' size); 256 and 257 straddle the limit of the
# kernels' one-launch path (plain_cluster_size), at B = 2
@pytest.mark.parametrize("b,n", [(B, N), (2, 256), (2, 257)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row4_twins_match_pallas(dtype, b, n):
    """K17 and K17T twins (through the autograd Function and directly)
    against fused_gcn_dense and its VJP, the same _mm_kernel transposed."""
    (jx, jadj, _, _, jg), (x, adj, _, _, g) = _dense_inputs(0, dtype, b, n)
    ref, vjp = jax.vjp(lambda a: jax_fused_gcn_dense(a, jadj), jx)
    (ref_dx,) = vjp(jg)
    leaf = x.clone().requires_grad_()
    out = fused_gcn_dense(leaf, adj)
    (dx,) = torch.autograd.grad(out, leaf, g)
    assert out.dtype == dx.dtype == TDT[dtype]
    _close(out, ref, dtype, "K17")
    _close(dx, ref_dx, dtype, "K17T")
    torch.testing.assert_close(fused_gcn_dense_t(g, adj), dx, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,n,h,cluster", [
    (torch.bfloat16, 256, 128, 2),    # chip_smoke.py's dense batch: the path's limit
    (torch.bfloat16, 232, 128, 2),    # the parity entry point's sizes
    (torch.bfloat16, 248, 128, 2),
    (torch.bfloat16, 128, 128, 1),
    (torch.bfloat16, 257, 128, 0),    # one past the limit: two passes
    (torch.bfloat16, 512, 128, 0),
    (torch.bfloat16, 1, 8, 1),
    (torch.bfloat16, 200, 200, 2),    # two feature chunks
    (torch.bfloat16, 256, 100, 0),    # H not a multiple of 8
    (torch.bfloat16, 0, 128, 0),
    (torch.float32, 256, 128, 0),     # f32 keeps the two-pass FMA kernels
])
def test_row4_path_chooser(dtype, n, h, cluster):
    """Which path K17/K17T take on the card, and with how many CTAs a graph."""
    assert plain_cluster_size(dtype, n, h) == cluster


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row3_twins_match_pallas(dtype, negate):
    """K18 and K18B twins against fused_gcn_dense_att and jax.vjp of it in
    x, src and dst; the VJP's dsrc / ddst in the logits' dtype."""
    (jx, jadj, jsrc, jdst, jg), (x, adj, src, dst, g) = _dense_inputs(1, dtype)
    ref, vjp = jax.vjp(lambda a, s, d: jax_fused_gcn_dense_att(a, jadj, s, d, negate),
                       jx, jsrc, jdst)
    refs = vjp(jg)
    leaves = [t.clone().requires_grad_() for t in (x, src, dst)]
    out = fused_gcn_dense_att(leaves[0], adj, leaves[1], leaves[2], negate)
    grads = torch.autograd.grad(out, leaves, g)
    _close(out, ref, dtype, "K18")
    for name, got, want in zip(("dx", "dsrc", "ddst"), grads, refs):
        assert got.dtype == TDT[dtype]
        _close(got, want, dtype, f"K18B {name}")
    direct = fused_gcn_dense_att_bwd(x, adj, src, dst, g, negate)
    for got, want in zip(direct, grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("negate", [False, True])
def test_weighted_dense_reference_matches_jax(negate):
    """gcn_aggregate_dense with an edge weight and SigmoidEdgeWeight
    .materialize against cal_tpu's (the parity script's reference)."""
    (jx, jadj, jsrc, jdst, _), (x, adj, src, dst, _) = _dense_inputs(2, "float32")
    w = SigmoidEdgeWeight(src, dst, negate).materialize()
    jw = JaxSigmoidEdgeWeight(jsrc, jdst, negate=negate).materialize()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gcn_aggregate_dense(x, adj, w).numpy(),
                               np.asarray(jax_gcn_dense(jx, jadj, jw)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(fused_gcn_dense_att(x, adj, src, dst, negate).numpy(),
                               gcn_aggregate_dense(x, adj, w).numpy(), rtol=2e-5, atol=2e-5)


def _sparse_case(seed, heads=4, d=8):
    """The sparse workload (self loops, a hub row, a masked padded run at
    V-1) with f32 plans over every edge, as cal_tpu's parity script builds
    them, and per-head features."""
    rng = np.random.default_rng(seed)
    g, _, _ = _workload(rng, h=heads * d)
    v = g.num_nodes
    s, r = np.asarray(g.senders), np.asarray(g.receivers)
    tf = build_tiles(s, r, v, node_block=NB, tile_edges=T)
    tb = build_tiles(r, s, v, node_block=NB, tile_edges=T)
    live = np.asarray(g.edge_mask) & (s != r)
    return g, tf, tb, live, rng


@pytest.mark.parametrize("heads", [1, 2, 4, 8])
def test_row9_twins_match_pallas(heads):
    """K19, K19T and K20 twins (through the Function and directly) against
    coo_spmm_mh and jax.vjp of it on f32 plans, at every head count the
    kernels take (H 32); the caller's coefficients are zero on dead and
    self-loop edges, and dcoef covers every edge."""
    d = 32 // heads
    g, tf, tb, live, rng = _sparse_case(0, heads, d)
    v, e = g.num_nodes, g.senders.shape[0]
    x = rng.standard_normal((v, heads * d)).astype(np.float32)
    gout = rng.standard_normal((v, heads * d)).astype(np.float32)
    coef = np.where(live[:, None], rng.random((e, heads)), 0.0).astype(np.float32)
    coef_ext = np.concatenate([coef, np.zeros((1, heads), np.float32)])
    ref, vjp = jax.vjp(lambda a, c: jax_coo_spmm_mh(a, c, tf, tb, heads, NB),
                       jnp.asarray(x), jnp.asarray(coef_ext))
    ref_dx, ref_dcoef = (np.asarray(a) for a in vjp(jnp.asarray(gout)))
    gt = g.to("cpu")
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, coef)]
    out = coo.coo_spmm_mh(leaves[0], leaves[1], gt, heads)
    dx, dcoef = torch.autograd.grad(out, leaves, torch.from_numpy(gout))
    assert out.dtype == dcoef.dtype == torch.float32 and dcoef.shape == (e, heads)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **MH_TOL)
    np.testing.assert_allclose(dx.numpy(), ref_dx, **MH_TOL)
    np.testing.assert_allclose(dcoef.numpy(), ref_dcoef[:-1], **MH_TOL)
    assert np.abs(ref_dcoef[:-1][~live]).min() > 0          # dead edges get their dcoef
    tx, tc, tg = (torch.from_numpy(a) for a in (x, coef, gout))
    torch.testing.assert_close(coo.coo_spmm_mh_t(tg, tc, gt, heads), dx, rtol=0, atol=0)
    torch.testing.assert_close(coo.coo_sddmm_mh(tx, tg, gt, heads), dcoef, rtol=0, atol=0)
    # one head is K11 / K12
    torch.testing.assert_close(coo.coo_spmm_mh(tx, tc[:, :1].contiguous(), gt, 1),
                               coo.coo_spmm(tx, tc[:, 0].contiguous(), gt), rtol=0, atol=0)
    torch.testing.assert_close(coo.coo_sddmm_mh(tx, tg, gt, 1)[:, 0],
                               coo.coo_sddmm(tx, tg, gt), rtol=0, atol=0)


def test_row9_bf16_plans_within_rounding():
    """On bf16 plans cal_tpu rounds x, each weighted message and (in the
    VJP) g and each g message to bf16 before its f32 sums
    (``_spmm_mh_kernel``); the port reads bf16 x and sums exact f32
    products.  Each output lies within 2^-7 (1 + 2^-8) of the sum of its
    terms' magnitudes of cal_tpu's (tests/test_torch_port_gin.py's bound
    for row 8), plus f32 summation noise; the port's dx also takes one
    bf16 rounding of its own (2^-8 relative)."""
    heads, d = 4, 8
    g, _, _, live, rng = _sparse_case(6, heads, d)
    v, e = g.num_nodes, g.senders.shape[0]
    s, r = np.asarray(g.senders), np.asarray(g.receivers)
    tf = build_tiles(s, r, v, node_block=NB, tile_edges=T, precision="bf16")
    tb = build_tiles(r, s, v, node_block=NB, tile_edges=T, precision="bf16")
    x = np.asarray(torch.from_numpy(rng.standard_normal((v, heads * d)).astype(np.float32))
                   .bfloat16().float())
    gout = rng.standard_normal((v, heads * d)).astype(np.float32)
    coef = np.where(live[:, None], rng.random((e, heads)), 0.0).astype(np.float32)
    coef_ext = np.concatenate([coef, np.zeros((1, heads), np.float32)])
    ref, vjp = jax.vjp(lambda a, c: jax_coo_spmm_mh(a, c, tf, tb, heads, NB),
                       jnp.asarray(x), jnp.asarray(coef_ext))
    ref_dx, ref_dcoef = (np.asarray(a) for a in vjp(jnp.asarray(gout)))
    gt = g.to("cpu")
    leaves = [torch.from_numpy(x).bfloat16().requires_grad_(),
              torch.from_numpy(coef).requires_grad_()]
    out = coo.coo_spmm_mh(leaves[0], leaves[1], gt, heads)
    dx, dcoef = torch.autograd.grad(out, leaves, torch.from_numpy(gout))
    tol = 2.0 ** -7 * (1 + 2.0 ** -8)
    ac = np.repeat(np.abs(coef), d, axis=1)
    fwd_terms = np.zeros_like(x)
    np.add.at(fwd_terms, r, ac * np.abs(x[s]))
    bwd_terms = np.zeros_like(x)
    np.add.at(bwd_terms, s, ac * np.abs(gout[r]))
    dot_terms = (np.abs(gout[r]) * np.abs(x[s])).reshape(e, heads, d).sum(-1)
    # the port's dx is rounded once more, to x's dtype (cal_tpu's x is f32)
    dx32 = dx.float().numpy()
    for name, got, want, bound in (
            ("K19", out.detach().numpy(), np.asarray(ref), tol * fwd_terms),
            ("K19T", dx32, ref_dx, tol * bwd_terms + 2.0 ** -8 * np.abs(dx32)),
            ("K20", dcoef.numpy(), ref_dcoef[:-1], tol * dot_terms)):
        excess = np.abs(got - want) - (bound + 1e-5)
        assert excess.max() <= 0, (name, excess.max())
    assert np.abs(out.detach().numpy() - np.asarray(ref)).max() > 0   # the rounding shows


def test_row9_refuses_bad_heads():
    g, _, _, _, _ = _sparse_case(1, 4, 8)
    gt = g.to("cpu")
    x = torch.zeros((g.num_nodes, 32))
    coef = torch.zeros((g.senders.shape[0], 3))
    with pytest.raises(ValueError, match="heads"):
        coo.coo_spmm_mh(x, coef, gt, 3)
    with pytest.raises(ValueError, match="coef"):
        coo.coo_spmm_mh(x, coef, gt, 4)


def test_row14_twin_matches_tile_scatter_max():
    """K21's twin against tile_scatter_max, exact: edge-order values mapped
    to tile slots through the plan's perm (pad slots -1e30), dead edges
    -1e30, receivers without a live edge at the -1e30 init."""
    rng = np.random.default_rng(3)
    g, _, _ = _workload(rng, h=16)
    v, e = g.num_nodes, g.senders.shape[0]
    mask = np.asarray(g.edge_mask)
    tf = build_tiles(np.asarray(g.senders), np.asarray(g.receivers), v, node_block=NB,
                     tile_edges=T, edge_mask=mask)
    k = 3
    vals = np.where(mask[None], rng.standard_normal((k, e)), -1e30).astype(np.float32)
    ext = np.concatenate([vals, np.full((k, 1), -1e30, np.float32)], axis=1)
    slots = ext[:, np.asarray(tf.perm)].transpose(1, 0, 2)          # [n_tiles, K, T]
    want = np.asarray(tile_scatter_max(jnp.asarray(slots), tf, v, node_block=NB))
    got = coo.segment_max(torch.from_numpy(vals), g.to("cpu"))
    assert got.dtype == torch.float32 and got.shape == (k, v)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1e30).any(axis=1).all()                         # empty receivers


def test_gcn_aggregate_sparse_coo_matches_pallas():
    """The weighted sparse GCN over K11 against gcn_aggregate_sparse_pallas:
    fwd and the gradients in x and in the edge weight (K12)."""
    g, tf, tb, _, rng = _sparse_case(4, 1, 16)
    v, e = g.num_nodes, g.senders.shape[0]
    x = rng.standard_normal((v, 16)).astype(np.float32)
    w = rng.random(e).astype(np.float32)
    gout = rng.standard_normal((v, 16)).astype(np.float32)
    js, jr, jm = (jnp.asarray(a) for a in (g.senders, g.receivers, g.edge_mask))
    ref, vjp = jax.vjp(lambda a, b: jax_gcn_coo(a, js, jr, jm, tf, tb, b, NB),
                       jnp.asarray(x), jnp.asarray(w))
    refs = vjp(jnp.asarray(gout))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w)]
    out = gcn_aggregate_sparse_coo(leaves[0], g.to("cpu"), leaves[1])
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(gout))
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    for got, want in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_gat_aggregate_sparse_mh_matches_pallas():
    """The sparse GAT over K19 against gat_aggregate_sparse_pallas: fwd and
    the gradients in xh, att_dst and att_src (K19T and K20 inside)."""
    heads, d = 4, 8
    g, tf, tb, _, rng = _sparse_case(5, heads, d)
    v = g.num_nodes
    xh = rng.standard_normal((v, heads, d)).astype(np.float32)
    ad, asr = (rng.standard_normal((heads, d)).astype(np.float32) * 0.5 for _ in range(2))
    gout = rng.standard_normal((v, heads, d)).astype(np.float32)
    js, jr, jm = (jnp.asarray(a) for a in (g.senders, g.receivers, g.edge_mask))
    ref, vjp = jax.vjp(lambda a, b, c: jax_gat_mh(a, js, jr, jm, b, c, tf, tb),
                       jnp.asarray(xh), jnp.asarray(ad), jnp.asarray(asr))
    refs = vjp(jnp.asarray(gout))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xh, ad, asr)]
    out = gat_aggregate_sparse_mh(leaves[0], g.to("cpu"), leaves[1], leaves[2])
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(gout))
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    for got, want in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
