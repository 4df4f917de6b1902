"""Row 12 of the kernel table, the single sigmoid-weighted sparse GCN
aggregate, against the JAX package on the CPU.

``gcn_aggregate_sparse_sigmoid`` (its autograd Function over the plain
twins of K13-K16, the path CPU tensors take) and
``gcn_aggregate_sparse_sigmoid_plain`` (autograd of plain ops) against
cal_tpu's ``gcn_aggregate_sparse_sigmoid_pallas`` in interpret mode, as
tests/test_pallas_spmm.py runs it: the forward and the gradients in x, src
and dst, at ``negate`` False and True, on a small graph (V = 128, E = 300)
with dead edges, self loops and duplicate edges.  Inputs are made with
NumPy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cal_tpu.ops.pallas_spmm import _sig_fwd, build_tiles, gcn_aggregate_sparse_sigmoid_pallas
from cal_tpu_torch.graph import sparse_batch
from cal_tpu_torch.ops import spmm

NB, T = 64, 32                 # small tile plans for interpret mode
V, E, H = 128, 300, 16
# f32, the same math in both packages with sums in another order (tile
# slots against CSR rows, index_add) and XLA's against PyTorch's rsqrt.
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, V, E).astype(np.int32)
    r = rng.integers(0, V, E).astype(np.int32)
    s[:15] = r[:15]                                  # self loops
    s[15:40], r[15:40] = s[40:65], r[40:65]          # duplicate edges
    o = np.argsort(r, kind="stable")
    s, r = s[o], r[o]
    mask = rng.random(E) > 0.15                      # dead edges among the live ones
    x = rng.standard_normal((V, H)).astype(np.float32)
    src, dst = (rng.standard_normal(V).astype(np.float32) for _ in range(2))
    gout = rng.standard_normal((V, H)).astype(np.float32)
    g = sparse_batch(np.zeros((V, 1), np.float32), s, r, mask, np.ones(V, bool),
                     np.zeros(V, np.int32), np.zeros(1, np.int32), np.ones(1, bool)).to("cpu")
    return s, r, mask, x, src, dst, gout, g


def _jax(s, r, mask, x, src, dst, gout, negate):
    tf = build_tiles(s, r, V, node_block=NB, tile_edges=T, edge_mask=mask)
    tb = build_tiles(r, s, V, node_block=NB, tile_edges=T, edge_mask=mask)
    fn = lambda *a: gcn_aggregate_sparse_sigmoid_pallas(*a, tf, tb, negate, node_block=NB)
    out, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst))
    return [np.asarray(out)] + [np.asarray(t) for t in vjp(jnp.asarray(gout))]


def _torch(fn, x, src, dst, gout, g, negate):
    leaves = [torch.tensor(t, requires_grad=True) for t in (x, src, dst)]
    out = fn(*leaves, g, negate)
    grads = torch.autograd.grad(out, leaves, torch.tensor(gout))
    return [t.detach().numpy() for t in (out, *grads)]


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("fn", [spmm.gcn_aggregate_sparse_sigmoid,
                                spmm.gcn_aggregate_sparse_sigmoid_plain],
                         ids=["function", "plain"])
def test_sigmoid_aggregate_matches_pallas(fn, negate):
    s, r, mask, x, src, dst, gout, g = _case()
    ref = _jax(s, r, mask, x, src, dst, gout, negate)
    got = _torch(fn, x, src, dst, gout, g, negate)
    for name, a, b in zip(("out", "dx", "dsrc", "ddst"), got, ref, strict=True):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("negate", [False, True])
def test_sigmoid_sender_degree_matches_sig_fwd(negate):
    """K13's twin, (deg, dis) [V] as the kernel writes them (deg = 1 + the
    sender sums, dis = deg^-1/2 in the row's write), against the deg and
    dis that cal_tpu's ``_sig_fwd`` forms from tile_scatter2's sums."""
    s, r, mask, x, src, dst, _, g = _case(3)
    tf = build_tiles(s, r, V, node_block=NB, tile_edges=T, edge_mask=mask)
    tb = build_tiles(r, s, V, node_block=NB, tile_edges=T, edge_mask=mask)
    _, res = _sig_fwd(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), tf, tb, negate, NB)
    deg, dis = spmm.sigmoid_sender_degree(torch.tensor(src), torch.tensor(dst), g, negate)
    assert deg.shape == dis.shape == (V,)
    np.testing.assert_allclose(deg.numpy(), np.asarray(res[6]), **TOL)
    np.testing.assert_allclose(dis.numpy(), np.asarray(res[7]), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sigmoid_twins_match_autograd_and_skip_the_chain(dtype, monkeypatch):
    """The Function's backward (twins of K14T, K15, K16) against autograd of
    the plain function, in both dtypes (the same f32 math, each result
    rounded once); constant logits skip K15 and K16, as the pair does."""
    *_, x, src, dst, gout, g = _case(1)
    x, src, dst, gout = (torch.tensor(t).to(dtype) for t in (x, src, dst, gout))
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for negate in (False, True):
        res = []
        for fn in (spmm.gcn_aggregate_sparse_sigmoid, spmm.gcn_aggregate_sparse_sigmoid_plain):
            leaves = [t.clone().requires_grad_() for t in (x, src, dst)]
            out = fn(*leaves, g, negate)
            assert out.dtype == dtype
            res.append([out, *torch.autograd.grad(out, leaves, gout)])
        for a, b in zip(*res):
            assert a.dtype == b.dtype == dtype
            torch.testing.assert_close(a.float(), b.float(), **tol)
    calls = []
    real = spmm.sigmoid_sddmm_chain
    monkeypatch.setattr(spmm, "sigmoid_sddmm_chain", lambda *a: calls.append(a) or real(*a))
    xl = x.clone().requires_grad_()
    spmm.gcn_aggregate_sparse_sigmoid(xl, src, dst, g).sum().backward()
    assert not calls and xl.grad is not None


def test_sigmoid_takes_logits_in_their_own_dtype():
    """bf16 x with f32 logits (the benchmark's config 4): the Function keeps
    each input's dtype in its gradients and matches the Pallas kernel, which
    takes the logits in their own dtype too.  bf16 outputs are rounded once
    from f32 sums taken in another order: one bf16 ulp apart at most."""
    s, r, mask, x, src, dst, gout, g = _case(2)
    xb = torch.tensor(x).to(torch.bfloat16)
    gb = torch.tensor(gout).to(torch.bfloat16)
    tf = build_tiles(s, r, V, node_block=NB, tile_edges=T, edge_mask=mask)
    tb = build_tiles(r, s, V, node_block=NB, tile_edges=T, edge_mask=mask)
    fn = lambda *a: gcn_aggregate_sparse_sigmoid_pallas(*a, tf, tb, True, node_block=NB)
    out, vjp = jax.vjp(fn, jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(src),
                       jnp.asarray(dst))
    ref = [out] + list(vjp(jnp.asarray(gb.float().numpy(), jnp.bfloat16)))
    leaves = [xb.clone().requires_grad_(), torch.tensor(src, requires_grad=True),
              torch.tensor(dst, requires_grad=True)]
    got = spmm.gcn_aggregate_sparse_sigmoid(*leaves, g, True)
    got = [got, *torch.autograd.grad(got, leaves, gb)]
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                      torch.float32]
    for name, a, b in zip(("out", "dx", "dsrc", "ddst"), got, ref, strict=True):
        tol = TOL if a.dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(a.detach().float().numpy(), np.asarray(b, np.float32),
                                   err_msg=name, **tol)
