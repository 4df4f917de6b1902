"""The port's kernel modules (plain twins, the path CPU tensors take) against
the JAX package's Pallas kernels in interpret mode and its XLA scatter.

Inputs are made with NumPy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cal_tpu.graph import PackedDenseBatch as JaxPacked
from cal_tpu.graph import to_dense as jax_to_dense
from cal_tpu.ops.pallas_adj import adj_build as jax_adj_build
from cal_tpu.ops.pallas_gcn import fused_gcn_dense_att_dual as jax_dual
from cal_tpu_torch.ops.adj_build import adj_build
from cal_tpu_torch.ops.fused_gcn import (
    fused_gcn_dense_att_dual,
    fused_gcn_dense_att_dual_bwd,
    fused_gcn_dense_att_dual_bwd_plain,
    fused_gcn_dense_att_dual_plain,
)

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _edge_flat(rng, b=4, n=12):
    """Sorted flat edges: random edges (self loops included) in slots 0-1, a
    tripled edge and a doubled self loop, slot 2 a graph without edges,
    slot 3 a padded slot, and sentinel padding at the end."""
    flat = []
    n_nodes = np.array([n, n - 3, 5, 0], np.int32)[:b]
    for g in (0, 1):
        k = int(n_nodes[g])
        r = rng.integers(0, k, 30)
        s = rng.integers(0, k, 30)
        flat.append((g * n + r) * n + s)
    flat.append(np.array([(0 * n + 3) * n + 5] * 3))      # multiplicity 3
    flat.append(np.array([(1 * n + 2) * n + 2] * 2))      # doubled self loop
    ef = np.sort(np.concatenate(flat)).astype(np.int64)
    pad = np.full(17, b * n * n, np.int64)
    eg = int(max(np.sum((ef // (n * n)) == g) for g in range(b)))
    return np.concatenate([ef, pad]), n_nodes, eg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx", ["int32", "int64"])
def test_adj_build_matches_pallas_and_scatter(dtype, idx):
    rng = np.random.default_rng(0)
    b, n = 4, 12
    ef, n_nodes, eg = _edge_flat(rng, b, n)
    ours = adj_build(torch.from_numpy(ef.astype(idx)), b, n, TORCH_DT[dtype])
    assert ours.dtype == TORCH_DT[dtype] and ours.shape == (b, n, n)
    ours = ours.float().numpy()
    ef32 = jnp.asarray(ef.astype(np.int32))
    pallas = np.asarray(jax_adj_build(ef32, b, n, eg, jnp.dtype(dtype)),
                        np.float32)
    x = jnp.zeros((b, n, 3), jnp.float32)
    scatter = jax_to_dense(JaxPacked(x=x, edge_flat=ef32, n_nodes=jnp.asarray(n_nodes),
                                     y=jnp.zeros((b,), jnp.int32), eg_budget=0),
                           jnp.dtype(dtype))
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, np.asarray(scatter.adj, np.float32))
    assert ours[0].reshape(-1)[3 * n + 5] >= 3 and ours[1, 2, 2] >= 2
    assert not ours[2:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adj_build_matches_pallas_first_chunks_empty(dtype):
    """N = 256: graph 0 and the first rows of graph 1 hold no edge (the
    kernel's first chunks are empty); a duplicate run, sentinel padding."""
    rng = np.random.default_rng(3)
    b, n = 2, 256
    r = rng.integers(100, n, 300)
    s = rng.integers(0, n, 300)
    ef = np.sort(np.concatenate([(1 * n + r) * n + s, [(1 * n + 200) * n + 7] * 4]))
    ef = np.concatenate([ef, np.full(11, b * n * n)]).astype(np.int32)
    eg = int(ef.size)
    ours = adj_build(torch.from_numpy(ef), b, n, TORCH_DT[dtype]).float().numpy()
    pallas = np.asarray(jax_adj_build(jnp.asarray(ef), b, n, eg, jnp.dtype(dtype)), np.float32)
    np.testing.assert_array_equal(ours, pallas)
    assert not ours[0].any() and not ours[1, :100].any() and ours[1, 200, 7] >= 4


def test_adj_build_empty_edge_list():
    out = adj_build(torch.full((5,), 2 * 4 * 4, dtype=torch.int32), 2, 4,
                    torch.float32)
    assert out.shape == (2, 4, 4) and not out.any()


def _dual_inputs(dtype, b=3, n=20, h=8, seed=1):
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, 2, (b, n, n)).astype(np.float32)
    adj[:, 3, 7] = 2.0                                       # multigraph count
    adj[:, np.arange(n), np.arange(n)] = 1.0                 # self loops (dropped)
    xc = rng.standard_normal((b, n, h)).astype(np.float32)
    xo = rng.standard_normal((b, n, h)).astype(np.float32)
    src = rng.standard_normal((b, n)).astype(np.float32)
    dst = 2.0 * rng.standard_normal((b, n)).astype(np.float32)  # != src
    arrs = (xc, xo, adj, src, dst)
    jx = tuple(jnp.asarray(a, jnp.dtype(dtype)) for a in arrs)
    tx = tuple(torch.tensor(np.asarray(a, np.float32)).to(TORCH_DT[dtype])
               for a in jx)
    return jx, tx


# f32: same math, sums in another order -> 1e-5.  bf16: the norm and the
# output are rounded to bf16 in both at the same places; only the f32 sums'
# order differs, which can move an output across one bf16 rounding
# boundary: one bf16 ulp (2^-7 relative) of the output's scale.
DUAL_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
            "bfloat16": dict(rtol=8e-3, atol=8e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dual_forward_matches_pallas(dtype):
    jx, tx = _dual_inputs(dtype)
    ref_c, ref_o = jax_dual(*jx)
    oc, oo = fused_gcn_dense_att_dual(*tx)
    assert oc.dtype == TORCH_DT[dtype] and oc.shape == tx[0].shape
    np.testing.assert_allclose(oc.float().numpy(), np.asarray(ref_c, np.float32),
                               **DUAL_TOL[dtype])
    np.testing.assert_allclose(oo.float().numpy(), np.asarray(ref_o, np.float32),
                               **DUAL_TOL[dtype])


def test_dual_forward_uses_sender_degree():
    """Swapping src/dst or taking the receiver degree changes the result:
    the comparison above would catch either mistake."""
    jx, tx = _dual_inputs("float32")
    oc, _ = fused_gcn_dense_att_dual(*tx)
    swapped, _ = fused_gcn_dense_att_dual(tx[0], tx[1], tx[2], tx[4], tx[3])
    transposed, _ = fused_gcn_dense_att_dual(tx[0], tx[1], tx[2].transpose(1, 2),
                                             tx[3], tx[4])
    assert (oc - swapped).abs().max() > 1e-2
    assert (oc - transposed).abs().max() > 1e-2


def test_wrappers_reject_bad_inputs():
    _, (xc, xo, adj, src, dst) = _dual_inputs("float32")
    with pytest.raises(ValueError):
        fused_gcn_dense_att_dual(xc, xo, adj, src.to(torch.bfloat16), dst)
    with pytest.raises(ValueError):
        fused_gcn_dense_att_dual(xc, xo[:, :-1], adj, src, dst)
    with pytest.raises(ValueError):
        adj_build(torch.zeros(3, dtype=torch.float32), 1, 2, torch.float32)
    with pytest.raises(ValueError):
        adj_build(torch.zeros(3, dtype=torch.int32), 1, 2, torch.float16)


def test_cpu_tensors_take_the_plain_twin():
    _, tx = _dual_inputs("float32")
    before = (adj_build.launches, fused_gcn_dense_att_dual.launches,
              fused_gcn_dense_att_dual_bwd.launches)
    fused_gcn_dense_att_dual(*tx)
    fused_gcn_dense_att_dual_bwd(*tx, tx[0], tx[1])
    adj_build(torch.zeros(3, dtype=torch.int32), 1, 2, torch.float32)
    assert (adj_build.launches, fused_gcn_dense_att_dual.launches,
            fused_gcn_dense_att_dual_bwd.launches) == before


def _bwd_inputs(dtype, b=3, n=16, h=8):
    """The data of tests/test_pallas_gcn.py (by default B=3, N=16, H=8):
    duplicate edges, zero-degree senders, self loops of count 3 (dropped), a
    fully padded slot (when B > 1); plus seeded cotangents that are non-zero
    at padded nodes."""
    rng = np.random.default_rng(0)
    adj = rng.integers(0, 2, (b, n, n)).astype(np.float32)
    adj += (rng.random((b, n, n)) < 0.1)
    adj[:, :, n - 4:] = 0.0
    adj[0, np.arange(n), np.arange(n)] = 3.0
    xc = rng.normal(size=(b, n, h)).astype(np.float32)
    if b > 1:
        adj[b - 1] = 0.0
        xc[b - 1] = 0.0
    xo = np.tanh(xc)
    src = rng.normal(size=(b, n)).astype(np.float32)
    dst = rng.normal(size=(b, n)).astype(np.float32)
    gc = np.sin(np.arange(xc.size, dtype=np.float32)).reshape(xc.shape)
    go = np.cos(np.arange(xc.size, dtype=np.float32)).reshape(xc.shape)
    arrs = (xc, xo, adj, src, dst, gc, go)
    jx = tuple(jnp.asarray(a, jnp.dtype(dtype)) for a in arrs)
    tx = tuple(torch.tensor(np.asarray(a, np.float32)).to(TORCH_DT[dtype]) for a in jx)
    return jx, tx


# f32: the same formulas, sums in another order (as test_dual_grads).  bf16:
# both round m, g*dis, x*dis, g and x to bf16 at the same places and cast each
# result once, so only an f32 sum's order (or a last-bit difference of rsqrt
# or the sigmoid) can move a result across one bf16 rounding boundary: one
# bf16 ulp (2^-7 relative) of the results' scale (~1 here).
BWD_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
           "bfloat16": dict(rtol=8e-3, atol=8e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h", [(3, 16, 8), (3, 20, 8), (2, 65, 40), (1, 130, 24)])
def test_dual_backward_twin_matches_pallas_vjp(b, n, h, dtype):
    """Beyond tests/test_pallas_gcn.py's data: N across the card kernel's
    64-node blocks and 32- or 64-node steps, H off its 16-column MMA steps."""
    jx, tx = _bwd_inputs(dtype, b, n, h)
    _, vjp = jax.vjp(lambda xc, xo, s, d: jax_dual(xc, xo, jx[2], s, d),
                     jx[0], jx[1], jx[3], jx[4])
    ref = vjp((jx[5], jx[6]))
    ours = fused_gcn_dense_att_dual_bwd(*tx)
    for o, r, name, like in zip(ours, ref, ("dxc", "dxo", "dsrc", "ddst"),
                                (tx[0], tx[1], tx[3], tx[4])):
        assert o.dtype == TORCH_DT[dtype] and o.shape == like.shape, name
        np.testing.assert_allclose(o.float().numpy(), np.asarray(r, np.float32),
                                   err_msg=name, **BWD_TOL[dtype])


def test_dual_backward_twin_matches_autograd_of_forward_twin():
    """The written-out VJP against torch.autograd of the forward twin (f32):
    a check of the formulas themselves."""
    _, (xc, xo, adj, src, dst, gc, go) = _bwd_inputs("float32")
    leaves = [t.clone().requires_grad_() for t in (xc, xo, src, dst)]
    oc, oo = fused_gcn_dense_att_dual_plain(leaves[0], leaves[1], adj, leaves[2], leaves[3])
    ref = torch.autograd.grad((oc * gc).sum() + (oo * go).sum(), leaves)
    ours = fused_gcn_dense_att_dual_bwd_plain(xc, xo, adj, src, dst, gc, go)
    for o, r, name in zip(ours, ref, ("dxc", "dxo", "dsrc", "ddst")):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=2e-5, atol=2e-5,
                                   err_msg=name)


def test_autograd_function_takes_the_backward_wrapper(monkeypatch):
    """On CPU tensors loss.backward() through fused_gcn_dense_att_dual goes
    through fused_gcn_dense_att_dual_bwd (the explicit twin), not through
    autograd of the forward twin."""
    import cal_tpu_torch.ops.fused_gcn as fused_mod

    _, (xc, xo, adj, src, dst, gc, go) = _bwd_inputs("float32")
    calls = []

    def spy(*args):
        calls.append(args)
        return fused_gcn_dense_att_dual_bwd(*args)

    monkeypatch.setattr(fused_mod, "fused_gcn_dense_att_dual_bwd", spy)
    leaves = [t.clone().requires_grad_() for t in (xc, xo, src, dst)]
    oc, oo = fused_gcn_dense_att_dual(leaves[0], leaves[1], adj, leaves[2], leaves[3])
    ((oc * gc).sum() + (oo * go).sum()).backward()
    assert len(calls) == 1
    ref = fused_gcn_dense_att_dual_bwd_plain(xc, xo, adj, src, dst, gc, go)
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r, rtol=0, atol=0)


def test_backward_wrapper_rejects_bad_inputs():
    _, (xc, xo, adj, src, dst, gc, go) = _bwd_inputs("float32")
    with pytest.raises(ValueError):
        fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc[:, :-1], go)
    with pytest.raises(ValueError):
        fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc.to(torch.bfloat16), go)
