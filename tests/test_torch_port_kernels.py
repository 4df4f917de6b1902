"""The port's kernel modules (plain twins, the path CPU tensors take) against
the JAX package's Pallas kernels in interpret mode and its XLA scatter.

Inputs are made with NumPy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cal_tpu.graph import PackedDenseBatch as JaxPacked
from cal_tpu.graph import to_dense as jax_to_dense
from cal_tpu.ops.pallas_adj import adj_build as jax_adj_build
from cal_tpu.ops.pallas_gcn import fused_gcn_dense_att_dual as jax_dual
from cal_tpu_torch.ops.adj_build import adj_build
from cal_tpu_torch.ops.fused_gcn import fused_gcn_dense_att_dual

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
    before = (adj_build.launches, fused_gcn_dense_att_dual.launches)
    fused_gcn_dense_att_dual(*tx)
    adj_build(torch.zeros(3, dtype=torch.int32), 1, 2, torch.float32)
    assert (adj_build.launches, fused_gcn_dense_att_dual.launches) == before
