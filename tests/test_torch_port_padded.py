"""The port's twins against the JAX package on padded, mostly empty batches.

Rows 2 and 3's forward (``fused_gcn_dense_att_dual``, K18 at both
``negate``s) against cal_tpu/ops/pallas_gcn.py's functions in interpret mode
on a padded dense batch (N = 384, graphs of 30-120 nodes: most 64 x 32 cells
of the adjacency hold no edge, the shape the kernels' live map skips); row 14
(``segment_max``, K21) against ``tile_scatter_max`` on a heavy-tailed sparse
batch (rows of 0, 1-4 and more than 32 edges and a padded run at node V-1),
exact.  Inputs are made with NumPy from a seed and handed to both packages;
CPU tensors take the plain twins."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_sparse import NB, T

from cal_tpu.ops.pallas_gcn import fused_gcn_dense_att as jax_att
from cal_tpu.ops.pallas_gcn import fused_gcn_dense_att_dual as jax_dual
from cal_tpu.ops.pallas_spmm import build_tiles, tile_scatter_max
from cal_tpu_torch.graph import sparse_batch
from cal_tpu_torch.ops import coo_spmm as coo
from cal_tpu_torch.ops import fused_gcn as fg

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# As tests/test_torch_port_kernels.py DUAL_TOL: f32 the same math with sums in
# another order; bf16 the same rounding points, so an output may cross one
# bf16 rounding boundary (2^-7 relative of its scale).
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=8e-3, atol=8e-3)}
B, N, H = 2, 384, 32
SIZES = (120, 30)   # real nodes of each graph slot


def _padded_inputs(seed, dtype):
    """A padded dense batch: graph b on its first SIZES[b] slots (about 3
    edges a node, some doubled, a few self loops), nothing past them; x and
    the logits random on every slot."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((B, N, N), np.float32)
    for b, n in enumerate(SIZES):
        r, s = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
        np.add.at(adj[b], (r, s), 1.0)
        adj[b, np.arange(0, n, 7), np.arange(0, n, 7)] = 1.0      # self loops, dropped
    arrs = [rng.standard_normal((B, N, H)).astype(np.float32) for _ in range(2)]
    arrs += [adj, rng.standard_normal((B, N)).astype(np.float32),
             2.0 * rng.standard_normal((B, N)).astype(np.float32)]
    jx = [jnp.asarray(a, jnp.dtype(dtype)) for a in arrs]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype]) for a in jx]
    return jx, tx


def _empty_cells(adj) -> float:
    """The share of the batch's 64 x 32 adjacency cells without an edge."""
    cells = adj.reshape(B, N // 64, 64, N // 32, 32).any(axis=(2, 4))
    return 1.0 - cells.mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dual_forward_twin_matches_pallas_on_padded_batch(dtype):
    jx, tx = _padded_inputs(5, dtype)
    assert _empty_cells(np.asarray(tx[2].float())) > 0.9
    want = jax_dual(*jx)
    got = fg.fused_gcn_dense_att_dual(*tx)
    for o, w in zip(got, want):
        assert o.dtype == TDT[dtype] and o.shape == (B, N, H)
        np.testing.assert_allclose(o.float().numpy(), np.asarray(w, np.float32), **TOL[dtype])


@pytest.mark.parametrize("negate", [False, True])
def test_single_conv_twin_matches_pallas_on_padded_batch(negate):
    (jxc, _, jadj, jsrc, jdst), (xc, _, adj, src, dst) = _padded_inputs(6, "bfloat16")
    want = jax_att(jxc, jadj, jsrc, jdst, negate=negate)
    got = fg.fused_gcn_dense_att(xc, adj, src, dst, negate)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL["bfloat16"])


def test_backward_hand_over_wants_stats_and_live_map_together():
    """The forward's degree statistics and live map reach a backward as a
    pair of the forward's shapes (checked before any launch)."""
    x = torch.zeros((3, 200, 8))
    stats, live = torch.zeros((4, 3, 200)), torch.zeros(fg.live_shape(3, 200), dtype=torch.uint8)
    assert fg.live_shape(3, 200) == (3, 4, 7)
    fg._check_handed("bwd", None, None, 2, x)
    fg._check_handed("bwd", stats, live, 2, x)
    for bad in ((stats, None), (None, live), (stats[:2], live), (stats, live[:, :3]),
                (stats, live.float())):
        with pytest.raises(ValueError):
            fg._check_handed("bwd", *bad, 2, x)


def _heavy_tailed_batch(rng, v=320):
    """Receiver-sorted edges: most rows 1-4 edges, rows without an edge,
    rows of 33 and 140 edges (several chunks), and a padded run of 500 dead
    edges at node V-1."""
    counts = rng.integers(1, 5, v - 1)
    counts[rng.choice(v - 1, 40, replace=False)] = 0
    counts[[5, 77]] = (33, 140)
    receivers = np.repeat(np.arange(v - 1), counts)
    senders = rng.integers(0, v - 1, receivers.size)
    pad = 500
    senders = np.concatenate([senders, np.full(pad, v - 1)])
    receivers = np.concatenate([receivers, np.full(pad, v - 1)])
    mask = np.arange(senders.size) < senders.size - pad
    return sparse_batch(np.zeros((v, 1), np.float32), senders, receivers, mask,
                        np.ones(v, bool), np.zeros(v, np.int32), np.zeros(1, np.int32),
                        np.ones(1, bool))


def test_segment_max_twin_matches_tile_scatter_max_on_heavy_tailed_batch():
    """K21's twin against tile_scatter_max, exact, on rows of every class:
    edge-order values mapped to tile slots through the plan's perm (pad
    slots -1e30), dead edges -1e30, empty receivers at the -1e30 init."""
    rng = np.random.default_rng(14)
    g = _heavy_tailed_batch(rng)
    v, e = g.num_nodes, g.senders.shape[0]
    n = np.diff(np.asarray(g.recv.ptr))
    assert (n == 0).any() and ((n >= 1) & (n <= 4)).any() and (n > 32).sum() == 3
    assert np.asarray(g.recv.heavy_chunks).size > 0
    mask = np.asarray(g.edge_mask)
    tf = build_tiles(np.asarray(g.senders), np.asarray(g.receivers), v, node_block=NB,
                     tile_edges=T, edge_mask=mask)
    k = 4
    vals = np.where(mask[None], rng.standard_normal((k, e)), -1e30).astype(np.float32)
    ext = np.concatenate([vals, np.full((k, 1), -1e30, np.float32)], axis=1)
    slots = ext[:, np.asarray(tf.perm)].transpose(1, 0, 2)          # [n_tiles, K, T]
    want = np.asarray(tile_scatter_max(jnp.asarray(slots), tf, v, node_block=NB))
    got = coo.segment_max(torch.from_numpy(vals), g.to("cpu"))
    assert got.dtype == torch.float32 and got.shape == (k, v)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, n == 0] == -1e30).all() and (want[:, -1] == -1e30).all()
