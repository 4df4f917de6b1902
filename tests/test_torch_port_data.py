"""The port's host data path (synthetic generator, split, loader) against the
JAX package's, which builds its graphs with networkx."""
import networkx as nx
import numpy as np
import pytest

from cal_tpu.data import synthetic as jax_syn
from cal_tpu.data.loader import Loader as JaxLoader
from cal_tpu.graph import pack_dense as jax_pack_dense
from cal_tpu_torch.data import synthetic as syn
from cal_tpu_torch.data.loader import Loader, compute_budgets


@pytest.mark.parametrize("n,m,seed", [(225, 2, 0), (30, 3, 7), (10, 1, 123456)])
def test_barabasi_albert_matches_networkx(n, m, seed):
    ref = nx.barabasi_albert_graph(n, m, seed=seed)
    ours = syn.barabasi_albert_graph(n, m, seed)
    assert ours.edges() == list(ref.edges())
    assert dict(ours.degree()) == dict(ref.degree())


@pytest.mark.parametrize("r,h", [(15, 2), (3, 3), (1, 4)])
def test_balanced_tree_matches_networkx(r, h):
    assert syn.balanced_tree(r, h).edges() == list(nx.balanced_tree(r, h).edges())


@pytest.mark.parametrize("node_num,feature_dim", [(15, -1), (5, -1), (5, 3)])
def test_dataset_and_split_match_jax(node_num, feature_dim):
    kw = dict(data_num=4, node_num=node_num, seed=11, feature_dim=feature_dim)
    ref = jax_syn.generate_synthetic_dataset(**kw)
    ours = syn.generate_synthetic_dataset(**kw)
    for c in syn.SYN_CONTEXTS:
        for s in syn.SYN_CLASSES:
            for a, b in zip(ours[c][s], ref[c][s], strict=True):
                np.testing.assert_array_equal(a.senders, b.senders)
                np.testing.assert_array_equal(a.receivers, b.receivers)
                np.testing.assert_array_equal(a.x, b.x)
                assert a.y == b.y
    split_o = syn.dataset_bias_split(ours, bias=0.75, total=16, seed=2)
    split_r = jax_syn.dataset_bias_split(ref, bias=0.75, total=16, seed=2)
    assert split_o[3] == split_r[3]
    for lo, lr in zip(split_o[:3], split_r[:3]):
        assert [g.num_edges for g in lo] == [g.num_edges for g in lr]
        assert [g.y for g in lo] == [g.y for g in lr]


def test_generator_properties():
    ds = syn.generate_synthetic_dataset(data_num=3, seed=1)
    g = ds["tree"]["house"][0]
    assert g.num_nodes == 241 + 5 and g.x.shape == (246, 10)
    assert (g.x.sum(1) == 1).all()
    assert ds["ba"]["cycle"][0].num_nodes == 225 + 6
    pairs = set(zip(g.senders.tolist(), g.receivers.tolist()))
    assert all((v, u) in pairs for u, v in pairs)


@pytest.mark.parametrize("bs,shuffle", [(8, False), (5, True)])
def test_loader_matches_jax(bs, shuffle):
    ds = jax_syn.generate_synthetic_dataset(data_num=3, node_num=5, seed=4)
    jax_graphs = [g for c in ds.values() for lst in c.values() for g in lst]
    ds_o = syn.generate_synthetic_dataset(data_num=3, node_num=5, seed=4)
    graphs = [g for c in ds_o.values() for lst in c.values() for g in lst]
    jl = JaxLoader(jax_graphs, bs, shuffle=shuffle, seed=3, layout="dense", prefetch=0)
    tl = Loader(graphs, bs, shuffle=shuffle, seed=3)
    assert tl.budgets == compute_budgets(graphs, bs)
    assert {k: tl.budgets[k] for k in jl.budgets} == jl.budgets
    nb, eb = tl.budgets["node_budget"], tl.budgets["edge_budget"]
    order = iter(np.random.default_rng(3).permutation(len(graphs)) if shuffle
                 else np.arange(len(graphs)))
    n_batches = 0
    for jb, tb in zip(jl.host_batches(), tl.host_batches(), strict=True):
        idx = [next(order) for _ in range(int((tb.n_nodes > 0).sum()))]
        pk = jax_pack_dense([jax_graphs[i] for i in idx], bs, nb, eb)
        for ref in (jb, pk):
            np.testing.assert_array_equal(tb.edge_flat, np.asarray(ref.edge_flat))
            np.testing.assert_array_equal(tb.x, np.asarray(ref.x))
            np.testing.assert_array_equal(tb.n_nodes, np.asarray(ref.n_nodes))
            np.testing.assert_array_equal(tb.y, np.asarray(ref.y))
        assert tb.edge_flat.dtype == np.int32
        assert tb.eg_budget == jb.eg_budget
        n_batches += 1
    assert n_batches == len(tl) > 1
