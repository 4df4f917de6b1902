"""The port's native packer (``cal_tpu_torch/native``) on the CPU: bit for bit
against its plain twins (``graph.pack_dense``, ``_SparseDataset.pack``) and
against cal_tpu's ``PackedDataset``, on random graphs with an empty graph, a
graph at the node budget and an edge overflow; the loaders that use it; and
a build that fails raises (no fallback), while builds that race succeed."""
import os
import threading

import numpy as np
import pytest

import cal_tpu.native as jax_native
import cal_tpu_torch.native as native
from cal_tpu_torch.data.loader import Loader, _SparseDataset, compute_budgets
from cal_tpu_torch.graph import HostGraph, pack_dense

NODE_BUDGET = 24


def _graphs(seed=0, count=12, feat=5):
    """Random graphs: graph 0 has no edge, graph 1 sits at the node budget,
    the rest have 2-20 nodes; edges in random order with duplicates."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = NODE_BUDGET if i == 1 else int(rng.integers(2, 21))
        e = 0 if i == 0 else int(rng.integers(1, 3 * n))
        out.append(HostGraph(x=rng.standard_normal((n, feat)).astype(np.float32),
                             senders=rng.integers(0, n, e).astype(np.int32),
                             receivers=rng.integers(0, n, e).astype(np.int32),
                             y=int(rng.integers(0, 3))))
    return out


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("idx", [[0, 1, 2, 3], [1], [0], [5, 0, 1, 7, 11, 2, 9, 3]])
def test_dense_pack_matches_numpy_and_cal_tpu(idx):
    graphs = _graphs()
    idx = np.array(idx)
    edge_budget = 512
    got = native.PackedDataset(graphs).pack_dense_batch(idx, 8, NODE_BUDGET, edge_budget)
    ref = pack_dense([graphs[i] for i in idx], 8, NODE_BUDGET, edge_budget)
    for k in ("x", "edge_flat", "n_nodes", "y"):
        _equal(getattr(got, k), getattr(ref, k), k)
    assert got.eg_budget == ref.eg_budget
    jx = jax_native.PackedDataset(graphs).pack_dense(idx, 8, NODE_BUDGET, edge_budget)
    ours = native.PackedDataset(graphs).pack_dense(idx, 8, NODE_BUDGET, edge_budget)
    for a, b, k in zip(ours, jx, ("x", "edge_flat", "n_nodes", "y")):
        _equal(a, b, k)


def test_dense_pack_overflows_raise_as_the_numpy_packer():
    """An edge overflow, a graph over the node budget and too many graphs
    raise the NumPy packer's ValueError, message for message (cal_tpu's
    packer raises a ValueError too)."""
    graphs = _graphs()
    pd = native.PackedDataset(graphs)
    idx = np.arange(8)
    tot_e = sum(graphs[i].num_edges for i in idx)
    for args in ((idx, 8, NODE_BUDGET, tot_e - 1), (idx, 8, NODE_BUDGET - 8, 1024),
                 (idx, 4, NODE_BUDGET, 1024)):
        with pytest.raises(ValueError) as ref:
            pack_dense([graphs[i] for i in args[0]], *args[1:])
        with pytest.raises(ValueError) as got:
            pd.pack_dense_batch(*args)
        assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError):
        jax_native.PackedDataset(graphs).pack_dense(idx.astype(np.int32), 8, NODE_BUDGET,
                                                    tot_e - 1)


@pytest.mark.parametrize("idx", [[0, 1, 2, 3], [1], [], [5, 0, 1, 7, 11, 2, 9, 3]])
def test_sparse_pack_matches_numpy_and_cal_tpu(idx):
    graphs = _graphs(seed=1)
    idx = np.array(idx, np.int64)
    v, e = 256, 640
    got = native.PackedDataset(graphs).pack_sparse_batch(idx, 8, v, e)
    ref = _SparseDataset(graphs).pack(idx, 8, v, e)
    for k in ("x", "senders", "receivers", "edge_mask", "node_mask", "node_graph", "y",
              "graph_mask"):
        _equal(getattr(got, k), getattr(ref, k), k)
    for orient in ("recv", "send"):
        for k in ("ptr", "chunk_ptr", "chunk_row", "heavy_chunks", "heavy_masked", "heavy_count",
                  "arrivals", "perm"):
            a, b = getattr(getattr(got, orient), k), getattr(getattr(ref, orient), k)
            assert (a is None) == (b is None), (orient, k)
            if a is not None:
                _equal(a, b, f"{orient}.{k}")
    jx = jax_native.PackedDataset(graphs).pack_sparse(idx.astype(np.int32), 8, v, e)
    ours = native.PackedDataset(graphs).pack_sparse(idx, 8, v, e)
    for a, b, k in zip(ours, jx, range(8)):
        _equal(a, b, k)


def test_sparse_pack_overflow_raises_as_the_numpy_packer():
    graphs = _graphs(seed=1)
    idx = np.arange(8)
    tot_e = sum(graphs[i].num_edges for i in idx)
    with pytest.raises(ValueError) as ref:
        _SparseDataset(graphs).pack(idx, 8, 256, tot_e - 1)
    with pytest.raises(ValueError) as got:
        native.PackedDataset(graphs).pack_sparse_batch(idx, 8, 256, tot_e - 1)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("layout,pack", [("dense", False), ("sparse", False), ("sparse", True)])
def test_loader_native_equals_numpy_packer(layout, pack):
    """A loader's epochs are the same, leaf for leaf, with the native packer
    (the default) and with the NumPy twins (``packer="numpy"``)."""
    graphs = _graphs(seed=2, count=40)
    budgets = compute_budgets(graphs, 8, layout, pack=pack)
    a = Loader(graphs, 8, shuffle=True, budgets=budgets, seed=3, layout=layout)
    b = Loader(graphs, 8, shuffle=True, budgets=budgets, seed=3, layout=layout,
               packer="numpy")
    assert a.packer == "native" and b.packer == "numpy"
    for _ in range(2):
        for x, y in zip(a.host_batches(), b.host_batches()):
            keys = (("x", "edge_flat", "n_nodes", "y") if layout == "dense" else
                    ("x", "senders", "receivers", "edge_mask", "node_mask", "node_graph", "y",
                     "graph_mask"))
            for k in keys:
                _equal(getattr(x, k), getattr(y, k), k)
            if layout == "sparse":
                _equal(x.send.perm, y.send.perm, "send.perm")
    with pytest.raises(ValueError, match="unknown packer"):
        Loader(graphs, 8, packer="python")


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile, or no g++, raises; nothing falls
    back to the NumPy packer."""
    bad = tmp_path / "pack.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "LIB", str(tmp_path / "lib" / "libcalpack.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "lib"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
    assert not os.path.exists(native.LIB)


def test_racing_builds_all_succeed(tmp_path, monkeypatch):
    """Builds started at once into one directory (as test workers do) each
    end with a complete library that loads."""
    import ctypes
    import sys

    monkeypatch.setattr(native, "LIB", str(tmp_path / "libcalpack.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    errors, paths = [], []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def run():
            try:
                paths.append(native.build())
            except Exception as exc:   # collected and asserted below
                errors.append(exc)

        threads = [threading.Thread(target=run) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and all(not t.is_alive() for t in threads)
    assert paths == [native.LIB] * 12
    lib = ctypes.CDLL(native.LIB)
    assert lib.pack_dense_batch and lib.pack_sparse_batch
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
