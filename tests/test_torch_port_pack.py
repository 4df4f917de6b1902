"""Budget-packed sparse batching of the port against the JAX package on the
CPU: ``compute_packed_budgets``, the pack-mode ``Loader`` (its length,
``schedule_steps``, the shuffle stream over several epochs, the redraws
included, and the NumPy leaves of every batch, the epoch's empty batches
included) against cal_tpu's pack-mode ``Loader`` without tile plans; a
packed ``train_causal_syn`` against cal_tpu's; packed ``main_real`` on
SYNREDDIT.  Heavy-tailed random graphs from a NumPy seed, small sizes."""
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
from test_torch_port_sparse_train import _tiny_split

import cal_tpu.train.causal as jax_train_mod
import cal_tpu_torch.train.steps as steps_mod
from cal_tpu.data.loader import Loader as JaxLoader
from cal_tpu.data.loader import compute_packed_budgets as jax_packed_budgets
from cal_tpu.graph import HostGraph as JaxHostGraph
from cal_tpu.utils.config import Config as JaxConfig
from cal_tpu_torch.data.loader import Loader, compute_budgets, compute_packed_budgets
from cal_tpu_torch.graph import CHUNK_EDGES, HostGraph
from cal_tpu_torch.main_real import main as main_real
from cal_tpu_torch.models.causal import CausalGNN
from cal_tpu_torch.train.causal import train_causal_syn
from cal_tpu_torch.utils.checkpoint import params_from_jax
from cal_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS, SEED = 8, 3
LEAVES = ("x", "senders", "receivers", "edge_mask", "node_mask", "node_graph", "y",
          "graph_mask")


def _heavy_tailed(count=60, seed=0):
    """Graphs of lognormal sizes (3-150 nodes) with self loops and duplicate
    edges, in both packages' HostGraph."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(np.clip(rng.lognormal(np.log(12), 0.9), 3, 150))
        e = int(rng.integers(n, 3 * n))
        s, r = (rng.integers(0, n, e).astype(np.int32) for _ in range(2))
        out.append((rng.standard_normal((n, 5)).astype(np.float32), s, r,
                    int(rng.integers(2))))
    return ([JaxHostGraph(x=x, senders=s, receivers=r, y=y) for x, s, r, y in out],
            [HostGraph(x=x, senders=s, receivers=r, y=y) for x, s, r, y in out])


def _loaders(shuffle, tight=False):
    jg, tg = _heavy_tailed()
    budgets = compute_packed_budgets(tg, BS)
    assert budgets == jax_packed_budgets(jg, BS)
    assert compute_budgets(tg, BS, "sparse", pack=True) == budgets
    jl = JaxLoader(jg, BS, shuffle=shuffle, layout="sparse", budgets=budgets, seed=SEED,
                   prefetch=0, spmm_tiles=False)
    tl = Loader(tg, BS, shuffle=shuffle, layout="sparse", budgets=budgets, seed=SEED)
    assert (len(tl), tl.schedule_steps) == (len(jl), jl.schedule_steps)
    assert tl.pack and len(tl) > tl.schedule_steps
    if tight:
        # one step fewer than the simulations allow: some shuffles now pack
        # over the budget, and both loaders redraw them from their stream
        jl._steps_budget = tl._steps_budget = len(tl) - 1
        first = np.random.default_rng(SEED)
        assert any(len(tl._pack_chunks(first.permutation(len(tg)))) > len(tl)
                   for _ in range(14))
    return jl, tl


@pytest.mark.parametrize("shuffle,tight", [(True, False), (True, True), (False, False)])
def test_packed_epoch_stream_matches_jax(shuffle, tight):
    jl, tl = _loaders(shuffle, tight)
    for _ in range(14 if tight else 3):
        jc, tc = jl._chunks(), tl._chunks()
        assert len(tc) == len(jc) == len(tl)
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a, b)
        assert sum(len(c) for c in tc) == len(tl.graphs)
        assert tight or len(tc[-1]) == 0          # the budget's slack step is padding


def test_packed_host_batches_match_jax():
    jl, tl = _loaders(shuffle=True)
    pads = 0
    for jb, tb in zip(jl.host_batches(), tl.host_batches(), strict=True):
        for f in LEAVES:
            np.testing.assert_array_equal(getattr(tb, f), np.asarray(getattr(jb, f)), f)
        v = tb.num_nodes
        # both CSR forms stay valid at any live count, an empty batch included
        np.testing.assert_array_equal(tb.recv.ptr, np.searchsorted(tb.receivers,
                                                                   np.arange(v + 1)))
        np.testing.assert_array_equal(tb.send.perm, np.argsort(tb.senders, kind="stable"))
        np.testing.assert_array_equal(tb.send.ptr, np.searchsorted(
            tb.senders[tb.send.perm], np.arange(v + 1)))
        assert tb.recv.num_chunks >= v and tb.send.num_chunks >= v
        if not tb.graph_mask.any():
            pads += 1
            assert not tb.edge_mask.any() and not tb.node_mask.any()
            assert (tb.node_graph == BS).all() and (tb.senders == v - 1).all()
            assert np.diff(tb.recv.chunk_ptr)[-1] > 1          # the padded run at V-1
        else:
            assert tb.graph_mask.sum() == np.unique(tb.node_graph[tb.node_mask]).size
            assert tb.edge_mask.sum() <= CHUNK_EDGES * tb.recv.num_chunks
    assert pads >= 1


def test_pack_mode_refusals():
    _, tg = _heavy_tailed(count=10)
    budgets = compute_packed_budgets(tg, BS)
    with pytest.raises(ValueError, match="layout='sparse'"):
        Loader(tg, BS, budgets=budgets)
    with pytest.raises(ValueError, match="every graph"):
        Loader(tg, BS, layout="sparse", budgets=budgets, drop_remainder=True)
    with pytest.raises(ValueError, match="sparse-layout only"):
        compute_budgets(tg, BS, "dense", pack=True)


def test_train_causal_syn_packed_matches_jax(tmp_path, capsys):
    """The packed sparse trainer on the CPU, f32, without the intervention
    shuffle, from cal_tpu's initial weights: per-epoch losses within 1e-4,
    the same selected accuracies and epoch, and the schedule counting real
    steps (cal_tpu's trainer packs these small splits without tile plans)."""
    kw = dict(model="CausalGCN", epochs=3, batch_size=32, hidden=16, layers=1, lr=0.01,
              with_random=False, seed=3, layout="sparse", pack_batches="true")
    jtrain, jval, jtest = _tiny_split("jax")
    init = {}
    real_init = jax_train_mod.init_state

    def record(*a, **k):
        st = real_init(*a, **k)
        init.update(params=jax.tree.map(np.asarray, st.params),
                    stats=jax.tree.map(np.asarray, st.batch_stats))
        return st

    with mock.patch.object(jax_train_mod, "init_state", record):
        ref = jax_train_mod.train_causal_syn(jtrain, jval, jtest, JaxConfig(
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
    assert "packed sparse budgets" in capsys.readouterr().out
    assert res["steps_per_epoch"] > -(-len(train) // 32)        # the epoch ends with padding
    np.testing.assert_allclose([h["loss"] for h in res["history"]], ref_losses, rtol=1e-4)
    for k in ("best_val_acc", "test_acc_co", "test_acc_c", "test_acc_o", "epoch"):
        assert res[k] == pytest.approx(ref[k], abs=1e-12), k


def test_main_real_sparse_packs_synreddit(tmp_path, capsys):
    """main_real --layout sparse on SYNREDDIT: "auto" packs (the worst-case
    batch holds several mean batches of these heavy-tailed threads), trains
    both folds and prints the protocol's lines."""
    root = str(tmp_path)
    subprocess.run([sys.executable, "-m", "benchmarks.gen_reddit_synthetic", "--root", root,
                    "--graphs", "16"], cwd=ROOT, check=True, capture_output=True)
    res = main_real(["--model", "CausalGCN", "--dataset", "SYNREDDIT", "--data_root", root,
                     "--device", "cpu", "--folds", "2", "--epochs", "1", "--hidden", "16",
                     "--batch_size", "4", "--layout", "sparse"])
    out = capsys.readouterr().out
    assert "pack_batches auto: worst-case batch" in out and "packed sparse budgets" in out
    assert out.count("syd: Causal fold:") == 2 and "sydall Final: Causal" in out
    assert all(np.isfinite(h["loss"]) for h in res["history"])
