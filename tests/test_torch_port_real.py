"""The port's real-data protocol against the JAX package on the CPU: the TU
reader and feature expansion, the k-fold splits and the feat_str grammar, the
k-fold trainer, dense CausalGAT at N = 384 (where its GAT convs take the
edge-formulated kernel in both packages), the refusals, and the entry point.

The TU data is written into a temporary directory by the repo's NumPy
generators (benchmarks/gen_tu_synthetic.py, gen_reddit_synthetic.py) at a
few dozen graphs."""
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_model import CLASSES, _batches, _models
from test_torch_port_train import C_W, CO_W, EPOCHS, LR, MIN_LR, O_W, WD, _jax_grads

import cal_tpu.ops.pallas_gat_sparse as jax_edge_mod
import cal_tpu.train.causal as jax_train_mod
import cal_tpu_torch.nn.layers as layers_mod
import cal_tpu_torch.train.steps as steps_mod
from cal_tpu.data.datasets import create_n_filter_triples as jax_triples
from cal_tpu.data.datasets import get_dataset as jax_get_dataset
from cal_tpu.data.datasets import parse_feat_str as jax_parse_feat_str
from cal_tpu.data.kfold import k_fold as jax_k_fold
from cal_tpu.graph import HostGraph as JaxHostGraph
from cal_tpu.train.optim import make_optimizer as jax_make_optimizer
from cal_tpu.train.steps import TrainState as JaxTrainState
from cal_tpu.train.steps import _as_graph, to_device
from cal_tpu.utils.config import Config as JaxConfig
from cal_tpu_torch.data.datasets import create_n_filter_triples, get_dataset, parse_feat_str
from cal_tpu_torch.data.kfold import k_fold
from cal_tpu_torch.graph import HostGraph, to_dense
from cal_tpu_torch.main_real import main
from cal_tpu_torch.models.causal import CausalGNN
from cal_tpu_torch.train.causal import train_causal_real
from cal_tpu_torch.train.optim import cosine_lr, make_optimizer
from cal_tpu_torch.train.steps import TrainState, make_causal_train_step
from cal_tpu_torch.utils.checkpoint import params_from_jax
from cal_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tu_root(tmp_path_factory):
    """SYNNCI (node labels) at 36 graphs and SYNREDDIT (no node labels) at 16,
    in TU text format."""
    root = str(tmp_path_factory.mktemp("tu"))
    for mod, graphs in (("gen_tu_synthetic", 36), ("gen_reddit_synthetic", 16)):
        subprocess.run([sys.executable, "-m", f"benchmarks.{mod}", "--root", root,
                        "--graphs", str(graphs)], cwd=ROOT, check=True, capture_output=True)
    return root


def _assert_same_graphs(ours, ref):
    assert len(ours) == len(ref) and ours.num_classes == ref.num_classes
    for a, b in zip(ours, ref, strict=True):
        for k in ("x", "senders", "receivers", "xg"):
            va, vb = getattr(a, k), getattr(b, k)
            assert (va is None) == (vb is None), k
            if va is not None:
                np.testing.assert_array_equal(va, vb, err_msg=k)
        assert a.y == b.y


@pytest.mark.parametrize("name,feat_str", [
    ("SYNNCI", "deg+odeg100"), ("SYNNCI", "deg+odeg10"), ("SYNNCI", "deg+odeg100+ak3"),
    ("SYNNCI", "deg+odeg100+renonself"), ("SYNNCI", "deg+odeg10+groupd2+reall"),
    ("SYNNCI", "deg+odeg100+randa0.1+randd0.2"), ("SYNREDDIT", "deg+odeg10")])
def test_tu_dataset_matches_jax(tu_root, name, feat_str):
    """Same HostGraphs as cal_tpu's TUDataset + FeatureExpander, from the raw
    files and again from the port's own cache file."""
    ref = jax_get_dataset(name, feat_str=feat_str, root=tu_root)
    ours = get_dataset(name, feat_str=feat_str, root=tu_root)
    _assert_same_graphs(ours, ref)
    assert ours.num_features == ref.num_features
    processed = os.path.join(tu_root, name, "processed")
    assert os.path.exists(os.path.join(processed, f"torch_data_{feat_str}.pkl"))
    with mock.patch.object(type(ours), "_process", side_effect=AssertionError("not cached")):
        _assert_same_graphs(get_dataset(name, feat_str=feat_str, root=tu_root), ref)


def test_missing_raw_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="gen_reddit_synthetic"):
        get_dataset("SYNREDDIT", feat_str="deg+odeg10", root=str(tmp_path))


def test_kfold_and_grammar_match_jax():
    rng = np.random.default_rng(0)
    labels = rng.choice([5, 1, 3], size=97, p=[0.5, 0.3, 0.2])   # first occurrence not sorted
    for folds in (2, 5, 10):
        for select in ("test_max", "val_max"):
            for a, b in zip(k_fold(labels, folds, select), jax_k_fold(labels, folds, select),
                            strict=True):
                for x, y in zip(a, b, strict=True):
                    np.testing.assert_array_equal(x, y)
    for fs in ("deg+odeg100", "deg+odeg10+ak3", "deg+an3+groupd2+reall", "odeg10+renonself",
               "deg+randa0.05+randd0.1", "deg+cent", "coord+ak1", ""):
        assert parse_feat_str(fs) == jax_parse_feat_str(fs), fs
    names = ["NCI1", "REDDIT-BINARY", "SYNREDDIT", "DD", "SYNDD", "MUTAG"]
    strs = ("deg+odeg100", "deg+odeg100+ak3")
    assert create_n_filter_triples(names, strs) == jax_triples(names, strs)


def test_train_causal_real_matches_jax(tu_root):
    """CausalGCN, 2 folds x 2 epochs, f32, no intervention shuffle: each fold
    starts from cal_tpu's initial weights; per-epoch losses agree within
    1e-4 and the protocol's result is equal."""
    kw = dict(model="CausalGCN", folds=2, epochs=2, batch_size=8, hidden=16, layers=1,
              lr=0.01, with_random=False, seed=3, dataset="SYNNCI")
    jdata = jax_get_dataset("SYNNCI", feat_str="deg+odeg100", root=tu_root)
    inits, losses = [], []
    real_init, real_epoch = jax_train_mod.init_state, jax_train_mod._run_epoch

    def record_init(*a, **k):
        st = real_init(*a, **k)
        inits.append((jax.tree.map(np.asarray, st.params),
                      jax.tree.map(np.asarray, st.batch_stats)))
        return st

    def record_epoch(*a, **k):
        state, m = real_epoch(*a, **k)
        losses.append(m[0])
        return state, m

    with mock.patch.object(jax_train_mod, "init_state", record_init), \
            mock.patch.object(jax_train_mod, "_run_epoch", record_epoch):
        ref = jax_train_mod.train_causal_real(
            jdata, jdata.num_classes, JaxConfig(scan_epochs=False, **kw), verbose=False)
    assert len(inits) == 2 and len(losses) == 4
    queue = list(inits)

    def jax_weights(cfg, num_features, num_classes):
        params, stats = queue.pop(0)
        m = CausalGNN(num_features, cfg.hidden, num_classes, num_layers=cfg.layers,
                      with_random=cfg.with_random)
        m.load_state_dict(params_from_jax(params, stats))
        return m

    data = get_dataset("SYNNCI", feat_str="deg+odeg100", root=tu_root)
    with mock.patch.object(steps_mod, "get_model", jax_weights):
        res = train_causal_real(data, data.num_classes, Config(device="cpu", **kw),
                                verbose=False)
    assert not queue
    np.testing.assert_allclose([h["loss"] for h in res["history"]], losses, rtol=1e-4)
    assert [(h["fold"], h["epoch"]) for h in res["history"]] == [(0, 1), (0, 2), (1, 1), (1, 2)]
    for k, v in ref.items():
        assert res[k] == pytest.approx(v, abs=1e-12), k


def _big_graphs(seed=0, feat=6):
    """Two graphs that pad to N = 384 with sparse edges (duplicates and a
    self loop): cal_tpu's and the port's GAT convs take the edge kernel."""
    rng = np.random.default_rng(seed)
    out = []
    for n, e in ((384, 300), (250, 220)):
        s = rng.integers(0, n, e).astype(np.int32)
        r = rng.integers(0, n, e).astype(np.int32)
        s[:2], r[:2] = s[2:4], r[2:4]
        r[5] = s[5]
        s, r = np.concatenate([s, r]), np.concatenate([r, s])
        x = rng.standard_normal((n, feat)).astype(np.float32)
        out.append((x, s, r, int(rng.integers(CLASSES))))
    return ([JaxHostGraph(x=x, senders=s, receivers=r, y=y) for x, s, r, y in out],
            [HostGraph(x=x, senders=s, receivers=r, y=y) for x, s, r, y in out])


def test_causal_gat_at_n384_matches_jax():
    """Dense CausalGAT at N = 384 (B = 2, hidden 16, f32, attention dropout 0)
    with the flax weights carried across: log-probs and one train step's
    gradients agree within 1e-4, and both packages ran the edge kernel."""
    jg, tg = _big_graphs()
    (jb, tb), = _batches(jg, tg, 2)
    assert jb.x.shape[1] == 384 and tb.eg_budget == 600
    g_j = _as_graph(to_device(jb))
    jm, variables, tm = _models("float32", g_j, 6, backbone="gat", gat_dropout=0.0)
    edge_j = mock.patch.object(jax_edge_mod, "edge_gat_dense", wraps=jax_edge_mod.edge_gat_dense)
    edge_t = mock.patch.object(layers_mod, "edge_gat_dense_flat",
                               wraps=layers_mod.edge_gat_dense_flat)
    with edge_j as spy_j, edge_t as spy_t:
        ref = jm.apply(variables, g_j, eval_random=False, train=False)
        assert spy_j.call_count >= 1
        with torch.no_grad():
            ours = tm(to_dense(tb.to("cpu"), tm.dtype), eval_random=False, train=False)
        assert spy_t.call_count == len([m for m in tm.modules() if hasattr(m, "att")])
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
        jstate = JaxTrainState(params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=jax_make_optimizer(LR, MIN_LR, EPOCHS, 1, WD).init(
                                   variables["params"]), step=jnp.zeros((), jnp.int32))
        ref_grads = _jax_grads(jm, jstate, jb)
        state = TrainState(tm.train(), make_optimizer(tm.parameters(), WD))
        make_causal_train_step(state, cosine_lr(LR, MIN_LR, EPOCHS, 1), C_W, O_W, CO_W,
                               False, seed=0)(tb, None)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert np.abs(ref_grads["convs_0.att"]).max() > 0


@pytest.mark.parametrize("case", ["folds1", "fold_parallel", "ogbg", "cent"])
def test_unported_options_raise(tu_root, case):
    base = ["--model", "CausalGCN", "--dataset", "SYNNCI", "--data_root", tu_root,
            "--device", "cpu", "--epochs", "1", "--hidden", "16"]
    if case == "folds1":
        with pytest.raises(ValueError, match="folds"):
            main(base + ["--folds", "1"])
    elif case == "fold_parallel":
        with pytest.raises(NotImplementedError, match="item 8d"):
            main(base + ["--folds", "2", "--fold_parallel", "true"])
    elif case == "ogbg":
        with pytest.raises(NotImplementedError, match="item 8b"):
            main(base[:3] + ["ogbg-molhiv"] + base[4:])
    else:
        with pytest.raises(NotImplementedError, match="item 8c"):
            get_dataset("SYNNCI", feat_str="deg+cent", root=tu_root)


def test_main_real_cpu_end_to_end(tu_root, capsys):
    res = main(["--model", "CausalGAT", "--dataset", "SYNREDDIT", "--data_root", tu_root,
                "--device", "cpu", "--folds", "2", "--epochs", "1", "--hidden", "16",
                "--batch_size", "4"])
    out = capsys.readouterr().out
    assert "SYNREDDIT(16): 13 features, 2 classes" in out
    assert out.count("syd: Causal fold:") == 2 and "sydall Final: Causal" in out
    assert len(res["history"]) == 2 and 0.0 <= res["test_acc_mean"] <= 1.0
    assert all(np.isfinite(h["loss"]) for h in res["history"])
