"""The port's device-side epoch on the CPU (``--scan_epochs true``): the
trainers against cal_tpu's scanned epochs (dense and sparse), against the
port's own per-step loop (bit for bit) on both layouts, every model, the
packed real-data protocol and a dense GAT on the edge kernel, the serving
sweep through the eval epoch against the per-batch sweep, the epoch
prefetcher (the loader's shuffle stream, a producer's exception, no epoch
past the count, the threads joined), and the flash kernel's seed buffer
against the int seed.

Small sizes (hidden 32, 2 layers, batch 16, 2-3 epochs); cal_tpu's trainers
run their scanned epochs with the Pallas kernels in interpret mode, the
port's wrappers take their plain twins.  The CUDA graphs themselves run only
on the card (chip_smoke.py's captured-epoch phase)."""
import json
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch
from test_torch_port_gin import _from_init, _record_init, _tiny_split

import cal_tpu.train.baseline as jax_baseline_mod
import cal_tpu.train.causal as jax_causal_mod
import cal_tpu_torch.train.steps as steps_mod
from cal_tpu.train.baseline import train_baseline_syn as jax_train_baseline_syn
from cal_tpu.train.causal import train_causal_syn as jax_train_causal_syn
from cal_tpu.utils.config import Config as JaxConfig
from cal_tpu_torch.data.loader import Loader, compute_budgets
from cal_tpu_torch.ops.flash_gat import (
    dropout_keep,
    flash_gat_bwd_plain,
    flash_gat_fwd_plain,
    seed_buffer,
    seed_value,
)
from cal_tpu_torch.train.baseline import train_baseline_syn
from cal_tpu_torch.graph import HostGraph
from cal_tpu_torch.train.causal import (
    _EpochPrefetcher,
    _epoch_prefetcher,
    evaluate_causal,
    train_causal_real,
    train_causal_syn,
)
from cal_tpu_torch.train.graphs import launch_counters
from cal_tpu_torch.train.optim import make_optimizer, set_lr
from cal_tpu_torch.train.steps import StackedBatches, stack_batches_host
from cal_tpu_torch.utils.config import Config

SMALL = dict(epochs=3, batch_size=16, hidden=32, layers=2, lr=0.01, seed=3)


def _causal_jax_weights(init):
    from cal_tpu_torch.models.causal import CausalGNN
    from cal_tpu_torch.utils.checkpoint import params_from_jax

    def build(cfg, num_features, num_classes):
        m = CausalGNN(num_features, cfg.hidden, num_classes, num_layers=cfg.layers,
                      with_random=cfg.with_random)
        m.load_state_dict(params_from_jax(init["params"], init["stats"]))
        return m

    return build


def test_train_causal_syn_scan_matches_jax_scan(tmp_path):
    """Dense CausalGCN, f32, without the intervention shuffle (whose PRNG
    differs between the packages), from cal_tpu's initial weights: the
    port's device-side epoch against cal_tpu's scanned epoch, per-epoch
    losses within 1e-4 (test_torch_port_train's tolerance) and the same
    selection."""
    kw = dict(model="CausalGCN", with_random=False, **SMALL)
    jtrain, jval, jtest = _tiny_split("jax")
    init, patch = _record_init(jax_causal_mod)
    with patch:
        ref = jax_train_causal_syn(jtrain, jval, jtest, JaxConfig(
            scan_epochs=True, metrics_path=str(tmp_path / "jax.jsonl"), **kw), verbose=False)
    ref_losses = [r["loss"] for r in map(json.loads, open(tmp_path / "jax.jsonl"))
                  if r["event"] == "epoch"]
    train, val, test = _tiny_split("torch")
    with mock.patch.object(steps_mod, "get_model", _causal_jax_weights(init)):
        res = train_causal_syn(train, val, test, Config(device="cpu", scan_epochs=True, **kw),
                               verbose=False)
    np.testing.assert_allclose([h["loss"] for h in res["history"]], ref_losses, rtol=1e-4)
    for k in ("best_val_acc", "test_acc_co", "test_acc_c", "test_acc_o", "epoch"):
        assert res[k] == pytest.approx(ref[k], abs=1e-12), k


def test_train_baseline_syn_scan_matches_jax_scan():
    """The dense GCN baseline, f32, from cal_tpu's initial weights: the
    port's device-side epoch against cal_tpu's scanned epoch, per-epoch
    losses within 1e-4 and the same selection.  At batch 32, as
    test_torch_port_gin's baseline trainer comparison: at batch 16 and lr
    0.01 the two packages' rounding parts the third epoch's loss by 1.1e-3
    (relative), with the port's per-step loop as with its epoch, and
    cal_tpu's per-step loop as with its scan."""
    kw = dict(model="GCN", **{**SMALL, "batch_size": 32})
    jtrain, jval, jtest = _tiny_split("jax")
    init, patch = _record_init(jax_baseline_mod)
    losses = []
    real_epoch = jax_baseline_mod._run_epoch_scan

    def run_epoch(*a):
        out = real_epoch(*a)
        losses.append(out[1])
        return out

    with patch, mock.patch.object(jax_baseline_mod, "_run_epoch_scan", run_epoch):
        ref = jax_train_baseline_syn(jtrain, jval, jtest, JaxConfig(scan_epochs=True, **kw),
                                     verbose=False)
    train, val, test = _tiny_split("torch")
    with mock.patch.object(steps_mod, "get_model", _from_init(init, "GCN")):
        res = train_baseline_syn(train, val, test, Config(device="cpu", scan_epochs=True, **kw),
                                 verbose=False)
    assert len(losses) == SMALL["epochs"]
    np.testing.assert_allclose([h["loss"] for h in res["history"]], losses, rtol=1e-4)
    for k in ("best_val_acc", "test_acc", "epoch"):
        assert res[k] == pytest.approx(ref[k], abs=1e-12), k


@pytest.fixture
def one_thread():
    """Tiny CPU training in one intra-op thread: at these sizes more threads
    only add barriers, which test workers sharing the cores stretch from
    seconds into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _without_seconds(history):
    return [{k: v for k, v in h.items() if "seconds" not in k} for h in history]


@pytest.mark.parametrize("model", ["CausalGCN", "CausalGAT", "GCN", "GAT"])
def test_scan_equals_per_step_loop(model, one_thread):
    """``scan_epochs`` true and false give the same history and selection,
    bit for bit (the same steps in the same order with the same seeds; the
    intervention shuffle and the GAT dropouts on)."""
    train, val, test = _tiny_split("torch")
    kw = dict(model=model, device="cpu", **SMALL)
    fn = train_baseline_syn if model in ("GCN", "GAT") else train_causal_syn
    on = fn(train, val, test, Config(scan_epochs=True, **kw), verbose=False)
    off = fn(train, val, test, Config(scan_epochs=False, **kw), verbose=False)
    assert _without_seconds(on["history"]) == _without_seconds(off["history"])
    assert {k: v for k, v in on.items() if k != "history"} == {
        k: v for k, v in off.items() if k != "history"}


def test_real_protocol_scan_equals_per_step_loop(one_thread):
    """``train_causal_real`` (2 folds x 2 epochs, dense CausalGCN) with and
    without the device-side epoch: the same per-fold history, bit for bit."""
    train, val, test = _tiny_split("torch")
    graphs = list(train) + list(val) + list(test)
    kw = dict(model="CausalGCN", device="cpu", folds=2, epochs=2, batch_size=16, hidden=32,
              layers=2, lr=0.01, seed=3)
    on = train_causal_real(graphs, 4, Config(scan_epochs=True, **kw), verbose=False)
    off = train_causal_real(graphs, 4, Config(scan_epochs=False, **kw), verbose=False)
    assert _without_seconds(on["history"]) == _without_seconds(off["history"])


def _loader(seed=7):
    train, _, _ = _tiny_split("torch")
    return Loader(train, 16, shuffle=True, budgets=compute_budgets(train, 16), seed=seed)


def _same_stack(a: StackedBatches, b: StackedBatches):
    for x, y in zip(a.leaves(), b.leaves()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(a.real, b.real)
    assert a.batch.eg_budget == b.batch.eg_budget


def test_prefetcher_yields_the_loaders_shuffle_stream():
    """Each prefetched epoch is the stack of the next epoch of a twin
    loader's own stream (same seed), in order; then the producers stop."""
    twin = _loader()
    pf = _EpochPrefetcher(_loader(), torch.device("cpu"), epochs=3, timeout=60)
    try:
        epochs = [pf.next() for _ in range(3)]
    finally:
        pf.close()
    for got in epochs:
        _same_stack(got, stack_batches_host(list(twin.host_batches())))
    assert not any(np.array_equal(np.asarray(epochs[0].batch.y), np.asarray(e.batch.y))
                   for e in epochs[1:])


def test_prefetcher_reraises_a_producer_exception():
    """A failing ``host_batches`` reaches ``next`` as an exception (its
    cause), within the timeout, instead of a hang."""
    loader = _loader()
    real = loader.host_batches
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("packer broke")
        return real()

    loader.host_batches = flaky
    pf = _EpochPrefetcher(loader, torch.device("cpu"), epochs=3, timeout=30)
    try:
        assert isinstance(pf.next(), StackedBatches)
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="prefetcher failed") as err:
            pf.next()
        assert isinstance(err.value.__cause__, ValueError)
        assert time.perf_counter() - t0 < 30
    finally:
        pf.close()


def test_prefetcher_packs_no_epoch_past_the_count_and_joins_its_threads():
    """With ``epochs`` 2 the loader is asked for exactly 2 epochs, however
    long the consumer waits; ``close`` leaves no producer thread alive, and
    a new prefetcher on the loader closes the one it held."""
    loader = _loader()
    real = loader.host_batches
    calls = []

    def counted():
        calls.append(1)
        return real()

    loader.host_batches = counted
    pf = _epoch_prefetcher(loader, torch.device("cpu"), 2)
    pf.next()
    pf.next()
    time.sleep(0.5)
    assert len(calls) == 2
    with pytest.raises(TimeoutError):
        pf.timeout = 0.3
        pf.next()
    second = _epoch_prefetcher(loader, torch.device("cpu"), 1)
    assert all(not t.is_alive() for t in pf.threads)
    second.next()
    second.close()
    assert all(not t.is_alive() for t in second.threads)
    assert len(calls) == 3


def test_prefetcher_close_mid_epoch_stops_both_threads():
    """``close`` while both queues are full (the consumer never read)
    stops both producers."""
    pf = _EpochPrefetcher(_loader(), torch.device("cpu"), epochs=50, timeout=60)
    deadline = time.time() + 30
    while pf._q.empty() and time.time() < deadline:
        time.sleep(0.01)
    pf.close(timeout=30)
    assert all(not t.is_alive() for t in pf.threads)
    assert threading.active_count() >= 1


@pytest.mark.parametrize("model", ["CausalGCN", "CausalGIN", "CausalGAT", "GCN", "GIN", "GAT"])
def test_sparse_scan_equals_per_step_loop(model, one_thread):
    """On the sparse layout, ``scan_epochs`` true and false give the same
    history and selection, bit for bit, for every model (the intervention
    shuffle and the GAT dropouts on)."""
    train, val, test = _tiny_split("torch")
    kw = dict(model=model, device="cpu", layout="sparse", **SMALL)
    fn = train_baseline_syn if model in ("GCN", "GIN", "GAT") else train_causal_syn
    on = fn(train, val, test, Config(scan_epochs=True, **kw), verbose=False)
    off = fn(train, val, test, Config(scan_epochs=False, **kw), verbose=False)
    assert _without_seconds(on["history"]) == _without_seconds(off["history"])
    assert {k: v for k, v in on.items() if k != "history"} == {
        k: v for k, v in off.items() if k != "history"}


def test_packed_real_protocol_scan_equals_per_step_loop(one_thread):
    """``train_causal_real`` on packed sparse batches (2 folds x 2 epochs,
    CausalGCN): the device-side epoch, whose stacks end with pad batches
    that it skips on the host, against the per-step loop, bit for bit."""
    train, val, test = _tiny_split("torch")
    graphs = list(train) + list(val) + list(test)
    kw = dict(model="CausalGCN", device="cpu", folds=2, epochs=2, batch_size=16, hidden=32,
              layers=2, lr=0.01, seed=3, layout="sparse", pack_batches="true")
    stacks = []
    with mock.patch("cal_tpu_torch.train.causal.stack_batches_host",
                    side_effect=lambda b: stacks.append(stack_batches_host(b)) or stacks[-1]):
        on = train_causal_real(graphs, 4, Config(scan_epochs=True, **kw), verbose=False)
    off = train_causal_real(graphs, 4, Config(scan_epochs=False, **kw), verbose=False)
    assert _without_seconds(on["history"]) == _without_seconds(off["history"])
    assert any(not st.real.all() for st in stacks)


def _edge_gat_graphs(count=6, seed=0, feat=6):
    """Graphs that pad to N = 384 with sparse edges (a duplicate and a self
    loop each): a dense GAT's convs take the edge kernel."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = 384 if i % 3 == 0 else int(rng.integers(100, 384))
        e = int(rng.integers(n // 2, n))
        s, r = rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32)
        s[:2], r[:2] = s[2:4], r[2:4]
        r[5] = s[5]
        out.append(HostGraph(x=rng.standard_normal((n, feat)).astype(np.float32),
                             senders=np.concatenate([s, r]), receivers=np.concatenate([r, s]),
                             y=int(rng.integers(2))))
    return out


def test_dense_edge_gat_scan_equals_per_step_loop(one_thread):
    """Dense CausalGAT at N = 384, its convs on the edge kernel (the batch's
    EdgeIndex built inside each step): the device-side epoch against the
    per-step loop, bit for bit, attention dropout on."""
    import cal_tpu_torch.nn.layers as layers_mod

    graphs = _edge_gat_graphs(12)
    kw = dict(model="CausalGAT", device="cpu", epochs=2, batch_size=4, hidden=16, layers=1,
              lr=0.01, seed=3, num_classes=2)
    spy = mock.patch.object(layers_mod, "edge_gat_dense_flat",
                            wraps=layers_mod.edge_gat_dense_flat)
    with spy as edge:
        on = train_causal_syn(graphs[:6], graphs[6:9], graphs[9:],
                              Config(scan_epochs=True, **kw), verbose=False)
    assert edge.call_count > 0
    off = train_causal_syn(graphs[:6], graphs[6:9], graphs[9:],
                           Config(scan_epochs=False, **kw), verbose=False)
    assert _without_seconds(on["history"]) == _without_seconds(off["history"])
    assert {k: v for k, v in on.items() if k != "history"} == {
        k: v for k, v in off.items() if k != "history"}


def test_train_causal_syn_sparse_scan_matches_jax_scan(tmp_path):
    """Sparse CausalGCN, f32, without the intervention shuffle, from
    cal_tpu's initial weights: the port's device-side epoch against
    cal_tpu's scanned sparse epoch (its node budget below 2048, so without
    tile plans), per-epoch losses within 1e-4 and the same selection."""
    kw = dict(model="CausalGCN", with_random=False, layout="sparse", **SMALL)
    jtrain, jval, jtest = _tiny_split("jax")
    init, patch = _record_init(jax_causal_mod)
    with patch:
        ref = jax_train_causal_syn(jtrain, jval, jtest, JaxConfig(
            scan_epochs=True, metrics_path=str(tmp_path / "jax.jsonl"), **kw), verbose=False)
    ref_losses = [r["loss"] for r in map(json.loads, open(tmp_path / "jax.jsonl"))
                  if r["event"] == "epoch"]
    train, val, test = _tiny_split("torch")
    budgets = compute_budgets(list(train) + list(val) + list(test), SMALL["batch_size"],
                              "sparse")
    assert budgets["node_budget"] < 2048
    with mock.patch.object(steps_mod, "get_model", _causal_jax_weights(init)):
        res = train_causal_syn(train, val, test, Config(device="cpu", scan_epochs=True, **kw),
                               verbose=False)
    np.testing.assert_allclose([h["loss"] for h in res["history"]], ref_losses, rtol=1e-4)
    for k in ("best_val_acc", "test_acc_co", "test_acc_c", "test_acc_o", "epoch"):
        assert res[k] == pytest.approx(ref[k], abs=1e-12), k


@pytest.mark.parametrize("model,layout,pack", [("CausalGCN", "dense", "auto"),
                                               ("CausalGAT", "sparse", "auto"),
                                               ("CausalGIN", "sparse", "true")])
def test_evaluate_causal_eval_epoch_equals_per_batch_sweep(model, layout, pack, tmp_path,
                                                           one_thread):
    """Serving a checkpoint (``evaluate_causal``) through the eval epoch
    over the test set's stack (``--scan_epochs true``) gives the per-batch
    sweep's accuracies and graph count, with the intervention on."""
    from cal_tpu_torch.models.factory import get_model
    from cal_tpu_torch.utils.checkpoint import Checkpointer

    _, _, test = _tiny_split("torch")
    cfg = Config(model=model, device="cpu", layout=layout, pack_batches=pack, batch_size=16,
                 hidden=32, layers=2, seed=3, eval_random=True, save_dir=str(tmp_path))
    Checkpointer(str(tmp_path)).save(1, get_model(cfg, test[0].x.shape[1], cfg.num_classes),
                                     {"epoch": 1})
    on = evaluate_causal(test, cfg.replace(scan_epochs=True))
    off = evaluate_causal(test, cfg.replace(scan_epochs=False))
    assert on["graphs"] == off["graphs"] == len(test)
    for k in ("test_acc_co", "test_acc_c", "test_acc_o", "ckpt_step"):
        assert on[k] == off[k], k


@pytest.mark.parametrize("seed", [0, 0x9E3779B97F4A7C15, 2**63 - 1, 2**64 - 1, 12345])
def test_seed_buffer_draws_the_int_seeds_keep_mask(seed):
    """A seed buffer holds the seed's 64 bits (low word first, as the kernel
    reads it), and the flash twins draw the same keep mask, forward and
    backward, from the buffer as from the int."""
    buf = seed_buffer(seed)
    assert buf.dtype == torch.int64 and buf.numel() == 1
    words = buf.numpy().view(np.uint32)
    assert (int(words[0]), int(words[1])) == (seed & 0xFFFFFFFF, seed >> 32)
    assert seed_value(buf) == seed
    torch.testing.assert_close(dropout_keep(seed_value(buf), 2, 2, 8, 0.2),
                               dropout_keep(seed, 2, 2, 8, 0.2), rtol=0, atol=0)
    gen = torch.Generator().manual_seed(seed % 1000)
    ti, tj = (torch.randn(2, 8, 2, generator=gen) for _ in range(2))
    counts = (torch.rand(2, 8, 8, generator=gen) < 0.4).float()
    xh = torch.randn(2, 8, 2 * 4, generator=gen)
    out_i, m, den = flash_gat_fwd_plain(ti, tj, counts, xh, seed, 0.2)
    out_b, _, _ = flash_gat_fwd_plain(ti, tj, counts, xh, buf, 0.2)
    torch.testing.assert_close(out_b, out_i, rtol=0, atol=0)
    g = torch.randn(out_i.shape, generator=gen)
    for a, b in zip(flash_gat_bwd_plain(ti, tj, counts, xh, m, den, g, seed, 0.2),
                    flash_gat_bwd_plain(ti, tj, counts, xh, m, den, g, buf, 0.2)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_cpu_optimizer_keeps_a_float_rate():
    """On the CPU Adam is not capturable and its rate is a float; a state
    restored with a tensor rate goes back to a float at the next step."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([p])
    assert not opt.param_groups[0]["capturable"]
    set_lr(opt, 0.5)
    assert opt.param_groups[0]["lr"] == 0.5
    opt.param_groups[0]["lr"] = torch.tensor(0.1)
    set_lr(opt, 0.25)
    assert opt.param_groups[0]["lr"] == 0.25


def test_launch_counters_cover_every_kernel_wrapper():
    """The counters a CUDA-graph replay adds to are every kernel wrapper
    with a ``.launches`` count, the dense training path's among them."""
    names = {f.__name__ for f in launch_counters()}
    assert {"adj_build", "fused_gcn_dense_att_dual", "fused_gcn_dense_att_dual_bwd",
            "flash_gat_fwd", "flash_gat_bwd", "edge_gat_fwd", "segment_pool",
            "coo_sddmm", "pair_coef_spmm"} <= names
    assert all(isinstance(f.launches, int) for f in launch_counters())
