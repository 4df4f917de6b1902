"""The port's training path (losses, schedule, train step, train_causal_syn,
save/serve/resume) against the JAX package on the CPU.

Small sizes (hidden 16, 1-2 layers, N <= 32); the JAX Pallas kernels run in
interpret mode, the port's wrappers take their plain twins.  Weights are
carried across with ``params_from_jax``; multi-step parity runs without the
intervention shuffle, whose PRNG differs between the packages (one test
injects the JAX permutation instead)."""
import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_model import CLASSES, _batches, _graphs, _models

import cal_tpu.models.causal as jax_causal_mod
import cal_tpu_torch.models.causal as causal_mod
import cal_tpu_torch.ops.fused_gcn as fused_mod
import cal_tpu_torch.train.steps as steps_mod
from cal_tpu.data.synthetic import dataset_bias_split as jax_split
from cal_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from cal_tpu.train.causal import _make_mesh_and_loaders
from cal_tpu.train.causal import train_causal_syn as jax_train_causal_syn
from cal_tpu.train.losses import causal_losses as jax_causal_losses
from cal_tpu.train.optim import cosine_lr as jax_cosine_lr
from cal_tpu.train.optim import make_optimizer as jax_make_optimizer
from cal_tpu.train.steps import TrainState as JaxTrainState
from cal_tpu.train.steps import _as_graph, _causal_step_fn, make_causal_train_step, to_device
from cal_tpu.utils.config import Config as JaxConfig
from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
from cal_tpu_torch.main_syn import main
from cal_tpu_torch.models.causal import CausalGNN
from cal_tpu_torch.train.causal import make_loaders, train_causal_syn
from cal_tpu_torch.train.losses import causal_losses
from cal_tpu_torch.train.optim import cosine_lr, make_optimizer
from cal_tpu_torch.train.steps import TrainState, make_causal_train_step as port_train_step
from cal_tpu_torch.utils.checkpoint import Checkpointer, params_from_jax
from cal_tpu_torch.utils.config import Config

C_W, O_W, CO_W = 0.5, 1.0, 0.5
LR, MIN_LR, EPOCHS, WD = 1e-3, 1e-5, 2, 1e-3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def test_causal_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 8, CLASSES)).astype(np.float32)
    logs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    y = rng.integers(0, CLASSES, 8).astype(np.int32)
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], bool)
    ref_total, ref_parts = jax_causal_losses(*(jnp.asarray(a) for a in logs), jnp.asarray(y),
                                             jnp.asarray(mask), C_W, O_W, CO_W)
    total, parts = causal_losses(*(torch.from_numpy(a) for a in logs), torch.from_numpy(y),
                                 torch.from_numpy(mask), C_W, O_W, CO_W)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-6)
    np.testing.assert_allclose([float(p) for p in parts], [float(p) for p in ref_parts],
                               rtol=1e-6)


def test_cosine_schedule_matches_jax():
    """Per-step learning rate for E=5 epochs of 3 steps, and past the end."""
    ours = cosine_lr(0.002, 5e-6, 5, 3)
    ref = jax_cosine_lr(0.002, 5e-6, 5, 3)
    counts = range(0, 6 * 3 + 2)
    np.testing.assert_allclose([ours(c) for c in counts],
                               [float(ref(jnp.asarray(c, jnp.int32))) for c in counts],
                               rtol=1e-6)
    assert ours(0) == 0.002 and ours(3) < ours(2) and ours(15) == ours(20) == 5e-6


def _setup(dtype, with_random=False):
    """JAX and port models with the same (perturbed) weights, the same host
    batches (three of four graphs), and each package's optimizer and train
    step."""
    jg, tg = _graphs(count=10)
    pairs = _batches(jg, tg, 4)
    g0 = _as_graph(to_device(pairs[0][0]), jnp.bfloat16 if dtype == "bfloat16" else None)
    jm, variables, tm = _models(dtype, g0, 6)
    tx = jax_make_optimizer(LR, MIN_LR, EPOCHS, len(pairs), WD)
    jstate = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32))
    state = TrainState(tm, make_optimizer(tm.parameters(), WD))
    step = port_train_step(state, cosine_lr(LR, MIN_LR, EPOCHS, len(pairs)), C_W, O_W, CO_W,
                           with_random, seed=0)
    return pairs, jm, tx, jstate, state, step


def _jax_grads(jm, jstate, jbatch):
    g = _as_graph(to_device(jbatch), jm.dtype if jm.dtype != jnp.float32 else None)
    key = jax.random.PRNGKey(0)

    def loss_fn(params):
        (c, o, co), _ = jm.apply({"params": params, "batch_stats": jstate.batch_stats}, g,
                                 eval_random=False, train=True,
                                 rngs={"intervention": key, "dropout": key},
                                 mutable=["batch_stats"])
        return jax_causal_losses(c, o, co, g.y, g.graph_mask, C_W, O_W, CO_W)[0]

    return _flat(jax.jit(jax.grad(loss_fn))(jstate.params))


def test_train_steps_match_jax_f32():
    """Step-1 gradients name by name, the per-step losses of three steps, and
    parameters and BatchNorm running stats after them (Adam with L2)."""
    pairs, jm, tx, jstate, state, step = _setup("float32")
    assert len(pairs) == 3
    jstep = make_causal_train_step(jm, tx, C_W, O_W, CO_W, False)
    ref_grads = _jax_grads(jm, jstate, pairs[0][0])
    rng = jax.random.PRNGKey(0)
    for i, (jb, tb) in enumerate(pairs):
        jstate, jm_out = jstep(jstate, to_device(jb), rng)
        ours = step(tb, None)
        if i == 0:
            # the gfn projection's bias is unused: a zero gradient in both
            assert not ref_grads["conv_feat.bias"].any()
            for name, p in state.model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), ref_grads[name], rtol=1e-4,
                                           atol=1e-5, err_msg=name)
        np.testing.assert_allclose(
            ours.numpy(), [float(jm_out[k]) for k in
                           ("loss", "loss_c", "loss_o", "loss_co", "correct_o", "n")],
            rtol=1e-5, err_msg=f"step {i}")
    assert state.step == int(jstate.step) == 3
    # Adam's first updates are ~lr * sign(g): an entry whose gradient sits at
    # the rounding-noise floor in both packages may move by up to 2 lr a step
    # in opposite directions (3 steps: 6 lr); every other entry agrees to f32
    # sums' order (measured: all but one of 2652 entries within 1e-5).
    ref_p, ref_s = _flat(jstate.params), _flat(jstate.batch_stats)
    diffs = []
    for name, p in state.model.named_parameters():
        d = np.abs(p.detach().numpy() - ref_p[name])
        assert d.max() <= 6 * LR, name
        diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert np.mean(diffs <= 1e-5) >= 0.999, np.sort(diffs)[-20:]
    for name, b in state.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref_s[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_train_step_matches_jax_bf16():
    """One bf16 step: the per-batch loss sums within 5e-2 (bf16 rounds at other
    points in XLA and PyTorch; tests/test_torch_port_model.py FWD_TOL)."""
    pairs, jm, tx, jstate, state, step = _setup("bfloat16")
    jstep = make_causal_train_step(jm, tx, C_W, O_W, CO_W, False)
    _, jm_out = jstep(jstate, to_device(pairs[0][0]), jax.random.PRNGKey(0))
    ours = step(pairs[0][1], None)
    assert torch.isfinite(ours).all()
    np.testing.assert_allclose(ours[:4].numpy(),
                               [float(jm_out[k]) for k in ("loss", "loss_c", "loss_o", "loss_co")],
                               rtol=5e-2, atol=5e-2)


def test_train_step_with_injected_intervention_matches_jax():
    """with_random=True: the JAX step's own permutation (recorded from its
    un-jitted step) is injected into the port; the losses agree at f32."""
    pairs, jm, tx, jstate, state, step = _setup("float32", with_random=True)
    jb, tb = pairs[0]
    seen = []
    real_perm = jax_causal_mod.intervention_permutation

    def record(rng, gm):
        perm = real_perm(rng, gm)
        seen.append(np.asarray(perm))
        return perm

    with mock.patch.object(jax_causal_mod, "intervention_permutation", record):
        _, jm_out = _causal_step_fn(jm, tx, C_W, O_W, CO_W, True)(
            jstate, to_device(jb), jax.random.PRNGKey(3))
    assert len(seen) == 1
    perm = seen[0]
    assert not np.array_equal(perm, np.arange(len(perm)))    # a real shuffle
    with mock.patch.object(causal_mod, "intervention_permutation",
                           lambda gen, gm: torch.tensor(perm, dtype=torch.long)):
        ours = step(tb, None)
    np.testing.assert_allclose(
        ours.numpy(), [float(jm_out[k]) for k in
                       ("loss", "loss_c", "loss_o", "loss_co", "correct_o", "n")], rtol=1e-5)


def test_step_skips_a_batch_without_real_graphs():
    """A batch of padded slots only is skipped on the host (the JAX
    ``_gate_state``): no update, the step count and the sums unchanged."""
    pairs, _, _, _, state, step = _setup("float32")
    tb = pairs[0][1]
    empty = dataclasses.replace(tb, n_nodes=np.zeros_like(tb.n_nodes))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    sums = torch.arange(6.0)
    assert step(empty, sums) is sums and step(empty, None) is None
    assert state.step == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert step(tb, None) is not None and state.step == 1


def test_every_parameter_gets_a_gradient_through_the_backward_wrapper():
    """loss.backward() reaches the dual conv's backward wrapper and gives every
    parameter a finite, non-zero gradient (the gfn projection's bias is not
    used by the forward, in either package)."""
    pairs, jm, tx, jstate, state, step = _setup("float32", with_random=True)
    calls = []
    real = fused_mod.fused_gcn_dense_att_dual_bwd

    def spy(*args):
        calls.append(1)
        return real(*args)

    with mock.patch.object(fused_mod, "fused_gcn_dense_att_dual_bwd", spy):
        step(pairs[0][1], None)
    assert calls == [1]
    for name, p in state.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if name == "conv_feat.bias":
            assert not p.grad.any()
            continue
        assert p.grad.abs().max() > 0, name


def _tiny_split(pkg):
    gen, split = (jax_generate, jax_split) if pkg == "jax" else (
        generate_synthetic_dataset, dataset_bias_split)
    ds = gen(data_num=30, node_num=4, max_degree=6, seed=5)
    return split(ds, bias=0.7, total=120, seed=0)[:3]


def test_first_epoch_batches_match_jax_trainer():
    """The JAX trainer draws one shuffle before epoch 1 (init_state takes
    next(iter(train_loader))); the port draws and drops it too."""
    cfg = dict(batch_size=8, seed=7)
    jtrain, jval, jtest = _tiny_split("jax")
    _, (jl, _, _) = _make_mesh_and_loaders(
        JaxConfig(**cfg), [jtrain, jval, jtest], list(jtrain) + list(jval) + list(jtest),
        seeds=[7, 0, 0])
    next(iter(jl))
    ref = list(jl.host_batches())
    train, val, test = _tiny_split("torch")
    ours = list(make_loaders(train, val, test, Config(**cfg))[0].host_batches())
    assert len(ours) == len(ref) > 1
    for a, b in zip(ours, ref):
        for k in ("x", "edge_flat", "n_nodes", "y"):
            np.testing.assert_array_equal(getattr(a, k), np.asarray(getattr(b, k)), err_msg=k)
    # without the dropped draw the first epoch would differ
    from cal_tpu_torch.data.loader import Loader

    fresh = Loader(train, 8, shuffle=True, budgets=make_loaders(
        train, val, test, Config(**cfg))[0].budgets, seed=7)
    assert not np.array_equal(next(fresh.host_batches()).y, ref[0].y)


def test_train_causal_syn_matches_jax(tmp_path):
    """The whole trainer on the CPU, f32, without the intervention shuffle:
    the port starts from the JAX trainer's initial weights; per-epoch losses
    agree within 1e-4 and the selected accuracies and epoch are equal."""
    kw = dict(model="CausalGCN", epochs=4, batch_size=32, hidden=16, layers=1, lr=0.01,
              with_random=False, seed=3)
    jtrain, jval, jtest = _tiny_split("jax")
    init = {}
    import cal_tpu.train.causal as jax_train_mod

    real_init = jax_train_mod.init_state

    def record(*a, **k):
        st = real_init(*a, **k)
        init.update(params=jax.tree.map(np.asarray, st.params),
                    stats=jax.tree.map(np.asarray, st.batch_stats))
        return st

    with mock.patch.object(jax_train_mod, "init_state", record):
        ref = jax_train_causal_syn(jtrain, jval, jtest, JaxConfig(
            scan_epochs=False, metrics_path=str(tmp_path / "jax.jsonl"), **kw), verbose=False)
    ref_losses = [r["loss"] for r in map(json.loads, open(tmp_path / "jax.jsonl"))
                  if r["event"] == "epoch"]

    def jax_weights(cfg, num_features, num_classes):
        m = CausalGNN(num_features, cfg.hidden, num_classes, num_layers=cfg.layers,
                      with_random=cfg.with_random)
        m.load_state_dict(params_from_jax(init["params"], init["stats"]))
        return m

    train, val, test = _tiny_split("torch")
    with mock.patch.object(steps_mod, "get_model", jax_weights):
        res = train_causal_syn(train, val, test, Config(device="cpu", **kw), verbose=False)
    np.testing.assert_allclose([h["loss"] for h in res["history"]], ref_losses, rtol=1e-4)
    for k in ("best_val_acc", "test_acc_co", "test_acc_c", "test_acc_o", "epoch"):
        assert res[k] == pytest.approx(ref[k], abs=1e-12), k


def test_train_save_serve_resume(tmp_path, capsys):
    """--save_model then --inference reproduces the saved test accuracies;
    --resume continues at the epoch after the checkpoint, with its trackers."""
    argv = ["--model", "CausalGCN", "--device", "cpu", "--data_num", "30", "--node_num", "4",
            "--max_degree", "6", "--bias", "0.7", "--batch_size", "32", "--hidden", "16",
            "--layers", "1", "--lr", "0.01", "--seed", "5", "--save_dir", str(tmp_path)]
    res = main(argv + ["--epochs", "3", "--save_model", "true"])
    meta = Checkpointer(str(tmp_path)).restore(
        CausalGNN(6, 16, CLASSES, num_layers=1))
    assert meta["epoch"] == res["epoch"] >= 1 and meta["train_step"] > 0
    served = main(argv + ["--inference", "true"])
    for k in ("test_acc_co", "test_acc_c", "test_acc_o"):
        assert served[k] == meta[k] == res[k], k
    resumed = main(argv + ["--epochs", "5", "--save_model", "true", "--resume", "true"])
    assert "resumed from checkpoint at epoch {}".format(meta["epoch"]) in capsys.readouterr().out
    assert [h["epoch"] for h in resumed["history"]] == list(range(meta["epoch"] + 1, 6))
    assert resumed["best_val_acc"] >= res["best_val_acc"]
