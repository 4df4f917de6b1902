"""The port's dense CausalGAT slice against the JAX package on the CPU: the
flash-GAT plain twins (the path CPU tensors take) against the Pallas kernel
in interpret mode and the XLA reference, the dropout law, the CausalGAT
forward and train step with the flax weights carried across, and
save/serve/resume through the entry point.

Small sizes (B <= 4, N <= 32, 2 heads, d <= 8; the model at hidden 16, 2
layers).  Inputs are made with NumPy from a seed and handed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_model import CLASSES, _batches, _graphs, _models
from test_torch_port_train import C_W, CO_W, EPOCHS, LR, MIN_LR, O_W, WD, _flat, _jax_grads

from cal_tpu.ops.gat import gat_aggregate_dense as jax_gat_dense
from cal_tpu.ops.pallas_gat import _flash_core, _flash_fwd_call
from cal_tpu.ops.pallas_gat import flash_gat_dense as jax_flash_dense
from cal_tpu.ops.pallas_gat import flash_gat_dense_flat as jax_flash_flat
from cal_tpu.train.optim import make_optimizer as jax_make_optimizer
from cal_tpu.train.steps import TrainState as JaxTrainState
from cal_tpu.train.steps import _as_graph, make_causal_train_step, to_device
from cal_tpu_torch.graph import to_dense
from cal_tpu_torch.main_syn import main
from cal_tpu_torch.models.causal import CausalGNN
from cal_tpu_torch.ops.flash_gat import (
    dropout_keep,
    flash_gat_bwd_plain,
    flash_gat_dense,
    flash_gat_dense_flat,
    flash_gat_fwd_plain,
)
from cal_tpu_torch.ops.gat import gat_aggregate_dense
from cal_tpu_torch.train.optim import cosine_lr, make_optimizer
from cal_tpu_torch.train.steps import TrainState, dropout_seeds, make_causal_train_step as port_step
from cal_tpu_torch.train.steps import step_seed
from cal_tpu_torch.utils.checkpoint import Checkpointer

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: the same f32 math, sums in another order.  bf16: the inputs are bf16
# in both, the attention runs in f32 in both, and only the output is rounded
# to bf16, so a sum that lands on the other side of a rounding boundary
# moves by one bf16 ulp (2^-7 relative at most).
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=8e-3, atol=8e-3)}
# The XLA reference in bf16 forms the scores, the softmax and alpha in bf16
# (2^-8 relative each, through exp and a normalisation), the flash path in
# f32: a few bf16 ulps of outputs of order 1.
XLA_BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# Model log-probs: as tests/test_torch_port_model.py FWD_TOL.
FWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _inputs(dtype, b=3, n=16, heads=2, d=8, seed=0):
    """xh [B, N, heads*d], multigraph counts with an isolated node and a
    self-loop count (overridden by the analytic self loop), att halves."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, n, heads * d)).astype(np.float32)
    adj = ((rng.random((b, n, n)) < 0.2) + (rng.random((b, n, n)) < 0.05)).astype(np.float32)
    adj[:, 2, :] = 0.0
    adj[:, :, 2] = 0.0
    adj[0, 4, 4] = 2.0
    att_dst = rng.standard_normal((heads, d)).astype(np.float32)
    att_src = rng.standard_normal((heads, d)).astype(np.float32)
    arrs = (xh, adj, att_dst, att_src)
    jx = tuple(jnp.asarray(a, jnp.dtype(dtype)) for a in arrs)
    tx = tuple(torch.tensor(np.asarray(a, np.float32)).to(TORCH_DT[dtype]) for a in jx)
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_twin_matches_pallas_and_xla(dtype):
    jx, tx = _inputs(dtype)
    assert float(tx[1].max()) >= 2.0                          # duplicate edges
    ours = flash_gat_dense_flat(*tx)
    assert ours.dtype == TORCH_DT[dtype] and ours.shape == tx[0].shape
    ours = ours.float().numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_flash_flat(*jx), np.float32),
                               **FLASH_TOL[dtype])
    b, n, hd = tx[0].shape
    heads, d = tx[2].shape
    xla = np.asarray(jax_gat_dense(jx[0].reshape(b, n, heads, d), *jx[1:]),
                     np.float32).reshape(b, n, hd)
    np.testing.assert_allclose(ours, xla, **(FLASH_TOL[dtype] if dtype == "float32"
                                             else XLA_BF16_TOL))
    # the port's own XLA-style reference, and the 4-D entry point
    x4 = tx[0].view(b, n, heads, d)
    ref4 = gat_aggregate_dense(x4, *tx[1:])
    np.testing.assert_allclose(ref4.float().numpy().reshape(b, n, hd), xla, **FLASH_TOL[dtype])
    np.testing.assert_allclose(flash_gat_dense(x4, *tx[1:]).float().numpy(),
                               np.asarray(jax_flash_dense(jx[0].reshape(b, n, heads, d), *jx[1:]),
                                          np.float32), **FLASH_TOL[dtype])
    # the isolated node attends to itself only
    np.testing.assert_allclose(ours[:, 2], tx[0][:, 2].float().numpy(), **FLASH_TOL[dtype])


def test_large_score_spread_stays_finite():
    """tests/test_pallas_gat.py's regression: scores whose row max lands on a
    non-edge ~200 above every edge score; the max is over allowed cells."""
    rng = np.random.default_rng(0)
    b, n, heads, d = 2, 16, 2, 4
    xh = rng.standard_normal((b, n, heads * d)).astype(np.float32)
    att_dst = (rng.standard_normal((heads, d)) * 40).astype(np.float32)
    att_src = (rng.standard_normal((heads, d)) * 40).astype(np.float32)
    adj = np.zeros((b, n, n), np.float32)
    adj[:, np.arange(1, n), np.arange(n - 1)] = 1.0
    tx = [torch.from_numpy(a) for a in (xh, adj, att_dst, att_src)]
    tx[0].requires_grad_()
    out = flash_gat_dense_flat(*tx)
    assert torch.isfinite(out).all()
    ref = jax_flash_flat(*map(jnp.asarray, (xh, adj, att_dst, att_src)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    out.sum().backward()
    assert torch.isfinite(tx[0].grad).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_twin_matches_pallas_vjp(dtype):
    """At rate 0: the forward twin's (out, m, den) against ``_flash_fwd_call``,
    the backward twin's (dti, dtj, dxh) against jax.vjp of ``_flash_core``,
    and, through the score halves, d xh / d att_dst / d att_src of
    ``flash_gat_dense_flat`` against jax.vjp of the JAX version."""
    jx, tx = _inputs(dtype, b=2, n=12, seed=1)
    b, n, hd = tx[0].shape
    heads, d = tx[2].shape
    rng = np.random.default_rng(2)
    ti, tj = (rng.standard_normal((b, n, heads)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, n, hd)).astype(np.float32)
    seed = jnp.zeros((1, 128), jnp.int32)
    jout, jm, jden = _flash_fwd_call(jnp.asarray(ti), jnp.asarray(tj.transpose(0, 2, 1)),
                                     jx[1], jx[0], seed, 0.0)
    out, m, den = flash_gat_fwd_plain(torch.from_numpy(ti), torch.from_numpy(tj), tx[1], tx[0])
    for a, r in ((out, jout), (m, jm), (den, jden)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=2e-5, atol=2e-5)
    _, vjp = jax.vjp(lambda a, bt, x: _flash_core(a, bt, jx[1], x, seed, 0.0),
                     jnp.asarray(ti), jnp.asarray(tj.transpose(0, 2, 1)), jx[0])
    jdti, jdtjt, jdxh = vjp(jnp.asarray(g))
    dti, dtj, dxh = flash_gat_bwd_plain(torch.from_numpy(ti), torch.from_numpy(tj), tx[1],
                                        tx[0], m, den, torch.from_numpy(g))
    assert dxh.dtype == TORCH_DT[dtype] and dti.dtype == dtj.dtype == torch.float32
    np.testing.assert_allclose(dti.numpy(), np.asarray(jdti), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dtj.numpy(), np.asarray(jdtjt).transpose(0, 2, 1),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dxh.float().numpy(), np.asarray(jdxh, np.float32),
                               **FLASH_TOL[dtype])

    # through the layer's entry point: gradients of xh and of att
    gl = rng.standard_normal((b, n, hd)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, a1, a2: jax_flash_flat(x, jx[1], a1, a2), jx[0], jx[2], jx[3])
    ref = vjp(jnp.asarray(gl, jx[0].dtype))
    leaves = [t.clone().requires_grad_() for t in (tx[0], tx[2], tx[3])]
    ours = flash_gat_dense_flat(leaves[0], tx[1], leaves[1], leaves[2])
    ours.backward(torch.from_numpy(gl).to(ours.dtype))
    # bf16: every gradient passes through bf16 cotangents and bf16 results
    tol = FLASH_TOL[dtype] if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for leaf, r, name in zip(leaves, ref, ("xh", "att_dst", "att_src")):
        np.testing.assert_allclose(leaf.grad.float().numpy(), np.asarray(r, np.float32),
                                   err_msg=name, **tol)


def _density_counts(density, b, n, rng):
    """Count planes of the densities the kernels treat apart: no edge at all
    (every row's only live cell its diagonal), every cell live (counts
    1-3), sparse with a hub receiver (0) and a hub sender (n - 1) over every
    node, and sparse multigraph counts."""
    if density == "self_loops":
        return np.zeros((b, n, n), np.float32)
    if density == "full":
        return rng.integers(1, 4, (b, n, n)).astype(np.float32)
    counts = ((rng.random((b, n, n)) < 0.2) + (rng.random((b, n, n)) < 0.05)).astype(np.float32)
    if density == "hubs":
        counts[:, 0, :] = 1.0
        counts[:, :, n - 1] = 1.0
    return counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("density,n", [("self_loops", 12), ("full", 12), ("hubs", 12),
                                       ("sparse", 33)])
def test_twins_match_pallas_across_densities(density, n, dtype):
    """At rate 0, on each density (and N = 33, not a multiple of 32): the
    forward twin's (out, m, den) against ``_flash_fwd_call`` and the
    backward twin's (dti, dtj, dxh) against jax.vjp of ``_flash_core``, both
    in interpret mode.  With no edge, the second graph is all padding: its
    xh and score halves are 0."""
    b, heads, d = 2, 2, 8
    rng = np.random.default_rng(n + len(density))
    counts = _density_counts(density, b, n, rng)
    xh = rng.standard_normal((b, n, heads * d)).astype(np.float32)
    ti, tj = (rng.standard_normal((b, n, heads)).astype(np.float32) for _ in range(2))
    if density == "self_loops":
        xh[-1] = ti[-1] = tj[-1] = 0.0
    g = rng.standard_normal((b, n, heads * d)).astype(np.float32)
    jc, jxh = (jnp.asarray(a, jnp.dtype(dtype)) for a in (counts, xh))
    tc, txh = (torch.tensor(np.asarray(a, np.float32)).to(TORCH_DT[dtype]) for a in (jc, jxh))
    seed = jnp.zeros((1, 128), jnp.int32)
    jti, jtjt = jnp.asarray(ti), jnp.asarray(tj.transpose(0, 2, 1))
    jout, jm, jden = _flash_fwd_call(jti, jtjt, jc, jxh, seed, 0.0)
    out, m, den = flash_gat_fwd_plain(torch.from_numpy(ti), torch.from_numpy(tj), tc, txh)
    for a, r in ((out, jout), (m, jm), (den, jden)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=2e-5, atol=2e-5)
    _, vjp = jax.vjp(lambda a, bt, x: _flash_core(a, bt, jc, x, seed, 0.0), jti, jtjt, jxh)
    jdti, jdtjt, jdxh = vjp(jnp.asarray(g))
    dti, dtj, dxh = flash_gat_bwd_plain(torch.from_numpy(ti), torch.from_numpy(tj), tc, txh,
                                        m, den, torch.from_numpy(g))
    np.testing.assert_allclose(dti.numpy(), np.asarray(jdti), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dtj.numpy(), np.asarray(jdtjt).transpose(0, 2, 1),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dxh.float().numpy(), np.asarray(jdxh, np.float32),
                               **FLASH_TOL[dtype])
    if density == "self_loops":                 # every row attends to itself alone
        np.testing.assert_array_equal(den.numpy(), 1.0)
        np.testing.assert_allclose(out.numpy(), txh.float().numpy(), **FLASH_TOL[dtype])


def _twin_inputs(b=2, n=24, heads=2, d=8, seed=3):
    g = torch.Generator().manual_seed(seed)
    ti, tj = (2 * torch.randn((b, n, heads), generator=g) for _ in range(2))
    counts = torch.randint(0, 3, (b, n, n), generator=g).float()
    counts = counts * (torch.rand((b, n, n), generator=g) < 0.3)
    xh, gout = (torch.randn((b, n, heads * d), generator=g) for _ in range(2))
    return ti, tj, counts, xh, gout


def test_backward_twin_replays_dropout():
    """With dropout on, the backward twin equals torch.autograd of the
    forward twin: both draw the same keep bits from the seed."""
    ti, tj, counts, xh, gout = _twin_inputs()
    leaves = [t.clone().requires_grad_() for t in (ti, tj, xh)]
    out, m, den = flash_gat_fwd_plain(leaves[0], leaves[1], counts, leaves[2], 2**40 + 9, 0.2)
    ref = torch.autograd.grad((out * gout).sum(), leaves)
    got = flash_gat_bwd_plain(ti, tj, counts, xh, m.detach(), den.detach(), gout, 2**40 + 9, 0.2)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
    base = flash_gat_fwd_plain(ti, tj, counts, xh)[0]
    assert (out - base).abs().max() > 0.1                     # dropout did act


def test_philox_bits_match_reference():
    """The int64 Philox-4x32-10 of the twins (and kernels) against the
    Random123 known answer for counter 0 / key 0 and a plain-integer
    transcription on counters past 2^32."""
    from cal_tpu_torch.ops.flash_gat import philox_bits

    m32 = 0xFFFFFFFF

    def ref(cell, k0, k1):
        c = [cell & m32, cell >> 32, 0, 0]
        for _ in range(10):
            p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
            c = [(p1 >> 32) ^ c[1] ^ k0, p1 & m32, (p0 >> 32) ^ c[3] ^ k1, p0 & m32]
            k0, k1 = (k0 + 0x9E3779B9) & m32, (k1 + 0xBB67AE85) & m32
        return c[0]

    assert int(philox_bits(torch.tensor([0]), 0, 0)[0]) == 0x6627E8D5
    rng = np.random.default_rng(5)
    cells = [int(c) for c in rng.integers(0, 2**40, 300)] + [2**32 - 1, 2**32, 2**40 - 1]
    k0, k1 = 0x9ABCDEF0, 0x12345678
    got = philox_bits(torch.tensor(cells), k0, k1).tolist()
    assert got == [ref(c, k0, k1) for c in cells]


def test_dropout_law():
    """Keep fraction ~ 1 - rate and an unbiased output (the law of
    tests/test_pallas_gat.py test_dropout_keep_rate_is_unbiased); equal
    seeds give equal masks, other seeds, graphs and heads other masks."""
    keep = dropout_keep(12345, 8, 4, 64, 0.2)
    assert keep.shape == (8, 4, 64, 64)
    assert abs(float(keep.float().mean()) - 0.8) < 0.01       # 131k cells, sd 0.0011
    assert torch.equal(keep, dropout_keep(12345, 8, 4, 64, 0.2))
    assert (keep != dropout_keep(12346, 8, 4, 64, 0.2)).float().mean() > 0.25
    assert (keep[0, 0] != keep[0, 1]).float().mean() > 0.25
    assert (keep[0, 0] != keep[1, 0]).float().mean() > 0.25
    assert dropout_keep(7, 2, 2, 8, 0.0).all()
    ti, tj, counts, xh, _ = _twin_inputs(b=4, n=32, seed=4)
    xh = xh.abs()
    base = flash_gat_fwd_plain(ti, tj, counts, xh)[0].sum()
    ratio = float(flash_gat_fwd_plain(ti, tj, counts, xh, 99, 0.2)[0].sum() / base)
    assert 0.9 < ratio < 1.1, ratio


def _gat_pair(dtype, **kw):
    jg, tg = _graphs()
    (jb, tb), = _batches(jg, tg, 4)[:1]
    g_j = _as_graph(to_device(jb), jnp.bfloat16 if dtype == "bfloat16" else None)
    jm, variables, tm = _models(dtype, g_j, 6, backbone="gat", **kw)
    return jb, tb, g_j, jm, variables, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flags", [{}, {"without_edge_attention": True,
                                        "without_node_attention": True}],
                         ids=["default", "ablation_flags_ignored"])
def test_causal_gat_eval_forward_matches_jax(dtype, flags):
    jb, tb, g_j, jm, variables, tm = _gat_pair(dtype, **flags)
    assert "edge_att_kernel" in dict(tm.named_parameters())
    assert set(dict(tm.named_parameters())) >= {"convs_0.kernel", "convs_0.att", "convs_0.bias"}
    ref = jax.jit(lambda v: jm.apply(v, g_j, eval_random=False, train=False))(variables)
    with torch.no_grad():
        ours = tm(to_dense(tb.to("cpu"), tm.dtype), eval_random=False, train=False)
    real = np.asarray(tb.n_nodes) > 0
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy()[real], np.asarray(b)[real], **FWD_TOL[dtype])


def test_causal_gat_shuffle_ignores_with_random():
    """The gat backbone's intervention follows eval_random alone."""
    _, tb, _, _, _, tm = _gat_pair("float32", with_random=False)
    g = to_dense(tb.to("cpu"), torch.float32)
    with torch.no_grad():
        fixed = tm(g, eval_random=False)[2]
        shuffled = [tm(g, eval_random=True, generator=torch.Generator().manual_seed(s))[2]
                    for s in range(4)]
    assert any((s - fixed).abs().max() > 1e-4 for s in shuffled)


def test_causal_gat_train_steps_match_jax_f32():
    """gat_dropout 0: step-1 gradients name by name, the per-step losses of
    three steps, and the parameters after them (Adam with L2)."""
    jg, tg = _graphs(count=10)
    pairs = _batches(jg, tg, 4)
    assert len(pairs) == 3
    g0 = _as_graph(to_device(pairs[0][0]))
    jm, variables, tm = _models("float32", g0, 6, backbone="gat", gat_dropout=0.0)
    tx = jax_make_optimizer(LR, MIN_LR, EPOCHS, len(pairs), WD)
    jstate = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    state = TrainState(tm, make_optimizer(tm.parameters(), WD))
    step = port_step(state, cosine_lr(LR, MIN_LR, EPOCHS, len(pairs)), C_W, O_W, CO_W,
                     False, seed=0)
    ref_grads = _jax_grads(jm, jstate, pairs[0][0])
    jstep = make_causal_train_step(jm, tx, C_W, O_W, CO_W, False)
    for i, (jb, tb) in enumerate(pairs):
        jstate, jm_out = jstep(jstate, to_device(jb), jax.random.PRNGKey(0))
        ours = step(tb, None)
        if i == 0:
            for name, p in state.model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), ref_grads[name], rtol=1e-4,
                                           atol=1e-5, err_msg=name)
            assert np.abs(ref_grads["convs_0.att"]).max() > 0
        np.testing.assert_allclose(
            ours.numpy(), [float(jm_out[k]) for k in
                           ("loss", "loss_c", "loss_o", "loss_co", "correct_o", "n")],
            rtol=1e-5, err_msg=f"step {i}")
    # as test_train_steps_match_jax_f32: an entry at the rounding-noise floor
    # may move by up to 2 lr a step in opposite directions
    ref_p = _flat(jstate.params)
    diffs = np.concatenate([np.abs(p.detach().numpy() - ref_p[n]).ravel()
                            for n, p in state.model.named_parameters()])
    assert diffs.max() <= 6 * LR and np.mean(diffs <= 1e-5) >= 0.999


def test_dropout_seeds_per_step_and_layer():
    tm = CausalGNN(6, 16, CLASSES, num_layers=3, backbone="gat")
    seeds = dropout_seeds(tm, 666, 5)
    assert seeds == dropout_seeds(tm, 666, 5) and len(set(seeds)) == 3
    assert not set(seeds) & set(dropout_seeds(tm, 666, 6))
    assert step_seed(666, 5) not in seeds                     # the intervention's seed
    assert dropout_seeds(CausalGNN(6, 16, CLASSES), 666, 5) is None


def test_causal_gat_train_save_serve_resume(tmp_path, capsys):
    """CausalGAT (dropout on) through main_syn on the CPU: a rerun gives the
    same losses; --save_model then --inference reproduces the saved test
    accuracies; --resume continues at the epoch after the checkpoint."""
    argv = ["--model", "CausalGAT", "--device", "cpu", "--data_num", "30", "--node_num", "4",
            "--max_degree", "6", "--bias", "0.7", "--batch_size", "32", "--hidden", "16",
            "--layers", "2", "--lr", "0.01", "--seed", "5", "--save_dir", str(tmp_path)]
    res = main(argv + ["--epochs", "3", "--save_model", "true"])
    again = main(argv + ["--epochs", "3"])
    assert [h["loss"] for h in res["history"]] == [h["loss"] for h in again["history"]]
    meta = Checkpointer(str(tmp_path)).restore(
        CausalGNN(6, 16, CLASSES, num_layers=2, backbone="gat"))
    assert meta["epoch"] == res["epoch"] >= 1 and meta["train_step"] > 0
    served = main(argv + ["--inference", "true"])
    for k in ("test_acc_co", "test_acc_c", "test_acc_o"):
        assert served[k] == meta[k] == res[k], k
    resumed = main(argv + ["--epochs", "5", "--save_model", "true", "--resume", "true"])
    assert "resumed from checkpoint at epoch {}".format(meta["epoch"]) in capsys.readouterr().out
    assert [h["epoch"] for h in resumed["history"]] == list(range(meta["epoch"] + 1, 6))
    assert all(np.isfinite(h["loss"]) for h in resumed["history"])
