"""The port's CausalGCN eval forward and serving sweep against the JAX
package, with the flax weights carried across by ``params_from_jax``.

Small sizes (hidden 16, 2 layers, N <= 32); the JAX Pallas kernels run in
interpret mode on the CPU, the port's wrappers take their plain twins."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cal_tpu.data.loader import Loader as JaxLoader
from cal_tpu.data.synthetic import dataset_bias_split as jax_split
from cal_tpu.data.synthetic import generate_synthetic_dataset as jax_generate
from cal_tpu.graph import HostGraph as JaxHostGraph
from cal_tpu.models.causal import CausalGNN as JaxCausalGNN
from cal_tpu.train.steps import TrainState, _as_graph, make_causal_eval_step, to_device
from cal_tpu_torch.data.loader import Loader
from cal_tpu_torch.graph import HostGraph, to_dense
from cal_tpu_torch.main_syn import main
from cal_tpu_torch.models.causal import CausalGNN, intervention_permutation
from cal_tpu_torch.utils.checkpoint import Checkpointer, params_from_jax

HIDDEN, LAYERS, CLASSES = 16, 2, 4


def _graphs(seed=0, count=10, feat=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(5, 21))
        e = int(rng.integers(n, 3 * n))
        s = rng.integers(0, n, e).astype(np.int32)   # multigraph, self loops
        r = rng.integers(0, n, e).astype(np.int32)
        s, r = np.concatenate([s, r]), np.concatenate([r, s])
        x = rng.standard_normal((n, feat)).astype(np.float32)
        out.append((x, s, r, int(rng.integers(CLASSES))))
    return ([JaxHostGraph(x=x, senders=s, receivers=r, y=y) for x, s, r, y in out],
            [HostGraph(x=x, senders=s, receivers=r, y=y) for x, s, r, y in out])


def _randomize(tree, rng):
    """Perturb every flax parameter (zero biases, unit BN scales) so each
    one matters in the comparison."""
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + rng.normal(0, 0.3, np.shape(a))).astype(np.float32), tree)


def _models(dtype, sample_graph, num_features, seed=0, backbone="gcn", **kw):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jm = JaxCausalGNN(backbone=backbone, hidden=HIDDEN, num_classes=CLASSES,
                      num_layers=LAYERS, dtype=jdt, **kw)
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(lambda k: jm.init({"params": k, "intervention": k}, sample_graph,
                                          eval_random=False))(key)
    rng = np.random.default_rng(seed)
    params = _randomize(variables["params"], rng)
    stats = _unflat({k: {"mean": rng.normal(0, 0.5, v["mean"].shape).astype(np.float32),
                         "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
                     for k, v in _flat_bn(variables["batch_stats"]).items()})
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tm = CausalGNN(num_features=num_features, hidden=HIDDEN, num_classes=CLASSES,
                   num_layers=LAYERS, backbone=backbone, dtype=tdt, **kw)
    tm.load_state_dict(params_from_jax(params, stats))
    return jm, {"params": params, "batch_stats": stats}, tm.eval()


def _flat_bn(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if "mean" in v:
            out[prefix + (k,)] = v
        else:
            out.update(_flat_bn(v, prefix + (k,)))
    return out


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _batches(jg, tg, bs):
    jl = JaxLoader(jg, bs, layout="dense", prefetch=0)
    tl = Loader(tg, bs)
    assert jl.budgets["node_budget"] == tl.budgets["node_budget"]
    return list(zip(jl.host_batches(), tl.host_batches()))


# f32: identical math in both packages, sums in another order.  bf16: the
# conv stack rounds to bf16 at the same places, but XLA and PyTorch round
# some elementwise chains (softmax, the norm products) at different points,
# so single bf16 ulps (2^-8 relative) propagate through three convs and two
# BatchNorms into the f32 readouts.
FWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flags", [{}, {"cat_or_add": "cat"},
                                   {"without_edge_attention": True,
                                    "without_node_attention": True}],
                         ids=["default", "cat", "ablations"])
def test_eval_forward_matches_jax(dtype, flags):
    jg, tg = _graphs()
    (jb, tb), = _batches(jg, tg, 16)[:1]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    g_j = _as_graph(to_device(jb), jdt)
    jm, variables, tm = _models(dtype, g_j, 6, **flags)
    ref = jm.apply(variables, g_j, eval_random=False, train=False)
    with torch.no_grad():
        g_t = to_dense(tb.to("cpu"), tm.dtype)
        ours = tm(g_t, eval_random=False, train=False)
    real = np.asarray(tb.n_nodes) > 0
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy()[real], np.asarray(b)[real], **FWD_TOL[dtype])


def test_serving_sweep_matches_jax_eval_step(tmp_path):
    """The whole slice: the port's main_syn --inference (synthetic data from
    the seed, checkpoint restore, eval sweep) against the JAX eval step on
    the same test split with the same weights."""
    args = dict(data_num=10, node_num=4, seed=5)
    ds = jax_generate(data_num=10, node_num=4, seed=5)
    _, _, test, _ = jax_split(ds, bias=0.5, total=40, seed=5)
    bs = 4
    jl = JaxLoader(test, bs, layout="dense", prefetch=0)
    batches = [to_device(b) for b in jl.host_batches()]
    g0 = _as_graph(batches[0])
    jm, variables, tm = _models("float32", g0, 10)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state={}, step=jnp.zeros((), jnp.int32))
    step = make_causal_eval_step(jm, eval_random=False)
    tot = np.zeros(4)
    for b in batches:
        m = step(state, b, jax.random.PRNGKey(0))
        tot += [float(m[k]) for k in ("correct_co", "correct_c", "correct_o", "n")]

    Checkpointer(str(tmp_path)).save(7, tm, {"epoch": 7})
    argv = ["--model", "CausalGCN", "--inference", "true", "--save_dir", str(tmp_path),
            "--device", "cpu", "--hidden", str(HIDDEN), "--layers", str(LAYERS),
            "--batch_size", str(bs)]
    for k, v in args.items():
        argv += [f"--{k}", str(v)]
    res = main(argv)
    assert res["graphs"] == tot[3] == len(test) > bs
    np.testing.assert_allclose(
        [res["test_acc_co"], res["test_acc_c"], res["test_acc_o"]],
        tot[:3] / tot[3], atol=1e-12)
    assert res["ckpt_step"] == 7


def test_checkpoint_roundtrip(tmp_path):
    jg, _ = _graphs()
    g_j = _as_graph(to_device(next(JaxLoader(jg, 4, prefetch=0).host_batches())))
    _, _, tm = _models("float32", g_j, 6)
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        ck.save(s, tm, {"epoch": s})
    assert ck.latest_step() == 3 and sorted(ck._steps()) == [2, 3]
    fresh = CausalGNN(num_features=6, hidden=HIDDEN, num_classes=CLASSES,
                      num_layers=LAYERS, seed=99)
    assert ck.restore(fresh) == {"epoch": 3}
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("mask", [[1, 1, 1, 1, 1, 0, 0, 0],
                                  [0, 1, 0, 1, 1, 0, 1, 0]],
                         ids=["prefix", "scattered"])
def test_intervention_permutation(mask):
    gm = torch.tensor(mask, dtype=torch.bool)
    real = torch.nonzero(gm).flatten()
    seen = set()
    for seed in range(20):
        perm = intervention_permutation(torch.Generator().manual_seed(seed), gm)
        assert sorted(perm[real].tolist()) == real.tolist()
        pad = torch.nonzero(~gm).flatten()
        assert perm[pad].tolist() == pad.tolist()
        seen.add(tuple(perm.tolist()))
    assert len(seen) > 1
