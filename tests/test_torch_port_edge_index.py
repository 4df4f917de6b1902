"""The per-batch edge index of the edge-formulated dense GAT
(ops/edge_gat.py ``EdgeIndex``) on the CPU: its plain build against a NumPy
construction from the same sorted edge list (padding, duplicate slots, self
loops, self-loop-only rows, an empty graph, hubs over several chunks, no
padding, no edge at all; ``EdgeIndex.as_lists`` also checks the heavy
lists' layout and the arrival counters), and ``edge_gat_dense_flat`` with the index handed
and without it, against each other and against cal_tpu's
``edge_gat_dense``; the dense batch carries the index to the GAT layer.

Inputs are made with NumPy from a seed and handed to both packages."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from edge_lists import hub_edges
from test_torch_port_edge_gat import (
    B,
    D,
    EG,
    HEADS,
    JDT,
    TDT,
    TOL,
    N,
    _close,
    _edges,
    _inputs,
    _layer_pair,
)

import cal_tpu_torch.nn.layers as layers_mod
from cal_tpu.ops.pallas_gat_sparse import edge_gat_dense as jax_edge_gat_dense
from cal_tpu_torch.ops.edge_gat import SPAN, EdgeIndex, edge_gat_dense_flat


def _numpy_index(ef, b, n):
    """The index written out with Python loops: {field: value}, the lists
    as sorted Python lists, heavy chunks as (node, chunk) pairs."""
    rows, total = b * n, b * n * n
    live = [(i, int(k)) for i, k in enumerate(ef) if 0 <= k < total]
    keys = [((k // (n * n)) * n + k % n) * n + (k // n) % n if 0 <= k < total else total
            for k in map(int, ef)]
    order = sorted(range(len(ef)), key=lambda i: (keys[i], i))
    recv, send = {}, {}
    for i, k in live:
        recv.setdefault(k // n, []).append(i)
    for p, i in enumerate(order):
        if keys[i] < total:
            send.setdefault(keys[i] // n, []).append(p)
    spos = np.zeros(len(ef), np.int64)
    spos[order] = np.arange(len(ef))
    out = {"spos": spos.tolist(),
           "srecv": [keys[i] // (n * n) * n + keys[i] % n if keys[i] < total else -1
                     for i in order]}
    for name, runs in (("rrange", recv), ("srange", send)):
        rng = np.zeros((rows, 2), np.int64)
        for v, places in runs.items():
            assert places == list(range(places[0], places[-1] + 1))   # runs are contiguous
            rng[v] = places[0], places[-1] + 1
        out[name] = rng.tolist()
    chunks = lambda runs: [(v, c) for v in sorted(runs) if len(runs[v]) > SPAN
                           for c in range(-(-len(runs[v]) // SPAN))]
    out["light_r"] = sorted(v for v, sl in recv.items() if len(sl) <= SPAN)
    out["light_s"] = sorted([u for u, pl in send.items() if len(pl) <= SPAN]
                            + [v for v in recv if v not in send])
    out["heavy_r"], out["heavy_s"] = chunks(recv), chunks(send)
    return out


def _case(name):
    """(edge_flat int32, B, N) of one index case."""
    if name == "multigraph":           # cal_tpu's test list: duplicates, self loops,
        return _edges(seed=3)[0], B, N  # an empty last graph, padding
    if name == "hubs":                 # hubs over several chunks, self-loop-only
        return hub_edges(), 3, 48       # rows, an empty graph, padding
    if name == "empty":
        return np.full(64, 2 * 16 * 16, np.int32), 2, 16
    if name == "unpadded":
        rng = np.random.default_rng(4)
        b, n = 2, 20
        ef = np.sort(rng.integers(0, b * n * n, 150))
        return ef.astype(np.int32), b, n
    raise ValueError(name)


@pytest.mark.parametrize("case", ["multigraph", "hubs", "empty", "unpadded"])
def test_index_matches_numpy_construction(case):
    ef, b, n = _case(case)
    idx = EdgeIndex(torch.from_numpy(ef), b, n)
    assert idx.zeroed is None                  # built on first use only
    got, want = idx.build().as_lists(), _numpy_index(ef, b, n)
    assert got == want
    if case == "hubs":   # the hub's 4 chunks, the self-loop-only rows (41 heavy, 42 light)
        assert {(0, 3), (41, 1)} <= set(want["heavy_r"]) and (0, 4) not in want["heavy_r"]
        assert (5, 2) in want["heavy_s"] and 42 in want["light_r"] and 42 in want["light_s"]
    assert idx.cap_h > len(want["heavy_r"]) and idx.cap_h > len(want["heavy_s"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_flat_with_and_without_index_match_jax(dtype):
    """edge_gat_dense_flat handed the batch's EdgeIndex equals the call
    without one (the CPU twins, forward and gradients, at dropout 0 and with
    a seed), and both match cal_tpu's edge_gat_dense at dropout 0."""
    ef, _, _, xh, _ = _inputs(seed=9)
    rng = np.random.default_rng(9)
    ad, asr = ((0.3 * rng.standard_normal((HEADS, D))).astype(np.float32) for _ in range(2))
    ref = jax_edge_gat_dense(jnp.asarray(xh.reshape(B, N, HEADS, D), JDT[dtype]),
                             jnp.asarray(ef), EG, jnp.asarray(ad), jnp.asarray(asr))
    ef_t = torch.from_numpy(ef)
    idx = EdgeIndex(ef_t, B, N)
    for rate, seed in ((0.0, None), (0.2, 77)):
        runs = []
        for index in (idx, None):
            leaves = [torch.tensor(a, requires_grad=True) for a in (xh, ad, asr)]
            x = leaves[0].to(TDT[dtype])
            out = edge_gat_dense_flat(x, ef_t, leaves[1], leaves[2], rate, seed, index)
            (out.float() ** 2).sum().backward()
            runs.append([out.detach()] + [t.grad for t in leaves])
        for a, b in zip(*runs):
            assert torch.equal(a, b)
        if seed is None:
            _close(runs[0][0].float().reshape(B, N, HEADS, D), np.asarray(ref, np.float32),
                   TOL[dtype]["fwd"], "out vs edge_gat_dense")
    assert idx.zeroed is None                  # the CPU twins never build it


def test_dense_batch_carries_index_to_the_layer():
    """to_dense hands the GAT layer an (unbuilt) EdgeIndex of the batch's
    edge list; the layer passes it to edge_gat_dense_flat; built, it is the
    NumPy construction's."""
    _, gt, _, _, tl = _layer_pair([384, 290], [700, 520], 384)
    idx = gt.edge_index
    assert isinstance(idx, EdgeIndex) and idx.zeroed is None
    assert (idx.num_slots, idx.bsz, idx.n) == (gt.edge_flat.shape[0], 2, 384)
    with mock.patch.object(layers_mod, "edge_gat_dense_flat",
                           wraps=layers_mod.edge_gat_dense_flat) as spy, torch.no_grad():
        tl(gt.x, gt)
    assert spy.call_args.args[-1] is idx
    assert idx.build().as_lists() == _numpy_index(gt.edge_flat.numpy(), 2, 384)
