"""REDDIT-BINARY-shaped threads (NumPy only) for sparse-layout checks.

A copy of the graph generator of benchmarks/gen_reddit_synthetic.py
(``sample_size``, ``make_qa_thread``, ``make_discussion_thread``,
``make_graph``): heavy-tailed thread sizes (lognormal, mean ~430, max 3800
nodes), question/answer threads whose expert hubs collect a large share of
the replies, discussion threads with deep reply chains, and ~0.16 noise
edges per node.  ``reddit_graphs`` turns them into HostGraphs with random
node features, for hub-heavy batches that the synthetic BA/tree graphs
(bounded degree) never produce.
"""
from __future__ import annotations

import numpy as np

from cal_tpu_torch.graph import HostGraph


def sample_size(rng: np.random.Generator) -> int:
    """Heavy-tailed thread size: lognormal matched to REDDIT-BINARY
    (mean ~430, max ~3800)."""
    return int(np.clip(rng.lognormal(mean=np.log(280.0), sigma=0.85), 60, 3800))


def make_qa_thread(rng: np.random.Generator, n: int) -> list[tuple[int, int]]:
    """Class 1: question/answer thread — root + 1-4 expert hubs, shallow."""
    k = int(rng.integers(1, 5))
    p_exp = float(rng.uniform(0.35, 0.85))
    edges = [(0, e) for e in range(1, k + 1)]          # experts answer root
    hubs = list(range(1, k + 1))
    for i in range(k + 1, n):
        u = rng.random()
        if u < 0.15:
            parent = 0                                  # reply to the post
        elif u < 0.15 + p_exp:
            parent = int(rng.choice(hubs))              # reply to an expert
        else:
            parent = int(rng.integers(1, i))            # short side chain
        edges.append((parent, i))
    return edges


def make_discussion_thread(rng: np.random.Generator, n: int) -> list[tuple[int, int]]:
    """Class 0: discussion thread — deep reply chains; ~30% of threads also
    hold one "viral" post collecting a large share of the replies."""
    viral = -1
    p_viral = 0.0
    if rng.random() < 0.3:
        viral = 0
        p_viral = float(rng.uniform(0.15, 0.45))
    edges = []
    for i in range(1, n):
        u = rng.random()
        if viral >= 0 and u < p_viral and i > viral:
            parent = viral                              # pile-on replies
        elif u < p_viral + 0.2:
            parent = int(rng.integers(0, i))            # random earlier post
        else:
            parent = int(rng.integers(max(0, i - 20), i))  # recent post
        edges.append((parent, i))
    return edges


def make_graph(rng: np.random.Generator, label: int):
    n = sample_size(rng)
    edges = (make_qa_thread(rng, n) if label == 1
             else make_discussion_thread(rng, n))
    # cross-reference noise edges to match REDDIT's ~1.16 edges/node
    n_noise = int(0.16 * n * rng.uniform(0.5, 1.5))
    for _ in range(n_noise):
        u, v = rng.integers(0, n, size=2)
        if u != v:
            edges.append((int(u), int(v)))
    return n, edges


def reddit_graphs(count: int, seed: int, feat: int) -> list[HostGraph]:
    """``count`` threads (labels alternate) as undirected HostGraphs (both
    directions of every edge) with N(0, 1) features of width ``feat``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n, edges = make_graph(rng, i % 2)
        e = np.asarray(edges, np.int32).reshape(-1, 2)
        s = np.concatenate([e[:, 0], e[:, 1]])
        r = np.concatenate([e[:, 1], e[:, 0]])
        x = rng.standard_normal((n, feat)).astype(np.float32)
        out.append(HostGraph(x=x, senders=s, receivers=r, y=i % 2))
    return out
