"""Synthetic OOD dataset: motif shapes on confounded basis graphs.

Counterpart of cal_tpu/data/synthetic.py in NumPy and the standard library
only (no networkx): the Barabasi-Albert and balanced-tree bases are
generated here by the same algorithms, random streams and edge orders as
networkx's ``barabasi_albert_graph`` and ``balanced_tree``, so one seed
gives the same dataset in both packages.

* 4 classes = motif shape {house, cycle(6), grid(2x3), diamond};
* confounder = basis context {tree, ba}: BA(node_num^2, m=2) or the
  balanced node_num-ary tree of height 2;
* one motif attached at a random basis node, +noise (default 10%) random
  new edges, node features = one-hot degree capped at max_degree;
* biased split: P(tree | house) = bias, P(tree | other) = 1 - bias in
  train/val; test is 50/50.
"""
from __future__ import annotations

import random
from typing import Dict, List

import numpy as np

from cal_tpu_torch.graph import HostGraph

SYN_CLASSES = ["house", "cycle", "grid", "diamond"]
SYN_CONTEXTS = ["tree", "ba"]


class SimpleGraph:
    """Undirected simple graph with networkx.Graph's insertion-ordered
    adjacency, so ``edges()`` comes out in networkx's order."""

    def __init__(self, n: int = 0):
        self.adj: Dict[int, Dict[int, None]] = {i: {} for i in range(n)}

    def add_node(self, u: int) -> None:
        self.adj.setdefault(u, {})

    def add_edge(self, u: int, v: int) -> None:
        self.adj.setdefault(u, {})[v] = None
        self.adj.setdefault(v, {})[u] = None

    def has_edge(self, u: int, v: int) -> bool:
        return u in self.adj and v in self.adj[u]

    def number_of_nodes(self) -> int:
        return len(self.adj)

    def number_of_edges(self) -> int:
        return sum(len(nb) for nb in self.adj.values()) // 2

    def degree(self):
        return ((u, len(nb)) for u, nb in self.adj.items())

    def edges(self) -> list[tuple[int, int]]:
        seen, out = set(), []
        for u, nbrs in self.adj.items():
            out.extend((u, v) for v in nbrs if v not in seen)
            seen.add(u)
        return out


def barabasi_albert_graph(n: int, m: int, seed: int) -> SimpleGraph:
    """networkx.barabasi_albert_graph(n, m, seed=int): a star on m+1 nodes,
    then preferential attachment drawn with ``random.Random(seed).choice``."""
    rnd = random.Random(seed)
    g = SimpleGraph(m + 1)
    for v in range(1, m + 1):
        g.add_edge(0, v)
    repeated = [u for u, d in g.degree() for _ in range(d)]
    for source in range(m + 1, n):
        targets = set()
        while len(targets) < m:
            targets.add(rnd.choice(repeated))
        for t in targets:
            g.add_edge(source, t)
        repeated.extend(targets)
        repeated.extend([source] * m)
    return g


def balanced_tree(r: int, h: int) -> SimpleGraph:
    """networkx.balanced_tree(r, h): breadth-first r-ary tree of height h."""
    n = h + 1 if r == 1 else (1 - r ** (h + 1)) // (1 - r)
    g = SimpleGraph(n)
    nxt, parents = 1, [0]
    while parents and nxt < n:
        source = parents.pop(0)
        for _ in range(r):
            if nxt >= n:
                break
            g.add_edge(source, nxt)
            parents.append(nxt)
            nxt += 1
    return g


def _grid_edges(rows: int, cols: int) -> tuple[int, list[tuple[int, int]]]:
    edges = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                edges.append((r * cols + c, r * cols + c + 1))
            if r + 1 < rows:
                edges.append((r * cols + c, (r + 1) * cols + c))
    return rows * cols, edges


def motif_edges(shape: str) -> tuple[int, list[tuple[int, int]]]:
    """The four CAL motif classes as (node count, edge list)."""
    if shape == "house":
        return 5, [(0, 1), (1, 2), (2, 3), (3, 0), (4, 0), (4, 1)]
    if shape == "cycle":
        return 6, [(i, (i + 1) % 6) for i in range(6)]
    if shape == "diamond":
        return 6, [(i, (i + 1) % 6) for i in range(6)] + [(5, 1), (4, 2)]
    if shape == "grid":
        return _grid_edges(2, 3)
    raise ValueError(shape)


def build_graph(context: str, shape: str, node_num: int,
                rng: np.random.Generator, nb_shapes: int = 1) -> SimpleGraph:
    """Basis + attached motif(s)."""
    if context == "ba":
        g = barabasi_albert_graph(node_num ** 2, 2, seed=int(rng.integers(2**31)))
    elif context == "tree":
        g = balanced_tree(node_num, 2)
    else:
        raise ValueError(context)
    n_basis = g.number_of_nodes()
    plugins = rng.choice(n_basis, nb_shapes, replace=False)
    start = n_basis
    for k in range(nb_shapes):
        n_s, edges = motif_edges(shape)
        for u in range(start, start + n_s):
            g.add_node(u)
        for u, v in edges:
            g.add_edge(start + u, start + v)
        g.add_edge(start, int(plugins[k]))
        start += n_s
    return g


def perturb(g: SimpleGraph, p: float, rng: np.random.Generator) -> SimpleGraph:
    """Add ``p * num_edges`` random non-existing edges."""
    extra = int(g.number_of_edges() * p)
    n = g.number_of_nodes()
    for _ in range(extra):
        while True:
            u = int(rng.integers(0, n))
            v = int(rng.integers(0, n))
            if u != v and not g.has_edge(u, v):
                break
        g.add_edge(u, v)
    return g


def degree_onehot(g: SimpleGraph, max_degree: int) -> np.ndarray:
    """One-hot degree capped at max_degree - 1."""
    x = np.zeros((g.number_of_nodes(), max_degree), np.float32)
    for node, deg in g.degree():
        x[node, min(deg, max_degree - 1)] = 1.0
    return x


def to_host_graph(g: SimpleGraph, y: int, x: np.ndarray) -> HostGraph:
    """Undirected graph -> both-direction edge list (PyG from_networkx)."""
    e = np.asarray(g.edges(), np.int32).reshape(-1, 2)
    senders = np.concatenate([e[:, 0], e[:, 1]])
    receivers = np.concatenate([e[:, 1], e[:, 0]])
    return HostGraph(x=x, senders=senders, receivers=receivers, y=y)


def make_graph(context: str, shape: str, label: int, node_num: int,
               max_degree: int, noise: float, rng: np.random.Generator,
               shape_num: int = 1, feature_dim: int = -1) -> HostGraph:
    g = build_graph(context, shape, node_num, rng, shape_num)
    if noise:
        g = perturb(g, noise, rng)
    if feature_dim >= 0:
        # one uniform vector per graph, constant across its nodes
        val = rng.uniform(0.0, 1.0, feature_dim).astype(np.float32)
        x = np.tile(val, (g.number_of_nodes(), 1))
    else:
        x = degree_onehot(g, max_degree)
    return to_host_graph(g, label, x)


def generate_synthetic_dataset(data_num: int = 2000, node_num: int = 15,
                               max_degree: int = 10, noise: float = 0.1,
                               shape_num: int = 1, seed: int = 666,
                               feature_dim: int = -1
                               ) -> Dict[str, Dict[str, List[HostGraph]]]:
    """dataset[context][shape] = data_num HostGraphs."""
    rng = np.random.default_rng(seed)
    dataset: Dict[str, Dict[str, List[HostGraph]]] = {c: {} for c in SYN_CONTEXTS}
    for label, shape in enumerate(SYN_CLASSES):
        for context in SYN_CONTEXTS:
            dataset[context][shape] = [
                make_graph(context, shape, label, node_num, max_degree, noise,
                           rng, shape_num, feature_dim=feature_dim)
                for _ in range(data_num)
            ]
    return dataset


def dataset_bias_split(dataset, bias: float, split=(7, 1, 2), total: int = 8000,
                       num_classes: int = 4, seed: int | None = None):
    """Confounded train/val vs balanced test split; returns (train, val,
    test, the) with ``the`` the edge-count threshold that recovers context."""
    bias_dict = {s: (bias if s == "house" else 1.0 - bias) for s in SYN_CLASSES}
    tr_ds, ba_ds = dataset["tree"], dataset["ba"]
    tr_split = total * split[0] / 10 / num_classes
    va_split = total * split[1] / 10 / num_classes
    te_split = total * split[2] / 10 / num_classes
    train, val, test = [], [], []
    edges_num = 0
    for shape in SYN_CLASSES:
        edges_num += tr_ds[shape][0].num_edges + ba_ds[shape][0].num_edges
        b = bias_dict[shape]
        n_tr_t, n_tr_b = int(tr_split * b), int(tr_split * (1 - b))
        n_va_t, n_va_b = int(va_split * b), int(va_split * (1 - b))
        n_te_t, n_te_b = int(te_split * 0.5), int(te_split * 0.5)
        t, a = tr_ds[shape], ba_ds[shape]
        train += t[:n_tr_t] + a[:n_tr_b]
        val += t[n_tr_t:n_tr_t + n_va_t] + a[n_tr_b:n_tr_b + n_va_b]
        test += (t[n_tr_t + n_va_t:n_tr_t + n_va_t + n_te_t]
                 + a[n_tr_b + n_va_b:n_tr_b + n_va_b + n_te_b])
    rng = np.random.default_rng(seed)
    for lst in (train, val, test):
        rng.shuffle(lst)
    the = float(edges_num) / (num_classes * 2)
    return train, val, test, the


def print_dataset_info(train_set, val_set, test_set, the: float):
    """Per-split tables of class x context counts, context inferred by
    comparing each graph's directed edge count with ``the``."""
    out = {}
    for title, ds in (("Train", train_set), ("Val   ", val_set),
                      ("Test  ", test_set)):
        tr = [0] * len(SYN_CLASSES)
        ba = [0] * len(SYN_CLASSES)
        for g in ds:
            (ba if g.num_edges > the else tr)[g.y] += 1
        total = sum(tr) + sum(ba)
        print("-" * 150)
        print(f"{title} Total:{total}")
        print("| Tree: House:{:<5d}, Cycle:{:<5d}, Grids:{:<5d}, Diams:{:<5d} ".format(*tr))
        print("| BA  : House:{:<5d}, Cycle:{:<5d}, Grids:{:<5d}, Diams:{:<5d} ".format(*ba))
        alls = [a + b for a, b in zip(tr, ba)]
        print("| All : House:{:<5d}, Cycle:{:<5d}, Grids:{:<5d}, Diams:{:<5d} ".format(*alls))
        bias = [100.0 * t / max(a, 1) for t, a in zip(tr, alls)]
        print("| BIAS: House:{:.1f}%, Cycle:{:.1f}%, Grids:{:.1f}%, Diams:{:.1f}%".format(*bias))
        print("-" * 150)
        out[title.strip()] = np.asarray(ba + tr, np.float32)
    return out
