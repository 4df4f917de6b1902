"""TU-Dortmund graph-kernel datasets from their text files.

Counterpart of cal_tpu/data/tu.py (``read_tu_data``, ``split_graphs``,
``prune_edges``, ``TUDataset``; the reference's ``tu_dataset.py`` and
PyG's ``read_tu_data``): parses ``{name}_A.txt``, ``graph_indicator``,
``graph_labels`` and the optional ``node_labels`` / ``node_attributes``
into NumPy arrays, slices them into per-graph :class:`HostGraph` records,
applies an optional pre-transform (``FeatureExpander``) and caches the
processed graphs keyed by ``feat_str``.

The port downloads nothing: a dataset whose raw files are missing raises
and names the generator of the repo's synthetic stand-ins.  Its cache file
(``processed/torch_data_{tag}.pkl``) is its own, so neither package loads
the other's pickle.  ``pruning_percent`` drops that share of each graph's
undirected edges (seeded, both directions together) before the feature
expansion, as cal_tpu does.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from cal_tpu_torch.graph import HostGraph

_CACHE_VERSION = 1


def _read_numeric(path: str, dtype) -> np.ndarray:
    """Parse a TU txt file (comma/space separated numbers) into a 2-D array."""
    with open(path) as f:
        text = f.read()
    rows = [ln for ln in text.splitlines() if ln.strip()]
    ncol = len(rows[0].replace(",", " ").split()) if rows else 1
    flat = np.array(text.replace(",", " ").split(), dtype=dtype)
    return flat.reshape(-1, ncol)


def _one_hot_columns(labels: np.ndarray) -> np.ndarray:
    """One-hot each integer column after shifting it to start at 0 (PyG
    read_tu_data's node-label handling)."""
    blocks = []
    for c in range(labels.shape[1]):
        col = labels[:, c].astype(np.int64)
        col = col - col.min()
        oh = np.zeros((col.shape[0], int(col.max()) + 1), np.float32)
        oh[np.arange(col.shape[0]), col] = 1.0
        blocks.append(oh)
    return np.concatenate(blocks, axis=1)


def _coalesce(edge_index: np.ndarray) -> np.ndarray:
    """Drop self-loops and duplicate directed edges; sort by (row, col)."""
    row, col = edge_index
    keep = row != col
    row, col = row[keep], col[keep]
    n = max(int(col.max()) + 1 if col.size else 1, 1)
    flat = np.unique(row.astype(np.int64) * n + col.astype(np.int64))
    return np.stack([flat // n, flat % n]).astype(np.int64)


@dataclasses.dataclass
class TUData:
    """Whole-dataset arrays before the split into graphs."""

    x: Optional[np.ndarray]        # [N, num_node_attributes + num_node_labels]
    edge_index: np.ndarray         # [2, E] coalesced, global node ids
    y: np.ndarray                  # [G] labels remapped to 0..C-1
    node_graph: np.ndarray         # [N] graph id per node
    num_node_attributes: int
    num_node_labels: int


def read_tu_data(raw_dir: str, name: str) -> TUData:
    """Parse the TU text format from ``raw_dir``."""
    pre = os.path.join(raw_dir, f"{name}_")
    edge_index = _read_numeric(pre + "A.txt", np.int64).T - 1       # 1-based -> 0
    node_graph = _read_numeric(pre + "graph_indicator.txt", np.int64)[:, 0] - 1
    y_raw = _read_numeric(pre + "graph_labels.txt", np.int64)[:, 0]
    _, y = np.unique(y_raw, return_inverse=True)                     # sorted-unique remap
    attrs = None
    if os.path.exists(pre + "node_attributes.txt"):
        attrs = _read_numeric(pre + "node_attributes.txt", np.float32)
    labels_oh = None
    if os.path.exists(pre + "node_labels.txt"):
        labels_oh = _one_hot_columns(_read_numeric(pre + "node_labels.txt", np.int64))
    parts = [p for p in (attrs, labels_oh) if p is not None]
    return TUData(
        x=np.concatenate(parts, axis=1) if parts else None,
        edge_index=_coalesce(edge_index),
        y=y.astype(np.int64),
        node_graph=node_graph,
        num_node_attributes=0 if attrs is None else attrs.shape[1],
        num_node_labels=0 if labels_oh is None else labels_oh.shape[1],
    )


def split_graphs(d: TUData, use_node_attr: bool = True
                 ) -> List[Tuple[Optional[np.ndarray], np.ndarray, int]]:
    """Per-graph ``(x, edge_index, y)`` with local node ids.
    ``use_node_attr=False`` strips the leading attribute columns, keeping the
    one-hot node-label block."""
    num_graphs = int(d.node_graph.max()) + 1 if d.node_graph.size else 0
    node_offset = np.zeros(num_graphs + 1, np.int64)
    node_offset[1:] = np.cumsum(np.bincount(d.node_graph, minlength=num_graphs))
    x = d.x
    if x is not None and not use_node_attr:
        x = x[:, d.num_node_attributes:]
    # edges never cross graphs in TU data
    edge_graph = d.node_graph[d.edge_index[0]]
    order = np.argsort(edge_graph, kind="stable")
    ei = d.edge_index[:, order]
    e_starts = np.searchsorted(edge_graph[order], np.arange(num_graphs + 1))
    graphs = []
    for g in range(num_graphs):
        n0, n1 = node_offset[g], node_offset[g + 1]
        e = ei[:, e_starts[g]:e_starts[g + 1]] - n0
        graphs.append((None if x is None else x[n0:n1], e, int(d.y[g])))
    return graphs


def prune_edges(edge_index: np.ndarray, percent: float,
                rng: np.random.Generator) -> np.ndarray:
    """Drop ``percent`` of a graph's undirected edges at random, both
    directions of a drawn edge together; one-directional edges are drawn
    on their own at the same rate."""
    if percent <= 0.0 or edge_index.shape[1] == 0:
        return edge_index
    s, r = edge_index
    n = max(int(edge_index.max()) + 1, 1)
    key = np.minimum(s, r).astype(np.int64) * n + np.maximum(s, r).astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    keep_pair = rng.random(uniq.shape[0]) >= percent
    return edge_index[:, keep_pair[inv]]


class TUDataset(Sequence):
    """A processed TU dataset: a sequence of :class:`HostGraph`.

    Raw files under ``{root}/{name}/raw/{name}_*.txt``; the port's cache at
    ``{root}/{name}/processed/torch_data_{feat_str}.pkl``."""

    def __init__(self, root: str, name: str, pre_transform: Optional[Callable] = None,
                 use_node_attr: bool = True, feat_str: str = "",
                 pruning_percent: float = 0.0, pruning_seed: int = 12345):
        self.root, self.name, self.feat_str = root, name, feat_str
        self.pruning_percent = float(pruning_percent)
        self.pruning_seed = pruning_seed
        self.raw_dir = os.path.join(root, name, "raw")
        self.processed_dir = os.path.join(root, name, "processed")
        self._graphs: List[HostGraph] = []
        self.num_classes = 0
        if not self._load_cache():
            a_txt = os.path.join(self.raw_dir, f"{name}_A.txt")
            if not os.path.exists(a_txt):
                raise FileNotFoundError(
                    f"{a_txt} not found: the port downloads nothing.  Write the raw "
                    f"files there, e.g. python -m benchmarks.gen_reddit_synthetic "
                    f"--root {root} (SYNREDDIT) or benchmarks.gen_tu_synthetic (SYNNCI)")
            self._process(pre_transform, use_node_attr)
            self._save_cache()

    def _process(self, pre_transform, use_node_attr) -> None:
        d = read_tu_data(self.raw_dir, self.name)
        self.num_classes = int(d.y.max()) + 1 if d.y.size else 0
        rng = (np.random.default_rng(self.pruning_seed)
               if self.pruning_percent > 0 else None)
        graphs = []
        for x, e, y in split_graphs(d, use_node_attr=use_node_attr):
            if rng is not None:
                e = prune_edges(e, self.pruning_percent, rng)
            n = x.shape[0] if x is not None else (int(e.max()) + 1 if e.size else 1)
            xg = None
            if pre_transform is not None:
                x, e, xg = pre_transform(x, e, n)
            elif x is None:
                x = np.ones((n, 1), np.float32)
            graphs.append(HostGraph(x=np.asarray(x, np.float32),
                                    senders=np.asarray(e[0], np.int32),
                                    receivers=np.asarray(e[1], np.int32), y=y, xg=xg))
        self._graphs = graphs

    @property
    def _cache_path(self) -> str:
        tag = self.feat_str or "raw"
        if self.pruning_percent > 0:
            tag = f"{tag}_{self.pruning_percent * 100:g}"
        return os.path.join(self.processed_dir, f"torch_data_{tag}.pkl")

    def _save_cache(self) -> None:
        os.makedirs(self.processed_dir, exist_ok=True)
        payload = {"version": _CACHE_VERSION, "name": self.name, "feat_str": self.feat_str,
                   "pruning_percent": self.pruning_percent, "num_classes": self.num_classes,
                   "graphs": [(g.x, g.senders, g.receivers, g.y, g.xg) for g in self._graphs]}
        with open(self._cache_path, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)

    def _load_cache(self) -> bool:
        try:
            with open(self._cache_path, "rb") as f:
                payload = pickle.load(f)
        except (OSError, pickle.UnpicklingError, EOFError):
            return False
        if (payload.get("version") != _CACHE_VERSION or payload.get("name") != self.name
                or payload.get("feat_str") != self.feat_str
                or payload.get("pruning_percent", 0.0) != self.pruning_percent):
            return False
        self.num_classes = payload["num_classes"]
        self._graphs = [HostGraph(x=x, senders=s, receivers=r, y=y, xg=xg)
                        for x, s, r, y, xg in payload["graphs"]]
        return True

    @property
    def num_features(self) -> int:
        return int(self._graphs[0].x.shape[1]) if self._graphs else 0

    def __len__(self) -> int:
        return len(self._graphs)

    def __getitem__(self, i):
        return self._graphs[i]

    def __iter__(self):
        return iter(self._graphs)

    def __repr__(self) -> str:
        return f"{self.name}({len(self)})"
