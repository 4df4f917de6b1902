"""Feature-expansion pre-transform of the TU datasets (NumPy, on the host).

Counterpart of cal_tpu/data/feature_expansion.py (the reference's
``feature_expansion.py``): node features gain the degree, a one-hot capped
degree and normalized A^k x propagation features, in the order
``[x | deg | deg_onehot | akx]``; edge noise acts on the directed edge list
first; A^k x uses the symmetric deg^-1/2 norm with self-loop weight 1e-8;
``remove_edges`` replaces the edge list after the features ("nonself" keeps
only self-loops, "all" removes every edge); ``group_degree`` collapses the
nodes of degree 1..k into one mean super-node row each (``xg``).  The
networkx centralities (``cent``) are not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class FeatureExpander:
    """Per-graph transform: ``transform(x, edge_index, n) -> (x, e, xg)``."""

    def __init__(self, degree: bool = True, onehot_maxdeg: Optional[int] = 0, AK: int = 1,
                 centrality: bool = False, remove_edges: Optional[str] = None,
                 edge_noises_add: float = 0.0, edge_noises_delete: float = 0.0,
                 group_degree: int = 0, seed: int = 0):
        if centrality:
            raise NotImplementedError(
                "the 'cent' feature (networkx centralities) is not ported "
                "(ROADMAP queue 1 item 8c)")
        remove_edges = remove_edges or "none"
        if remove_edges not in ("none", "nonself", "all"):
            raise ValueError(remove_edges)
        self.degree = degree
        self.onehot_maxdeg = onehot_maxdeg
        self.AK = AK or 0
        self.remove_edges = remove_edges
        self.edge_noises_add = edge_noises_add
        self.edge_noises_delete = edge_noises_delete
        self.group_degree = group_degree
        self.edge_norm_diag = 1e-8
        self.rng = np.random.default_rng(seed)

    def transform(self, x: Optional[np.ndarray], edge_index: np.ndarray, num_nodes: int
                  ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Returns ``(x, edge_index, xg)``; ``xg`` is None unless
        ``group_degree > 0`` (x then keeps the surviving nodes only)."""
        if x is None:
            x = np.ones((num_nodes, 1), np.float32)
        x = np.asarray(x, np.float32)
        edge_index = np.asarray(edge_index, np.int64).reshape(2, -1)
        if self.edge_noises_delete > 0:
            e = edge_index.shape[1]
            keep = e - int(e * self.edge_noises_delete)
            edge_index = edge_index[:, self.rng.permutation(e)[:keep]]
        if self.edge_noises_add > 0:
            n_new = int(edge_index.shape[1] * self.edge_noises_add)
            new = self.rng.integers(0, num_nodes, size=(2, n_new))
            edge_index = np.concatenate([edge_index, new], axis=1)

        deg, deg_onehot = self._compute_degree(edge_index, num_nodes)
        akx = self._compute_akx(num_nodes, x, edge_index)
        x = np.concatenate([x, deg, deg_onehot, akx], axis=1)

        if self.remove_edges == "all":
            edge_index = np.zeros((2, 0), np.int64)
        elif self.remove_edges == "nonself":
            loop = np.arange(num_nodes, dtype=np.int64)
            edge_index = np.stack([loop, loop])

        xg = None
        if self.group_degree > 0:
            if self.remove_edges != "all":
                raise ValueError("group_degree needs remove_edges 'all'")
            x, xg = self._group_by_degree(x, deg.reshape(-1))
        return x.astype(np.float32), edge_index, xg

    __call__ = transform

    def _group_by_degree(self, x, deg_base):
        """Degree-k nodes (k = 1..group_degree) become one ``[count | mean]``
        super-node each; degree-0 nodes are dropped and an empty group gives
        ``[0 | zeros]`` (the reference's filter chain); x becomes one zero row
        when no node survives."""
        x_base = x
        super_nodes = []
        zero_row = np.zeros((1, x.shape[1]), np.float32)
        for k in range(1, self.group_degree + 1):
            eq, gt = deg_base == k, deg_base > k
            x_to_group = x_base[eq]
            x_base, deg_base = x_base[gt], deg_base[gt]
            count = np.full((1, 1), x_to_group.shape[0], np.float32)
            mean = zero_row if x_to_group.shape[0] == 0 else x_to_group.mean(0, keepdims=True)
            super_nodes.append(np.concatenate([count, mean], axis=1))
        if x_base.shape[0] == 0:
            x_base = zero_row
        xg = np.concatenate(super_nodes, axis=0).reshape(1, -1)
        return x_base.astype(np.float32), xg.astype(np.float32)

    def _compute_degree(self, edge_index, num_nodes):
        deg = np.bincount(edge_index[0], minlength=num_nodes).astype(np.float32)
        if self.onehot_maxdeg is not None and self.onehot_maxdeg > 0:
            capped = np.minimum(deg, self.onehot_maxdeg).astype(np.int64)
            onehot = np.zeros((num_nodes, self.onehot_maxdeg + 1), np.float32)
            onehot[np.arange(num_nodes), capped] = 1.0
        else:
            onehot = np.zeros((num_nodes, 0), np.float32)
        deg_col = deg[:, None] if self.degree else np.zeros((num_nodes, 0), np.float32)
        return deg_col, onehot

    def _compute_akx(self, num_nodes, x, edge_index):
        """[A_norm x | A_norm^2 x | ...] with the diag-1e-8 symmetric norm."""
        if self.AK <= 0:
            return np.zeros((num_nodes, 0), np.float32)
        row, col = edge_index
        keep = row != col
        loop = np.arange(num_nodes, dtype=np.int64)
        row = np.concatenate([row[keep], loop])
        col = np.concatenate([col[keep], loop])
        w = np.concatenate([np.ones(int(keep.sum()), np.float64),
                            np.full(num_nodes, self.edge_norm_diag)])
        deg = np.zeros(num_nodes, np.float64)
        np.add.at(deg, row, w)
        with np.errstate(divide="ignore"):
            dis = np.where(deg > 0, deg ** -0.5, 0.0)
        norm = dis[row] * w * dis[col]
        xs, cur = [], x.astype(np.float64)
        for _ in range(self.AK):
            out = np.zeros_like(cur)
            np.add.at(out, col, norm[:, None] * cur[row])    # source -> target
            cur = out
            xs.append(cur.astype(np.float32))
        return np.concatenate(xs, axis=1)
