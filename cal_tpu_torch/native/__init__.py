"""Native (C++) batch packer of the port, loaded with ctypes.

Counterpart of cal_tpu/native (``pack.cpp`` and its ``PackedDataset``
binding).  ``pack.cpp`` is built with g++ at first use into
``build/cal_tpu_torch_native/`` beside the package (a temporary file, then
``os.replace``, so processes that build at once do not race) and rebuilt
when the source is newer.  A failed build raises: there is no fallback.  The
NumPy packers stay as the plain twins (``graph.pack_dense``,
``data.loader._SparseDataset``); the loader takes them only when asked
(``Loader(..., packer="numpy")``).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

from cal_tpu_torch.graph import PackedDenseBatch, sparse_batch

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "pack.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "cal_tpu_torch_native")
LIB = os.path.join(BUILD_DIR, "libcalpack.so")

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile ``pack.cpp`` into ``LIB`` when it is missing or older than
    the source; returns its path.  Raises if g++ is missing or fails."""
    if os.path.exists(LIB) and os.path.getmtime(LIB) >= os.path.getmtime(SRC):
        return LIB
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native packer cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.{threading.get_ident()}.tmp"
    res = subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, SRC],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC}:\n{res.stderr}")
    os.replace(tmp, LIB)
    return LIB


def get_lib() -> ctypes.CDLL:
    """The loaded packer library, built if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i = ctypes.c_int
            lib.pack_dense_batch.restype = i
            lib.pack_dense_batch.argtypes = [f32p, i64p, i32p, i32p, i64p, i32p, i32p, i,
                                             i, i, i, i, f32p, i64p, i32p, i32p]
            lib.pack_sparse_batch.restype = i
            lib.pack_sparse_batch.argtypes = [f32p, i64p, i32p, i32p, i64p, i32p, i32p, i,
                                              i, i, i, i, f32p, i32p, i32p, u8p, u8p, i32p,
                                              i32p, u8p, i64p, i64p]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class PackedDataset:
    """Whole-dataset concatenated arrays, built once, for native packing.

    Edges are presorted by (receiver, sender) within each graph, so a batch,
    whose per-slot offsets increase, is a concatenation of sorted runs and
    needs no per-batch sort; ``send_order`` (made at the first sparse
    batch) holds each graph's edges in stable sender order (global edge
    ids) for the sparse batch's sender CSR."""

    def __init__(self, graphs):
        self.n = len(graphs)
        self.feat = graphs[0].x.shape[1]
        ns = np.array([g.num_nodes for g in graphs], np.int64)
        es = np.array([g.num_edges for g in graphs], np.int64)
        self.node_off = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)
        self.edge_off = np.concatenate([[0], np.cumsum(es)]).astype(np.int64)
        self.all_x = np.ascontiguousarray(
            np.concatenate([g.x for g in graphs], axis=0), np.float32)
        recv = np.concatenate([g.receivers for g in graphs]).astype(np.int64)
        send = np.concatenate([g.senders for g in graphs]).astype(np.int64)
        self._gid = np.repeat(np.arange(self.n), es)
        order = np.lexsort((send, recv, self._gid))   # per-graph (recv, send) sort
        self.all_recv = np.ascontiguousarray(recv[order], np.int32)
        self.all_send = np.ascontiguousarray(send[order], np.int32)
        self.all_y = np.asarray([g.y for g in graphs], np.int32)
        self._send_order = None

    @property
    def send_order(self) -> np.ndarray:
        if self._send_order is None:   # stable: ties keep the receiver order
            self._send_order = np.ascontiguousarray(np.lexsort((self.all_send, self._gid)),
                                                    np.int64)
        return self._send_order

    def _sizes(self, idx):
        return (self.node_off[idx + 1] - self.node_off[idx],
                self.edge_off[idx + 1] - self.edge_off[idx])

    def pack_dense(self, idx, num_graphs: int, node_budget: int, edge_budget: int):
        """-> (x, edge_flat, n_nodes, y) NumPy arrays; edge_flat int64,
        sorted.  Raises ValueError, with ``graph.pack_dense``'s messages, on
        a batch over a budget."""
        idx = np.ascontiguousarray(idx, np.int32)
        ns, es = self._sizes(idx.astype(np.int64))
        if len(idx) > num_graphs:
            raise ValueError(f"{len(idx)} graphs > budget {num_graphs}")
        if int(es.sum()) > edge_budget:
            raise ValueError(f"{int(es.sum())} edges > budget {edge_budget}")
        over = ns[ns > node_budget]
        if over.size:
            raise ValueError(f"graph has {int(over[0])} nodes > node budget {node_budget}")
        x = np.empty((num_graphs, node_budget, self.feat), np.float32)
        edge_flat = np.empty(edge_budget, np.int64)
        n_nodes = np.empty(num_graphs, np.int32)
        y = np.empty(num_graphs, np.int32)
        rc = get_lib().pack_dense_batch(
            _ptr(self.all_x, ctypes.c_float), _ptr(self.node_off, ctypes.c_int64),
            _ptr(self.all_recv, ctypes.c_int32), _ptr(self.all_send, ctypes.c_int32),
            _ptr(self.edge_off, ctypes.c_int64), _ptr(self.all_y, ctypes.c_int32),
            _ptr(idx, ctypes.c_int32), len(idx), self.feat, node_budget, edge_budget,
            num_graphs, _ptr(x, ctypes.c_float), _ptr(edge_flat, ctypes.c_int64),
            _ptr(n_nodes, ctypes.c_int32), _ptr(y, ctypes.c_int32))
        if rc != 0:
            raise RuntimeError(f"pack_dense_batch returned {rc} after the budget checks")
        return x, edge_flat, n_nodes, y

    def pack_dense_batch(self, idx, num_graphs: int, node_budget: int,
                         edge_budget: int) -> PackedDenseBatch:
        """``graph.pack_dense`` of the graphs ``idx``, bit for bit: the
        edge list int32 when B*N*N < 2^31, ``eg_budget`` the batch's largest
        edge count."""
        x, edge_flat, n_nodes, y = self.pack_dense(idx, num_graphs, node_budget, edge_budget)
        _, es = self._sizes(np.asarray(idx, np.int64))
        eg = int(es.max()) if len(es) else 0
        if num_graphs * node_budget * node_budget < 2**31:
            edge_flat = edge_flat.astype(np.int32)
        return PackedDenseBatch(x, edge_flat, n_nodes, y, eg)

    def pack_sparse(self, idx, num_graphs: int, num_nodes: int, num_edges: int,
                    send_perm: bool = False):
        """-> (x, senders, receivers, edge_mask, node_mask, node_graph, y,
        graph_mask) NumPy arrays (receiver-sorted edges), and the batch's
        stable sender order when ``send_perm``.  Raises ValueError, with
        ``_SparseDataset.pack``'s message, on a batch over a budget."""
        idx = np.ascontiguousarray(idx, np.int32)
        ns, es = self._sizes(idx.astype(np.int64))
        tot_n, tot_e = int(ns.sum()), int(es.sum())
        if len(idx) > num_graphs or tot_n > num_nodes or tot_e > num_edges:
            raise ValueError(f"batch needs ({len(idx)} graphs, {tot_n} nodes, {tot_e} edges)"
                             f" > budget ({num_graphs}, {num_nodes}, {num_edges})")
        x = np.empty((num_nodes, self.feat), np.float32)
        senders = np.empty(num_edges, np.int32)
        receivers = np.empty(num_edges, np.int32)
        edge_mask = np.empty(num_edges, np.uint8)
        node_mask = np.empty(num_nodes, np.uint8)
        node_graph = np.empty(num_nodes, np.int32)
        y = np.empty(num_graphs, np.int32)
        graph_mask = np.empty(num_graphs, np.uint8)
        perm = np.empty(num_edges, np.int64) if send_perm else None
        rc = get_lib().pack_sparse_batch(
            _ptr(self.all_x, ctypes.c_float), _ptr(self.node_off, ctypes.c_int64),
            _ptr(self.all_recv, ctypes.c_int32), _ptr(self.all_send, ctypes.c_int32),
            _ptr(self.edge_off, ctypes.c_int64), _ptr(self.all_y, ctypes.c_int32),
            _ptr(idx, ctypes.c_int32), len(idx), self.feat, num_nodes, num_edges, num_graphs,
            _ptr(x, ctypes.c_float), _ptr(senders, ctypes.c_int32),
            _ptr(receivers, ctypes.c_int32), _ptr(edge_mask, ctypes.c_uint8),
            _ptr(node_mask, ctypes.c_uint8), _ptr(node_graph, ctypes.c_int32),
            _ptr(y, ctypes.c_int32), _ptr(graph_mask, ctypes.c_uint8),
            _ptr(self.send_order, ctypes.c_int64) if send_perm else None,
            _ptr(perm, ctypes.c_int64) if send_perm else None)
        if rc != 0:
            raise RuntimeError(f"pack_sparse_batch returned {rc} after the budget checks")
        leaves = (x, senders, receivers, edge_mask.astype(bool), node_mask.astype(bool),
                  node_graph, y, graph_mask.astype(bool))
        return leaves + (perm,) if send_perm else leaves

    def pack_sparse_batch(self, idx, num_graphs: int, num_nodes: int, num_edges: int):
        """``_SparseDataset.pack`` of the graphs ``idx``: the GraphBatch
        with both CSR forms."""
        *leaves, perm = self.pack_sparse(idx, num_graphs, num_nodes, num_edges, send_perm=True)
        return sparse_batch(*leaves, send_perm=perm)
