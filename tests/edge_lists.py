"""Edge lists shared by the CPU and CUDA tests of the edge-formulated dense
GAT.  NumPy only: the CUDA tests import this without JAX or cal_tpu."""
import numpy as np


def hub_edges(b=3, n=48, seed=2):
    """A sorted flat edge list (int32) of special rows: in graph 0 a
    receiver hub (node 0, 100 slots: four 32-slot chunks, duplicates among
    them), a sender hub (node 5, 70 slots), a node of 40 self loops only (a
    heavy row and sender that adds nothing) and one of 3 self loops only;
    graph 1 without an edge; graph 2 with 30 random edges; 37 padding
    slots."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([np.zeros(100, np.int64), rng.integers(1, 40, 70), np.full(40, 41),
                        [42, 42, 42], rng.integers(0, 40, 30)])
    s = np.concatenate([rng.integers(1, 40, 100), np.full(70, 5), np.full(40, 41),
                        [42, 42, 42], rng.integers(0, 40, 30)])
    g = np.concatenate([np.zeros(213, np.int64), np.full(30, 2)])
    ef = np.sort((g * n + r) * n + s)
    return np.concatenate([ef, np.full(37, b * n * n)]).astype(np.int32)
