"""Sorted segment sum of node rows per graph (the sparse ``global_add_pool``).

Counterpart of the forward of cal_tpu/ops/pallas_pool.py ``mxu_pool``:
[V, H] -> [num_segments, H] f32, padded nodes in the trash segment
``num_segments - 1``.  On a CUDA tensor ``segment_pool`` launches the
hand-written kernel of ``csrc/pool.cu`` (its header gives the design); on a
CPU tensor it runs the plain twin ``segment_pool_plain``.  The kernel needs
``node_graph`` non-decreasing, as the sparse packer lays it out.  No
gradient: the sparse training slice adds the backward.
"""
from __future__ import annotations

import ctypes

import torch

from cal_tpu_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def segment_pool_plain(x: torch.Tensor, node_graph: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Plain twin: f32 scatter-add of x's rows by node_graph."""
    out = torch.zeros((num_segments, x.shape[1]), dtype=torch.float32, device=x.device)
    return out.index_add_(0, node_graph.long(), x.float())


def _fn():
    fn = build.load("pool").pool_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, i, i, i, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def segment_pool(x: torch.Tensor, node_graph: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """x [V, H] f32/bf16, node_graph [V] int32 in [0, num_segments) ->
    [num_segments, H] f32 segment sums.  ``.launches`` counts kernel
    launches."""
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise ValueError("segment_pool: x must be [V, H] float32 or bfloat16")
    v, h = x.shape
    if tuple(node_graph.shape) != (v,) or node_graph.device != x.device:
        raise ValueError("segment_pool: node_graph must be [V] on x's device")
    if x.device.type == "cpu":
        return segment_pool_plain(x, node_graph, num_segments)
    if x.device.type != "cuda":
        raise ValueError(f"segment_pool: unsupported device {x.device}")
    if node_graph.dtype != torch.int32:
        raise ValueError("segment_pool: node_graph must be int32")
    if h % 32 or h // 32 not in (1, 2, 4, 8):
        raise ValueError(f"segment_pool kernel takes H in 32, 64, 128, 256, got {h}")
    x, node_graph = x.contiguous(), node_graph.contiguous()
    if x.data_ptr() % ((h // 32) * x.element_size()):
        raise ValueError("segment_pool: x rows are misaligned")
    out = torch.empty((num_segments, h), dtype=torch.float32, device=x.device)
    err = _fn()(x.data_ptr(), _DTYPES[x.dtype], node_graph.data_ptr(), v, h, num_segments,
                out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "segment_pool")
    segment_pool.launches += 1
    return out


segment_pool.launches = 0
