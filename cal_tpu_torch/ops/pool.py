"""Sorted segment sum of node rows per graph (the sparse ``global_add_pool``).

Counterpart of cal_tpu/ops/pallas_pool.py ``mxu_pool`` with its custom VJP:
[V, H] -> [num_segments, H] f32, padded nodes in the trash segment
``num_segments - 1``.  ``segment_pool`` is a ``torch.autograd.Function``
differentiable in x: its forward (K4) and backward (K7, dx[v] =
dpooled[node_graph[v]] in x's dtype) launch the hand-written kernels of
``csrc/pool.cu`` (its header gives the design) on CUDA tensors and run their
plain twins ``segment_pool_plain`` and ``segment_pool_bwd_plain`` on CPU
tensors.  The forward kernel needs ``node_graph`` non-decreasing, as the
sparse packer lays it out, and keeps arrival counters for each stream it
launches on, which each launch leaves at 0: launches on one stream are
ordered, so no two of them share counters at once.  A CUDA graph captures
K4 only on a stream it has run on before the capture (its counters are made
outside the graph).
"""
from __future__ import annotations

import ctypes

import torch

from cal_tpu_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_RUN = 32                   # K4's rows a warp (pool.cu kRun)
_arrivals: dict = {}        # (device, stream) -> K4's int32 arrival counters, 0 between launches


def segment_pool_plain(x: torch.Tensor, node_graph: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Plain twin: f32 scatter-add of x's rows by node_graph."""
    out = torch.zeros((num_segments, x.shape[1]), dtype=torch.float32, device=x.device)
    return out.index_add_(0, node_graph.long(), x.float())


def segment_pool_bwd_plain(dpooled: torch.Tensor, node_graph: torch.Tensor,
                           dtype: torch.dtype) -> torch.Tensor:
    """Plain twin of K7: the rows of dpooled gathered by node_graph, in f32,
    rounded once to ``dtype``."""
    return dpooled.float()[node_graph.long()].to(dtype)


def _lib():
    lib = build.load("pool")
    if lib.pool_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.pool_launch.argtypes = [vp, i, vp, i, i, i, vp, vp, vp, vp, vp]
        lib.pool_launch.restype = ctypes.c_int
        lib.pool_bwd_launch.argtypes = [vp, vp, i, i, i, vp, vp]
        lib.pool_bwd_launch.restype = ctypes.c_int
    return lib


def _check_width(what, h):
    if h % 32 or h // 32 not in (1, 2, 4, 8):
        raise ValueError(f"{what} kernel takes H in 32, 64, 128, 256, got {h}")


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` of K4's arrival counters for launches on ``stream`` of
    ``device`` (zeros, made on that stream once and grown when a call needs
    more; each launch leaves them 0).  Raises when they would be made while
    the stream is being captured."""
    buf = _arrivals.get((device, stream))
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("segment_pool: call it once on this stream, with at least "
                               "this many segments, before capturing the stream")
        buf = _arrivals[(device, stream)] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf


def _pool_fwd(x: torch.Tensor, node_graph: torch.Tensor, num_segments: int) -> torch.Tensor:
    """K4 on CUDA tensors, its plain twin on CPU tensors (no autograd)."""
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
    _check_width("segment_pool", h)
    x, node_graph = x.contiguous(), node_graph.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("segment_pool: x must be 16-byte aligned")
    out = torch.empty((num_segments, h), dtype=torch.float32, device=x.device)
    part = torch.empty((-(-v // _RUN), 2, h), dtype=torch.float32, device=x.device)
    span = torch.empty((num_segments, 2), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().pool_launch(x.data_ptr(), _DTYPES[x.dtype], node_graph.data_ptr(), v, h,
                             num_segments, out.data_ptr(), part.data_ptr(), span.data_ptr(),
                             _counters(x.device, stream, num_segments).data_ptr(), stream)
    build.check(err, "segment_pool")
    segment_pool.launches += 1
    return out


def segment_pool_bwd(dpooled: torch.Tensor, node_graph: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """K7: dpooled [num_segments, H] f32, node_graph [V] int32 -> dx [V, H]
    in ``dtype`` (float32 or bfloat16), dx[v] = dpooled[node_graph[v]].
    One launch, right for any node_graph, fastest on a sorted one (each
    lane reloads its dpooled slice only where the id changes).
    ``.launches`` counts kernel launches."""
    if dpooled.dim() != 2 or dpooled.dtype != torch.float32 or dtype not in _DTYPES:
        raise ValueError("segment_pool_bwd: dpooled must be [G, H] float32, dx float32 or "
                         "bfloat16")
    h = dpooled.shape[1]
    if node_graph.dim() != 1 or node_graph.device != dpooled.device:
        raise ValueError("segment_pool_bwd: node_graph must be [V] on dpooled's device")
    if dpooled.device.type == "cpu":
        return segment_pool_bwd_plain(dpooled, node_graph, dtype)
    if dpooled.device.type != "cuda":
        raise ValueError(f"segment_pool_bwd: unsupported device {dpooled.device}")
    if node_graph.dtype != torch.int32:
        raise ValueError("segment_pool_bwd: node_graph must be int32")
    _check_width("segment_pool_bwd", h)
    dpooled, node_graph = dpooled.contiguous(), node_graph.contiguous()
    if dpooled.data_ptr() % 16:
        raise ValueError("segment_pool_bwd: dpooled must be 16-byte aligned")
    v = node_graph.shape[0]
    dx = torch.empty((v, h), dtype=dtype, device=dpooled.device)
    err = _lib().pool_bwd_launch(dpooled.data_ptr(), node_graph.data_ptr(), v, h,
                                 _DTYPES[dtype], dx.data_ptr(),
                                 torch.cuda.current_stream(dpooled.device).cuda_stream)
    build.check(err, "segment_pool_bwd")
    segment_pool_bwd.launches += 1
    return dx


class _SegmentPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, node_graph, num_segments):
        ctx.save_for_backward(node_graph)
        ctx.dtype = x.dtype
        return _pool_fwd(x, node_graph, num_segments)

    @staticmethod
    def backward(ctx, dpooled):
        (node_graph,) = ctx.saved_tensors
        return segment_pool_bwd(dpooled, node_graph, ctx.dtype), None, None


def segment_pool(x: torch.Tensor, node_graph: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """x [V, H] f32/bf16, node_graph [V] int32 in [0, num_segments) ->
    [num_segments, H] f32 segment sums; differentiable in x.
    ``.launches`` counts forward kernel launches, ``segment_pool_bwd.launches``
    backward ones."""
    return _SegmentPool.apply(x, node_graph, num_segments)


segment_pool.launches = 0
segment_pool_bwd.launches = 0
