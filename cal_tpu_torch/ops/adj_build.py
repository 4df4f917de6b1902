"""Dense count adjacency [B, N, N] from the sorted flat edge list.

Counterpart of cal_tpu/ops/pallas_adj.py::adj_build.  On a CUDA tensor the
wrapper launches the hand-written kernel ``csrc/adj_build.cu`` (its header
says how it is bound and designed); on a CPU tensor it runs the plain twin
``adj_build_plain``.  Counts are exact in f32 and bf16 (integers <= 256).
"""
from __future__ import annotations

import ctypes

import torch

from cal_tpu_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def adj_build_plain(edge_flat: torch.Tensor, b: int, n: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Scatter-add of ones at ``edge_flat``; out-of-range indices (the
    padding sentinel ``b*n*n``) are dropped."""
    total = b * n * n
    keep = (edge_flat >= 0) & (edge_flat < total)
    flat = torch.zeros(total, dtype=torch.float32, device=edge_flat.device)
    flat.index_add_(0, edge_flat[keep].long(),
                    torch.ones((), dtype=torch.float32,
                               device=edge_flat.device).expand(int(keep.sum())))
    return flat.to(dtype).reshape(b, n, n)


def _fn():
    fn = build.load("adj_build").adj_build_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, i, i, i, i, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def adj_build(edge_flat: torch.Tensor, b: int, n: int,
              dtype: torch.dtype) -> torch.Tensor:
    """edge_flat [E] int32/int64, sorted ascending, entry ``(g*n + r)*n + s``
    per edge s -> r -> adj [b, n, n] of multiplicity counts (row = receiver).
    One launch.  ``.launches`` counts kernel launches."""
    if edge_flat.dim() != 1 or edge_flat.dtype not in (torch.int32, torch.int64):
        raise ValueError("edge_flat must be a 1-D int32/int64 tensor")
    if dtype not in _DTYPES:
        raise ValueError(f"adj_build: unsupported dtype {dtype}")
    if edge_flat.device.type == "cpu":
        return adj_build_plain(edge_flat, b, n, dtype)
    if edge_flat.device.type != "cuda":
        raise ValueError(f"adj_build: unsupported device {edge_flat.device}")
    if edge_flat.shape[0] >= 2**31:
        raise ValueError("adj_build kernel supports fewer than 2^31 edges")
    edge_flat = edge_flat.contiguous()
    out = torch.empty((b, n, n), dtype=dtype, device=edge_flat.device)
    err = _fn()(edge_flat.data_ptr(), 32 if edge_flat.dtype == torch.int32 else 64,
                edge_flat.shape[0], b, n, _DTYPES[dtype], out.data_ptr(),
                torch.cuda.current_stream(edge_flat.device).cuda_stream)
    build.check(err, "adj_build")
    adj_build.launches += 1
    return out


adj_build.launches = 0
