"""Both masked causal GCN convs in one kernel (dense layout), forward.

Counterpart of cal_tpu/ops/pallas_gcn.py: ``SigmoidEdgeWeight`` and
``fused_gcn_dense_att_dual``.  On CUDA tensors the wrapper launches the
hand-written kernel ``csrc/fused_gcn.cu``; on CPU tensors it runs the plain
twin ``fused_gcn_dense_att_dual_plain``, which reproduces the TPU kernel's
rounding: the norm is built in f32 and cast to the compute dtype before the
product, the product accumulates in f32, the ``x / deg`` term is added in
f32, and the result is cast once.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from cal_tpu_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class SigmoidEdgeWeight:
    """Factored per-edge weight ``w[b, r, s] = sigmoid(src[b, s] + dst[b, r])``
    (``1 - sigmoid`` when ``negate``); ``src``/``dst``: [B, N].  The causal
    edge attention in un-materialized form: the fused kernel rebuilds the
    weights on the fly."""

    src: torch.Tensor
    dst: torch.Tensor
    negate: bool = False


def _branch_plain(m, x, cdt):
    deg = m.sum(dim=-2) + 1.0                        # [B, N] sender degree
    dis = torch.rsqrt(deg)
    norm = (m * dis[:, None, :]) * dis[:, :, None]
    y = torch.bmm(norm.to(cdt).float(), x.to(cdt).float())
    return y + x * (1.0 / deg)[:, :, None]


def fused_gcn_dense_att_dual_plain(xc, xo, adj, src, dst):
    """Plain PyTorch twin of the kernel (same contract and rounding)."""
    cdt = xc.dtype
    n = adj.shape[-1]
    a = adj.float()
    sig = torch.sigmoid(src.float()[:, None, :] + dst.float()[:, :, None])
    off = ~torch.eye(n, dtype=torch.bool, device=adj.device)
    a_off = torch.where(off, a, torch.zeros((), device=adj.device))
    mc = a_off * sig
    mo = a_off - mc
    oc = _branch_plain(mc, xc.float(), cdt).to(cdt)
    oo = _branch_plain(mo, xo.float(), cdt).to(cdt)
    return oc, oo


def _fn():
    fn = build.load("fused_gcn").dual_gcn_fwd_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def fused_gcn_dense_att_dual(xc, xo, adj, src, dst):
    """Both causal masked convs, adjacency read once for both branches.

    == (gcn with weights sigmoid(src_s + dst_r), gcn with 1 - that), each
    with self loops dropped and re-added at weight 1 and the sender degree.
    xc/xo: [B, N, H]; adj: [B, N, N] (row = receiver); src/dst: [B, N];
    all of one dtype (float32 or bfloat16).  Returns (oc, oo) [B, N, H].
    """
    bsz, n, h = xc.shape
    if xo.shape != xc.shape or adj.shape != (bsz, n, n) \
            or src.shape != (bsz, n) or dst.shape != (bsz, n):
        raise ValueError("fused_gcn_dense_att_dual: shape mismatch "
                         f"{tuple(xc.shape)} {tuple(xo.shape)} {tuple(adj.shape)} "
                         f"{tuple(src.shape)} {tuple(dst.shape)}")
    ts = (xc, xo, adj, src, dst)
    if any(t.dtype != xc.dtype for t in ts) or xc.dtype not in _DTYPES:
        raise ValueError("fused_gcn_dense_att_dual: inputs must share one dtype "
                         "(float32 or bfloat16)")
    if any(t.device != xc.device for t in ts):
        raise ValueError("fused_gcn_dense_att_dual: inputs on different devices")
    if xc.device.type == "cpu":
        return fused_gcn_dense_att_dual_plain(xc, xo, adj, src, dst)
    if xc.device.type != "cuda":
        raise ValueError(f"fused_gcn_dense_att_dual: unsupported device {xc.device}")
    xc, xo, adj, src, dst = (t.contiguous() for t in ts)
    oc = torch.empty_like(xc)
    oo = torch.empty_like(xo)
    stats = torch.empty((4, bsz, n), dtype=torch.float32, device=xc.device)
    err = _fn()(adj.data_ptr(), xc.data_ptr(), xo.data_ptr(), src.data_ptr(),
                dst.data_ptr(), oc.data_ptr(), oo.data_ptr(), stats.data_ptr(),
                bsz, n, h, _DTYPES[xc.dtype],
                torch.cuda.current_stream(xc.device).cuda_stream)
    build.check(err, "fused_gcn_dense_att_dual")
    fused_gcn_dense_att_dual.launches += 1
    return oc, oo


fused_gcn_dense_att_dual.launches = 0
