"""Both masked causal GCN convs in one kernel (dense layout), forward and
backward.

Counterpart of cal_tpu/ops/pallas_gcn.py: ``SigmoidEdgeWeight`` and
``fused_gcn_dense_att_dual`` with its custom VJP.  ``fused_gcn_dense_att_dual``
is a ``torch.autograd.Function`` differentiable in xc, xo, src and dst (not in
the adjacency, which is a count).  Its forward is ``_dual_fwd`` and its
backward ``fused_gcn_dense_att_dual_bwd``: on CUDA tensors each launches the
hand-written kernel in ``csrc/fused_gcn.cu``, on CPU tensors each runs its
plain twin.  The twins reproduce the TPU kernels' rounding: the weighted
adjacency m is built in f32 and cast to the compute dtype before a product,
``x * dis`` and ``g * dis`` are formed in f32 and cast, every product
accumulates in f32, the remaining terms stay f32, and each result is cast
once.
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


def _weights(adj, src, dst):
    """(sigmoid, off-diagonal adjacency, m_c, m_o), all f32 [B, N, N]."""
    n = adj.shape[-1]
    sig = torch.sigmoid(src.float()[:, None, :] + dst.float()[:, :, None])
    off = ~torch.eye(n, dtype=torch.bool, device=adj.device)
    a_off = torch.where(off, adj.float(), torch.zeros((), device=adj.device))
    mc = a_off * sig
    return sig, a_off, mc, a_off - mc


def _degree(m):
    deg = m.sum(dim=-2) + 1.0                        # [B, N] sender degree
    return torch.rsqrt(deg), 1.0 / deg


def _branch_plain(m, x, cdt):
    dis, inv = _degree(m)
    norm = (m * dis[:, None, :]) * dis[:, :, None]
    y = torch.bmm(norm.to(cdt).float(), x.to(cdt).float())
    return y + x * inv[:, :, None]


def fused_gcn_dense_att_dual_plain(xc, xo, adj, src, dst):
    """Plain PyTorch twin of the forward kernel (same contract and rounding)."""
    cdt = xc.dtype
    _, _, mc, mo = _weights(adj, src, dst)
    oc = _branch_plain(mc, xc.float(), cdt).to(cdt)
    oo = _branch_plain(mo, xo.float(), cdt).to(cdt)
    return oc, oo


def _branch_bwd_plain(m, x, g, cdt):
    """One branch of the VJP (``_branch_bwd`` of the TPU kernel): returns
    (dx, dm) with dm = dL/dm_rs, both f32."""
    dis, inv = _degree(m)
    mt = m.to(cdt).float()
    p = torch.bmm(mt.transpose(1, 2), (g * dis[..., None]).to(cdt).float())
    dx = p * dis[..., None] + g * inv[..., None]
    u = torch.bmm(mt, (x * dis[..., None]).to(cdt).float())
    gu, px, gx = (g * u).sum(-1), (p * x).sum(-1), (g * x).sum(-1)
    t = -0.5 * (gu + px) * dis * dis * dis - gx * inv * inv        # dL/ddeg
    G = torch.bmm(g.to(cdt).float(), x.to(cdt).float().transpose(1, 2))
    dm = (G * dis[:, None, :]) * dis[:, :, None] + t[:, None, :]
    return dx, dm


def fused_gcn_dense_att_dual_bwd_plain(xc, xo, adj, src, dst, gc, go):
    """Plain PyTorch twin of the backward kernel: the VJP formulas of the TPU
    kernel written out (not autograd of the forward twin), with its rounding.
    Returns (dxc, dxo, dsrc, ddst) in the input dtype."""
    cdt = xc.dtype
    sig, a_off, mc, mo = _weights(adj, src, dst)
    dxc, dmc = _branch_bwd_plain(mc, xc.float(), gc.float(), cdt)
    dxo, dmo = _branch_bwd_plain(mo, xo.float(), go.float(), cdt)
    # w_c = sig, w_o = 1 - sig: dpre = (dm_c - dm_o) * a_off * sig'
    dpre = (dmc - dmo) * a_off * (sig * (1.0 - sig))
    return (dxc.to(cdt), dxo.to(cdt), dpre.sum(dim=-2).to(src.dtype),
            dpre.sum(dim=-1).to(dst.dtype))


def _check(what, ts, bsz, n):
    xc, xo, adj, src, dst = ts[:5]
    if xo.shape != xc.shape or adj.shape != (bsz, n, n) \
            or src.shape != (bsz, n) or dst.shape != (bsz, n) \
            or any(g.shape != xc.shape for g in ts[5:]):
        raise ValueError(f"{what}: shape mismatch "
                         + " ".join(str(tuple(t.shape)) for t in ts))
    if any(t.dtype != xc.dtype for t in ts) or xc.dtype not in _DTYPES:
        raise ValueError(f"{what}: inputs must share one dtype (float32 or bfloat16)")
    if any(t.device != xc.device for t in ts):
        raise ValueError(f"{what}: inputs on different devices")
    if xc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {xc.device}")


def _lib():
    lib = build.load("fused_gcn")
    if lib.dual_gcn_fwd_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dual_gcn_fwd_launch.argtypes = [vp] * 8 + [i, i, i, i, vp]
        lib.dual_gcn_fwd_launch.restype = ctypes.c_int
        lib.dual_gcn_bwd_launch.argtypes = [vp] * 12 + [i, i, i, i, vp]
        lib.dual_gcn_bwd_launch.restype = ctypes.c_int
        lib.dual_gcn_bwd_scratch_floats.argtypes = [i, i]
        lib.dual_gcn_bwd_scratch_floats.restype = ctypes.c_longlong
    return lib


def _dual_fwd(xc, xo, adj, src, dst):
    """Forward wrapper: the kernel on CUDA tensors, the plain twin on CPU
    tensors (no autograd)."""
    bsz, n, h = xc.shape
    ts = (xc, xo, adj, src, dst)
    _check("fused_gcn_dense_att_dual", ts, bsz, n)
    if xc.device.type == "cpu":
        return fused_gcn_dense_att_dual_plain(*ts)
    xc, xo, adj, src, dst = (t.contiguous() for t in ts)
    oc = torch.empty_like(xc)
    oo = torch.empty_like(xo)
    stats = torch.empty((4, bsz, n), dtype=torch.float32, device=xc.device)
    err = _lib().dual_gcn_fwd_launch(
        adj.data_ptr(), xc.data_ptr(), xo.data_ptr(), src.data_ptr(), dst.data_ptr(),
        oc.data_ptr(), oo.data_ptr(), stats.data_ptr(), bsz, n, h, _DTYPES[xc.dtype],
        torch.cuda.current_stream(xc.device).cuda_stream)
    build.check(err, "fused_gcn_dense_att_dual")
    fused_gcn_dense_att_dual.launches += 1
    return oc, oo


def fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc, go):
    """VJP of both masked convs: cotangents gc/go [B, N, H] of (oc, oo) ->
    (dxc, dxo, dsrc, ddst).  Launches the backward kernel on CUDA tensors,
    runs ``fused_gcn_dense_att_dual_bwd_plain`` on CPU tensors."""
    bsz, n, h = xc.shape
    ts = (xc, xo, adj, src, dst, gc, go)
    _check("fused_gcn_dense_att_dual_bwd", ts, bsz, n)
    if xc.device.type == "cpu":
        return fused_gcn_dense_att_dual_bwd_plain(*ts)
    xc, xo, adj, src, dst, gc, go = (t.contiguous() for t in ts)
    lib = _lib()
    dxc, dxo = torch.empty_like(xc), torch.empty_like(xo)
    dsrc, ddst = torch.empty_like(src), torch.empty_like(dst)
    scratch = torch.empty(lib.dual_gcn_bwd_scratch_floats(bsz, n), dtype=torch.float32,
                          device=xc.device)
    err = lib.dual_gcn_bwd_launch(
        adj.data_ptr(), xc.data_ptr(), xo.data_ptr(), src.data_ptr(), dst.data_ptr(),
        gc.data_ptr(), go.data_ptr(), dxc.data_ptr(), dxo.data_ptr(), dsrc.data_ptr(),
        ddst.data_ptr(), scratch.data_ptr(), bsz, n, h, _DTYPES[xc.dtype],
        torch.cuda.current_stream(xc.device).cuda_stream)
    build.check(err, "fused_gcn_dense_att_dual_bwd")
    fused_gcn_dense_att_dual_bwd.launches += 1
    return dxc, dxo, dsrc, ddst


class _DualGCN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, xo, adj, src, dst):
        ctx.save_for_backward(xc, xo, adj, src, dst)
        return _dual_fwd(xc, xo, adj, src, dst)

    @staticmethod
    def backward(ctx, gc, go):
        dxc, dxo, dsrc, ddst = fused_gcn_dense_att_dual_bwd(*ctx.saved_tensors, gc, go)
        return dxc, dxo, None, dsrc, ddst


def fused_gcn_dense_att_dual(xc, xo, adj, src, dst):
    """Both causal masked convs, adjacency read once for both branches.

    == (gcn with weights sigmoid(src_s + dst_r), gcn with 1 - that), each
    with self loops dropped and re-added at weight 1 and the sender degree.
    xc/xo: [B, N, H]; adj: [B, N, N] (row = receiver); src/dst: [B, N];
    all of one dtype (float32 or bfloat16).  Returns (oc, oo) [B, N, H].
    Differentiable in xc, xo, src and dst; ``.launches`` counts forward
    kernel launches, ``fused_gcn_dense_att_dual_bwd.launches`` backward ones.
    """
    return _DualGCN.apply(xc, xo, adj, src, dst)


fused_gcn_dense_att_dual.launches = 0
fused_gcn_dense_att_dual_bwd.launches = 0
