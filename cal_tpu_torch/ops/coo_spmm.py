"""Coefficient SpMM over a GraphBatch's CSR forms, forward and backward.

Counterpart of cal_tpu/ops/pallas_spmm.py ``coo_spmm`` (``_coo_fwd`` /
``_coo_bwd``): ``out[r] = sum_e coef[e] * x[s_e]`` with one f32 coefficient
per edge and no loop manipulation (a self loop is an ordinary edge; an edge
is dead only through a zero coefficient).  ``coo_aggregate`` is a
``torch.autograd.Function`` differentiable in x and coef.  Sparse GIN runs
it with ``coef = edge_mask`` (``ops/gin.py``).

Kernels in ``csrc/coo_spmm.cu`` (its header gives the design and the
rounding points):

* ``coo_spmm`` (K11, ``_spmm_call`` on ``tiles_fwd``): the SpMM over the
  receiver CSR, f32 [V, H];
* ``coo_spmm_t`` (K11T, ``_spmm_call`` on ``tiles_bwd``): the same kernel
  over the sender CSR, ``dx[s] = sum_e coef[e] * g[r_e]``, f32 [V, H];
* ``coo_sddmm`` (K12, ``_sddmm_call``): ``dcoef[e] = <g[r_e], x[s_e]>`` for
  every edge (dead ones too, as cal_tpu's plan holds every edge), f32 [E] in
  edge order, so no tile-order scatter follows.

On CUDA tensors each wrapper launches its kernel (or raises); on CPU tensors
it runs its plain twin ``*_plain``, which rounds at the same points: x and g
read in their dtype, coefficients, products and sums f32, f32 outputs.  The
backward rounds dx once to x's dtype and returns dcoef f32.
"""
from __future__ import annotations

import ctypes

import torch

from cal_tpu_torch.graph import GraphBatch
from cal_tpu_torch.kernels import build
from cal_tpu_torch.ops.spmm import (
    _DTYPES,
    _check_features,
    _check_graph,
    _check_kernel_width,
    _stream,
)


def coo_spmm_plain(x, coef, g: GraphBatch) -> torch.Tensor:
    """Plain twin of K11: f32 [V, H] scatter-add of coef * x[s] by receiver."""
    s, r = g.senders.long(), g.receivers.long()
    msg = coef.float()[:, None] * x.float()[s]
    return torch.zeros((g.num_nodes, x.shape[1]), device=x.device).index_add_(0, r, msg)


def coo_spmm_t_plain(gout, coef, g: GraphBatch) -> torch.Tensor:
    """Plain twin of K11T: f32 [V, H] scatter-add of coef * g[r] by sender."""
    s, r = g.senders.long(), g.receivers.long()
    msg = coef.float()[:, None] * gout.float()[r]
    return torch.zeros((g.num_nodes, gout.shape[1]), device=gout.device).index_add_(0, s, msg)


def coo_sddmm_plain(x, gout, g: GraphBatch) -> torch.Tensor:
    """Plain twin of K12: f32 [E] dot products <g[r_e], x[s_e]>."""
    s, r = g.senders.long(), g.receivers.long()
    return (gout.float()[r] * x.float()[s]).sum(-1)


def _lib():
    lib = build.load("coo_spmm")
    if lib.coo_spmm_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.coo_spmm_launch.argtypes = [vp, i] + [vp] * 6 + [i, i, i, vp, vp, vp]
        lib.coo_spmm_launch.restype = ctypes.c_int
        lib.coo_sddmm_launch.argtypes = [vp, i, vp, i] + [vp] * 4 + [i, i, vp, vp]
        lib.coo_sddmm_launch.restype = ctypes.c_int
    return lib


def _check_coef(what, coef, g: GraphBatch, device) -> None:
    e = g.senders.shape[0]
    if coef.dtype != torch.float32 or tuple(coef.shape) != (e,):
        raise ValueError(f"{what}: coef must be [{e}] float32")
    if coef.device != device or g.senders.device != device:
        raise ValueError(f"{what}: inputs on different devices")


def _spmm(what, x, coef, g: GraphBatch, transpose: bool) -> torch.Tensor:
    v, h = x.shape
    _check_features(what, (x,), g.num_nodes, h)
    device = x.device
    _check_coef(what, coef, g, device)
    if device.type == "cpu":
        return (coo_spmm_t_plain if transpose else coo_spmm_plain)(x, coef, g)
    _check_graph(what, g, device)
    x, coef = x.contiguous(), coef.contiguous()
    _check_kernel_width(what, h, [x])
    out = torch.empty((v, h), dtype=torch.float32, device=device)
    csr, nbr, perm = ((g.send, g.receivers, g.send.perm.data_ptr()) if transpose
                      else (g.recv, g.senders, None))
    partial = torch.empty((csr.num_chunks, h), dtype=torch.float32, device=device)
    err = _lib().coo_spmm_launch(
        x.data_ptr(), _DTYPES[x.dtype], coef.data_ptr(), nbr.data_ptr(), perm,
        csr.ptr.data_ptr(), csr.chunk_ptr.data_ptr(), csr.chunk_row.data_ptr(),
        csr.num_chunks, v, h, out.data_ptr(), partial.data_ptr(), _stream(device))
    build.check(err, what)
    return out


def coo_spmm(x, coef, g: GraphBatch) -> torch.Tensor:
    """K11: f32 [V, H] ``out[r] = sum_e coef[e] x[s_e]``; x [V, H] f32 or
    bf16, coef [E] f32 in edge order.  ``.launches`` counts kernel
    launches."""
    out = _spmm("coo_spmm", x, coef, g, transpose=False)
    if x.device.type == "cuda":
        coo_spmm.launches += 1
    return out


def coo_spmm_t(gout, coef, g: GraphBatch) -> torch.Tensor:
    """K11T: f32 [V, H] ``dx[s] = sum_e coef[e] gout[r_e]``, the x-gradient
    of K11.  ``.launches`` counts kernel launches."""
    out = _spmm("coo_spmm_t", gout, coef, g, transpose=True)
    if gout.device.type == "cuda":
        coo_spmm_t.launches += 1
    return out


def coo_sddmm(x, gout, g: GraphBatch) -> torch.Tensor:
    """K12: f32 [E] ``dcoef[e] = <gout[r_e], x[s_e]>``, the coef-gradient of
    K11; x and gout [V, H], each f32 or bf16.  ``.launches`` counts kernel
    launches."""
    what = "coo_sddmm"
    v, h = x.shape
    _check_features(what, (x,), g.num_nodes, h)
    _check_features(what, (gout,), v, h)
    device = x.device
    if gout.device != device or g.senders.device != device:
        raise ValueError(f"{what}: inputs on different devices")
    if device.type == "cpu":
        return coo_sddmm_plain(x, gout, g)
    _check_graph(what, g, device)
    x, gout = x.contiguous(), gout.contiguous()
    _check_kernel_width(what, h, [x])
    _check_kernel_width(what, h, [gout])
    dcoef = torch.empty(g.senders.shape[0], dtype=torch.float32, device=device)
    err = _lib().coo_sddmm_launch(
        x.data_ptr(), _DTYPES[x.dtype], gout.data_ptr(), _DTYPES[gout.dtype],
        g.senders.data_ptr(), g.recv.ptr.data_ptr(), g.recv.chunk_ptr.data_ptr(),
        g.recv.chunk_row.data_ptr(), g.recv.num_chunks, h, dcoef.data_ptr(),
        _stream(device))
    build.check(err, what)
    coo_sddmm.launches += 1
    return dcoef


coo_spmm.launches = 0
coo_spmm_t.launches = 0
coo_sddmm.launches = 0


class _CooSpmm(torch.autograd.Function):
    """K11 forward; K11T for dx and, only when coef needs a gradient, K12
    (cal_tpu ``_coo_bwd``)."""

    @staticmethod
    def forward(ctx, x, coef, g):
        ctx.save_for_backward(x, coef)
        ctx.g = g
        return coo_spmm(x, coef, g)

    @staticmethod
    def backward(ctx, gout):
        x, coef = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = coo_spmm_t(gout, coef, ctx.g).to(x.dtype) if need[0] else None
        dcoef = coo_sddmm(x, gout, ctx.g) if need[1] else None
        return dx, dcoef, None


def coo_aggregate(x, coef, g: GraphBatch) -> torch.Tensor:
    """Differentiable ``out[r] = sum_e coef[e] x[s_e]`` (counterpart of
    ``coo_spmm``): f32 [V, H] from x [V, H] (f32 or bf16) and coef [E] f32."""
    return _CooSpmm.apply(x, coef, g)
