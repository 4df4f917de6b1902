"""Coefficient SpMM over a GraphBatch's CSR forms, forward and backward,
and the per-receiver max of per-edge values.

Counterpart of cal_tpu/ops/pallas_spmm.py ``coo_spmm`` (``_coo_fwd`` /
``_coo_bwd``): ``out[r] = sum_e coef[e] * x[s_e]`` with one f32 coefficient
per edge and no loop manipulation (a self loop is an ordinary edge; an edge
is dead only through a zero coefficient).  ``coo_aggregate`` is a
``torch.autograd.Function`` differentiable in x and coef.  Sparse GIN runs
it with ``coef = edge_mask`` (``ops/gin.py``), the weighted sparse GCN of
``ops/gcn.py::gcn_aggregate_sparse_coo`` with its normalized edge weights.

``coo_spmm_mh`` (row 9, cal_tpu's ``coo_spmm_mh``) is the same with one
coefficient per edge and head: x [V, heads * d], coef [E, heads] in edge
order (the caller zeroes dead and self-loop edges; no trailing pad row),
``out[r, h*d:(h+1)*d] = sum_e coef[e, h] * x[s_e, h*d:(h+1)*d]``; a
``torch.autograd.Function`` differentiable in x and coef (sparse GAT's
aggregation, ``ops/gat.py::gat_aggregate_sparse_mh``).  ``segment_max``
(row 14, cal_tpu's ``tile_scatter_max``) takes K value planes [K, E] in edge
order to [K, V] f32 receiver maxima over every edge, initialised to -1e30
(callers set dead edges to -1e30); forward only.

Kernels in ``csrc/coo_spmm.cu`` (its header gives the design and the
rounding points):

* ``coo_spmm`` (K11, ``_spmm_call`` on ``tiles_fwd``): the SpMM over the
  receiver CSR, f32 [V, H];
* ``coo_spmm_t`` (K11T, ``_spmm_call`` on ``tiles_bwd``): the same kernel
  over the sender CSR, ``dx[s] = sum_e coef[e] * g[r_e]``, f32 [V, H];
* ``coo_sddmm`` (K12, ``_sddmm_call``): ``dcoef[e] = <g[r_e], x[s_e]>`` for
  every edge (dead ones too, as cal_tpu's plan holds every edge), f32 [E] in
  edge order, so no tile-order scatter follows;
* ``coo_spmm_mh`` (K19, ``_spmm_mh_call``), ``coo_spmm_mh_t`` (K19T, the same
  on ``tiles_bwd``) and ``coo_sddmm_mh`` (K20, ``_sddmm_mh_call``): K11, K11T
  and K12 per head, f32 [V, H] and [E, heads];
* ``segment_max`` (K21, ``tile_scatter_max``): one launch over the receiver
  CSR (light rows by row, heavy rows by chunk), one owner per receiver, no
  float atomics.

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
    WALK_CSR_ARGTYPES,
    _check_features,
    _check_graph,
    _check_walk_width,
    _stream,
    _walk_csr,
)

NEG_BIG = -1e30            # tile_scatter_max's init
_HEADS = (1, 2, 4, 8)


def _per_head(coef, x):
    """coef [E] or [E, heads] -> f32 [E, heads]; x [E, heads * d] -> f32
    [E, heads, d]."""
    c = coef.float().reshape(coef.shape[0], -1)
    return c, x.float().reshape(x.shape[0], c.shape[1], -1)


def coo_spmm_plain(x, coef, g: GraphBatch) -> torch.Tensor:
    """Plain twin of K11 (coef [E]) and K19 (coef [E, heads]): f32 [V, H]
    scatter-add of coef * x[s] by receiver, per head."""
    s, r = g.senders.long(), g.receivers.long()
    c, xs = _per_head(coef, x[s])
    msg = (c[:, :, None] * xs).reshape(s.shape[0], x.shape[1])
    return torch.zeros((g.num_nodes, x.shape[1]), device=x.device).index_add_(0, r, msg)


def coo_spmm_t_plain(gout, coef, g: GraphBatch) -> torch.Tensor:
    """Plain twin of K11T and K19T: f32 [V, H] scatter-add of coef * g[r] by
    sender, per head."""
    s, r = g.senders.long(), g.receivers.long()
    c, gs = _per_head(coef, gout[r])
    msg = (c[:, :, None] * gs).reshape(s.shape[0], gout.shape[1])
    return torch.zeros((g.num_nodes, gout.shape[1]), device=gout.device).index_add_(0, s, msg)


def coo_sddmm_plain(x, gout, g: GraphBatch, heads: int | None = None) -> torch.Tensor:
    """Plain twin of K12 (f32 [E] dot products <g[r_e], x[s_e]>) and, with
    ``heads``, K20 (f32 [E, heads], one dot product per head)."""
    s, r = g.senders.long(), g.receivers.long()
    e = s.shape[0]
    prod = (gout.float()[r] * x.float()[s]).reshape(e, heads or 1, -1).sum(-1)
    return prod[:, 0] if heads is None else prod


def segment_max_plain(vals, g: GraphBatch) -> torch.Tensor:
    """Plain twin of K21: [K, V] f32 maxima of vals [K, E] by receiver,
    initialised to -1e30."""
    r = g.receivers.long()
    k = vals.shape[0]
    out = torch.full((k, g.num_nodes), NEG_BIG, dtype=torch.float32, device=vals.device)
    return out.scatter_reduce_(1, r[None].expand(k, -1), vals.float(), "amax")


def _lib():
    lib = build.load("coo_spmm")
    if lib.coo_spmm_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.coo_spmm_launch.argtypes = ([vp, i, vp, i, vp, vp] + WALK_CSR_ARGTYPES
                                        + [i, i, vp, vp, vp])
        lib.coo_spmm_launch.restype = ctypes.c_int
        lib.coo_sddmm_launch.argtypes = ([vp, i, vp, i, i, vp] + WALK_CSR_ARGTYPES[:-1]
                                         + [i, i, vp, vp])
        lib.coo_sddmm_launch.restype = ctypes.c_int
        lib.segment_max_launch.argtypes = [vp, i, i] + WALK_CSR_ARGTYPES + [i, vp, vp, vp]
        lib.segment_max_launch.restype = ctypes.c_int
    return lib


def _check_coef(what, coef, g: GraphBatch, device, heads: int | None) -> None:
    e = g.senders.shape[0]
    shape = (e,) if heads is None else (e, heads)
    if coef.dtype != torch.float32 or tuple(coef.shape) != shape:
        raise ValueError(f"{what}: coef must be {list(shape)} float32")
    if coef.device != device or g.senders.device != device:
        raise ValueError(f"{what}: inputs on different devices")


def _check_heads(what, heads, h) -> None:
    if heads not in _HEADS or h % heads:
        raise ValueError(f"{what}: heads must be one of {_HEADS} and divide {h}")


def _spmm(what, x, coef, g: GraphBatch, transpose: bool, heads: int | None = None):
    v, h = x.shape
    _check_features(what, (x,), g.num_nodes, h)
    device = x.device
    _check_coef(what, coef, g, device, heads)
    if heads is not None:
        _check_heads(what, heads, h)
    if device.type == "cpu":
        return (coo_spmm_t_plain if transpose else coo_spmm_plain)(x, coef, g)
    _check_graph(what, g, device)
    x, coef = x.contiguous(), coef.contiguous()
    _check_walk_width(what, h, [x], heads or 1)
    out = torch.empty((v, h), dtype=torch.float32, device=device)
    csr, nbr, perm = ((g.send, g.receivers, g.send.perm.data_ptr()) if transpose
                      else (g.recv, g.senders, None))
    partial = torch.empty((csr.heavy_chunks.shape[0], h), dtype=torch.float32, device=device)
    err = _lib().coo_spmm_launch(
        x.data_ptr(), _DTYPES[x.dtype], coef.data_ptr(), heads or 1, nbr.data_ptr(), perm,
        *_walk_csr(csr), v, h, out.data_ptr(), partial.data_ptr(), _stream(device))
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


def _sddmm(what, x, gout, g: GraphBatch, heads: int | None = None) -> torch.Tensor:
    v, h = x.shape
    _check_features(what, (x,), g.num_nodes, h)
    _check_features(what, (gout,), v, h)
    if heads is not None:
        _check_heads(what, heads, h)
    device = x.device
    if gout.device != device or g.senders.device != device:
        raise ValueError(f"{what}: inputs on different devices")
    if device.type == "cpu":
        return coo_sddmm_plain(x, gout, g, heads)
    _check_graph(what, g, device)
    x, gout = x.contiguous(), gout.contiguous()
    # a lane loads F features of x and of g (csrc/coo_spmm.cu SddmmShape)
    _check_walk_width(what, h, [x], heads or 1)
    _check_walk_width(what, h, [gout], heads or 1)
    e = g.senders.shape[0]
    dcoef = torch.empty((e,) if heads is None else (e, heads), dtype=torch.float32,
                        device=device)
    # the receiver CSR without its arrival counters: each item writes its own edges
    err = _lib().coo_sddmm_launch(
        x.data_ptr(), _DTYPES[x.dtype], gout.data_ptr(), _DTYPES[gout.dtype], heads or 1,
        g.senders.data_ptr(), *_walk_csr(g.recv)[:-1], v, h, dcoef.data_ptr(),
        _stream(device))
    build.check(err, what)
    return dcoef


def coo_sddmm(x, gout, g: GraphBatch) -> torch.Tensor:
    """K12: f32 [E] ``dcoef[e] = <gout[r_e], x[s_e]>``, the coef-gradient of
    K11; x and gout [V, H], each f32 or bf16.  ``.launches`` counts kernel
    launches."""
    dcoef = _sddmm("coo_sddmm", x, gout, g)
    if x.device.type == "cuda":
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


# ---- row 9: one coefficient per edge and head (K19, K19T, K20) -----------
def _coo_spmm_mh_fwd(x, coef, g: GraphBatch, heads: int) -> torch.Tensor:
    """K19: f32 [V, heads * d] ``out[r, h] = sum_e coef[e, h] x[s_e, h]``."""
    out = _spmm("coo_spmm_mh", x, coef, g, transpose=False, heads=heads)
    if x.device.type == "cuda":
        coo_spmm_mh.launches += 1
    return out


def coo_spmm_mh_t(gout, coef, g: GraphBatch, heads: int) -> torch.Tensor:
    """K19T: f32 [V, heads * d] ``dx[s, h] = sum_e coef[e, h] gout[r_e, h]``,
    the x-gradient of K19.  ``.launches`` counts kernel launches."""
    out = _spmm("coo_spmm_mh_t", gout, coef, g, transpose=True, heads=heads)
    if gout.device.type == "cuda":
        coo_spmm_mh_t.launches += 1
    return out


def coo_sddmm_mh(x, gout, g: GraphBatch, heads: int) -> torch.Tensor:
    """K20: f32 [E, heads] ``dcoef[e, h] = <gout[r_e, h], x[s_e, h]>`` for
    every edge, the coef-gradient of K19.  ``.launches`` counts kernel
    launches."""
    dcoef = _sddmm("coo_sddmm_mh", x, gout, g, heads)
    if x.device.type == "cuda":
        coo_sddmm_mh.launches += 1
    return dcoef


class _CooSpmmMh(torch.autograd.Function):
    """K19 forward; K19T for dx and, when coef needs a gradient, K20
    (cal_tpu ``_coo_mh_bwd``)."""

    @staticmethod
    def forward(ctx, x, coef, g, heads):
        ctx.save_for_backward(x, coef)
        ctx.g, ctx.heads = g, heads
        return _coo_spmm_mh_fwd(x, coef, g, heads)

    @staticmethod
    def backward(ctx, gout):
        x, coef = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = coo_spmm_mh_t(gout, coef, ctx.g, ctx.heads).to(x.dtype) if need[0] else None
        dcoef = coo_sddmm_mh(x, gout, ctx.g, ctx.heads) if need[1] else None
        return dx, dcoef, None, None


def coo_spmm_mh(x, coef, g: GraphBatch, heads: int) -> torch.Tensor:
    """Differentiable multi-head coefficient SpMM (counterpart of
    ``coo_spmm_mh``): f32 [V, heads * d] from x [V, heads * d] (f32 or bf16)
    and coef [E, heads] f32 in edge order, dead and self-loop edges zeroed
    by the caller.  ``.launches`` counts K19 launches."""
    return _CooSpmmMh.apply(x, coef, g, int(heads))


# ---- row 14: per-receiver max (K21) ---------------------------------------
def segment_max(vals, g: GraphBatch) -> torch.Tensor:
    """K21: [K, V] f32 per-receiver maxima of vals [K, E] f32 in edge order
    over every edge (callers set dead edges to -1e30), initialised to -1e30
    (counterpart of ``tile_scatter_max``).  ``.launches`` counts kernel
    launches."""
    what = "segment_max"
    e = g.senders.shape[0]
    if vals.dim() != 2 or vals.shape[1] != e or vals.dtype != torch.float32:
        raise ValueError(f"{what}: vals must be [K, {e}] float32, got "
                         f"{list(vals.shape)} {vals.dtype}")
    device = vals.device
    if g.receivers.device != device:
        raise ValueError(f"{what}: inputs on different devices")
    if device.type == "cpu":
        return segment_max_plain(vals, g)
    _check_graph(what, g, device)
    vals = vals.contiguous()
    k, v = vals.shape[0], g.num_nodes
    out = torch.empty((k, v), dtype=torch.float32, device=device)
    partial = torch.empty((g.recv.heavy_chunks.shape[0], k), dtype=torch.float32, device=device)
    err = _lib().segment_max_launch(vals.data_ptr(), e, k, *_walk_csr(g.recv), v, out.data_ptr(),
                                    partial.data_ptr(), _stream(device))
    build.check(err, what)
    segment_max.launches += 1
    return out


coo_spmm_mh.launches = 0
coo_spmm_mh_t.launches = 0
coo_sddmm_mh.launches = 0
segment_max.launches = 0
