"""Sparse-layout multi-head GAT aggregate over a GraphBatch's CSR forms,
forward and backward.

Counterpart of cal_tpu/ops/gat.py ``gat_aggregate_sparse_fused``
(``_gat_fused_fwd`` / ``_gat_fused_bwd``): PyG-1.1.0 ``GATConv`` over the
receiver-sorted edge list with the analytic self loop, attention dropout by
the edge-id hash of ``ops/gat.py``, and the normalizing division folded out
of the edge domain: ``out_v = (sum_e q_e x_s + q_self x_v) / denom_v`` with
the unnormalized weights ``q = exp(score - m)``.  ``gat_aggregate_sparse_fused``
is a ``torch.autograd.Function`` differentiable in xh, att_dst and att_src.

Kernels in ``csrc/gat_sparse.cu`` (its header gives the contract, the design
and the rounding points); the [heads, V] planes tj, ti, m, den, dD are f32:

* ``gat_row_stats`` (K8, ``_gat_max_call`` and ``_gat_den_call`` in one
  launch): the per-receiver max of the live scores and the self score, and
  the sum of the live edges' exp(score - m);
* ``gat_coef_spmm`` (K9, ``_gat_coef_spmm_call``): sum over live in-edges of
  q * keep / (1 - rate) * x[s], per head, [V, H] f32, in one launch over the
  receiver CSR (its scratch: an [H] f32 partial per heavy chunk);
* ``gat_coef_spmm_t`` (K9T, the same call on cal_tpu's transposed plan): the
  same weights summed over the sender CSR, dxh's message term, in one
  launch;
* ``gat_sddmm_chain`` (K10, ``_gat_sddmm_chain_call``): per live edge and
  head, dpre = q (<w[r], x[s]> keep / (1 - rate) + dD[r]) leaky'(pre),
  summed by receiver (dti) in a walk of the receiver CSR that writes each
  edge's dpre, then by sender (dtj) over the sender CSR: two launches.

The score halves, the self-loop terms, dD, sdot and the ``dti ad + dtj
asr`` fold stay plain torch, as they are plain XLA in cal_tpu.  The dropout
seed is two words or a seed buffer on the card (``flash_gat.seed_buffer``),
which K9, K9T and K10 read there and the self loops' keep bits take as
device tensors: a captured step draws each replay's seed.  On CUDA
tensors each wrapper launches its kernel (or raises); on CPU tensors it
runs its plain twin ``*_plain``, which rounds at the same points.
"""
from __future__ import annotations

import ctypes

import torch
from torch.nn.functional import leaky_relu

from cal_tpu_torch.graph import GraphBatch
from cal_tpu_torch.kernels import build
from cal_tpu_torch.ops.flash_gat import as_seed_buffer
from cal_tpu_torch.ops.gat import NEG_SLOPE, head_ids, keep_mask, keep_threshold
from cal_tpu_torch.ops.spmm import (
    _DTYPES,
    WALK_CSR_ARGTYPES,
    _check_graph,
    _check_kernel_width,
    _check_walk_width,
    _live,
    _stream,
    _walk_csr,
)

_HEADS = (1, 2, 4, 8)


def _edge_q(tj, ti, m, s, r, live):
    """[heads, E] pre-activations and unnormalized weights (0 on dead
    edges)."""
    pre = tj[:, s] + ti[:, r]
    z = leaky_relu(pre, NEG_SLOPE) - m[:, r]
    return pre, torch.exp(torch.where(live, z, torch.full_like(z, -torch.inf)))


def _edge_keep(words, rate, heads, num_edges, device):
    """[heads, E] keep bits (1.0 / 0.0) of every (edge, head), salt 0."""
    ids = head_ids(torch.arange(num_edges, device=device), heads)
    return keep_mask(ids, words, rate, 0).T


def gat_row_stats_plain(tj, ti, g: GraphBatch):
    """Plain twin of K8: (m, den) [heads, V] f32.  m = max(self score, live
    in-edge scores), computed without gradient (the aggregate does not
    depend on it); den = sum over live in-edges of exp(score - m)."""
    s, r, live = _live(g)
    heads, v = tj.shape
    pre = tj[:, s] + ti[:, r]
    score = torch.where(live, leaky_relu(pre, NEG_SLOPE), torch.full_like(pre, -torch.inf))
    m = leaky_relu(ti + tj, NEG_SLOPE).scatter_reduce(
        1, r.expand(heads, -1), score, "amax").detach()
    _, q = _edge_q(tj, ti, m, s, r, live)
    return m, torch.zeros((heads, v), device=tj.device).index_add_(1, r, q)


def gat_coef_spmm_plain(x, tj, ti, m, words, rate: float, g: GraphBatch,
                        transpose: bool = False) -> torch.Tensor:
    """Plain twin of K9 (K9T with ``transpose``): [V, H] f32, out[r] (out[s])
    = sum over live edges of q * keep / (1 - rate) * x[s] (x[r]) per head;
    q = exp(leaky_relu(tj[s] + ti[r]) - m[r]) either way."""
    s, r, live = _live(g)
    heads = tj.shape[0]
    v, hd = x.shape
    e = s.shape[0]
    _, q = _edge_q(tj, ti, m, s, r, live)
    if rate > 0.0:
        q = q * _edge_keep(words, rate, heads, e, x.device) / (1.0 - rate)
    row, nbr = (s, r) if transpose else (r, s)
    msg = (x.float()[nbr].view(e, heads, hd // heads) * q.T[:, :, None]).view(e, hd)
    return torch.zeros((v, hd), device=x.device).index_add_(0, row, msg)


def gat_sddmm_chain_plain(x, w, tj, ti, m, dD, words, rate: float, g: GraphBatch):
    """Plain twin of K10: (dtj, dti) [heads, V] f32.  Per live edge and
    head, dpre = q (dqm + dD[r]) (1 if pre > 0 else 0.2) with dqm =
    <w[r], x[s]> (times keep / (1 - rate)), summed by sender and by
    receiver."""
    s, r, live = _live(g)
    heads, v = tj.shape
    e, d = s.shape[0], x.shape[1] // heads
    dqm = (w.float()[r].view(e, heads, d) * x.float()[s].view(e, heads, d)).sum(-1).T
    if rate > 0.0:
        dqm = dqm * _edge_keep(words, rate, heads, e, x.device) / (1.0 - rate)
    pre, q = _edge_q(tj, ti, m, s, r, live)
    dpre = q * (dqm + dD[:, r]) * torch.where(pre > 0, 1.0, NEG_SLOPE)
    z = torch.zeros((heads, v), device=x.device)
    return z.index_add(1, s, dpre), z.index_add(1, r, dpre)


def _lib():
    lib = build.load("gat_sparse")
    if lib.gat_row_stats_launch.argtypes is None:
        vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        csr = WALK_CSR_ARGTYPES
        lib.gat_row_stats_launch.argtypes = [vp, vp, i, vp, vp] + csr + [i, vp, vp, vp, vp]
        lib.gat_row_stats_launch.restype = ctypes.c_int
        lib.gat_coef_spmm_launch.argtypes = ([vp, i, vp, vp, vp, i, vp, vp, vp] + csr
                                             + [i, i, vp, u, f, i, vp, vp, vp])
        lib.gat_coef_spmm_launch.restype = ctypes.c_int
        lib.gat_sddmm_chain_launch.argtypes = ([vp, i] + [vp] * 5 + [i, vp, vp] + csr + csr
                                               + [vp, i, i, i, vp, u, f, i] + [vp] * 5)
        lib.gat_sddmm_chain_launch.restype = ctypes.c_int
    return lib


def _check_planes(what, planes, v):
    heads = planes[0].shape[0]
    if heads not in _HEADS:
        raise ValueError(f"{what}: the kernels take 1, 2, 4 or 8 heads, got {heads}")
    if any(t.dtype != torch.float32 or tuple(t.shape) != (heads, v) for t in planes):
        raise ValueError(f"{what}: planes must be [{heads}, {v}] float32")
    return heads


def _check_x(what, x, v, heads):
    if x.dtype not in _DTYPES or x.dim() != 2 or x.shape[0] != v or x.shape[1] % heads:
        raise ValueError(f"{what}: features must be [{v}, heads * d] float32 or bfloat16")


def _device(what, tensors, g: GraphBatch):
    device = tensors[0].device
    if any(t.device != device for t in tensors) or g.senders.device != device:
        raise ValueError(f"{what}: inputs on different devices")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")
    return device


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate {rate} outside [0, 1)")


def _dropout_args(words, rate: float, device):
    """((seed buffer, threshold, 1 - rate, on) for the kernels, the buffer
    to keep alive until the launch is enqueued).  ``words``: the seed's two
    words (put into a new buffer) or its seed buffer, which the kernels read
    on the card."""
    if rate == 0.0:
        return (None, 0, 1.0, 0), None
    buf = as_seed_buffer(words if isinstance(words, torch.Tensor)
                         else int(words[0]) | int(words[1]) << 32, device)
    return (buf.data_ptr(), keep_threshold(rate), 1.0 - rate, 1), buf


def gat_row_stats(tj, ti, g: GraphBatch):
    """K8: (m, den) [heads, V] f32 from the score halves tj (sender) and ti
    (receiver) [heads, V] f32 (see ``gat_row_stats_plain``), in one kernel
    launch over the receiver CSR.  ``.launches`` counts kernel launches."""
    what = "gat_row_stats"
    heads = _check_planes(what, (tj, ti), g.num_nodes)
    device = _device(what, (tj, ti), g)
    if device.type == "cpu":
        return gat_row_stats_plain(tj, ti, g)
    _check_graph(what, g, device)
    tj, ti = tj.contiguous(), ti.contiguous()
    m, den = torch.empty_like(tj), torch.empty_like(tj)
    partial = torch.empty((g.recv.heavy_chunks.shape[0], 2 * heads), dtype=torch.float32,
                          device=device)
    err = _lib().gat_row_stats_launch(
        tj.data_ptr(), ti.data_ptr(), heads, g.senders.data_ptr(), g.edge_mask.data_ptr(),
        *_walk_csr(g.recv), g.num_nodes, m.data_ptr(), den.data_ptr(), partial.data_ptr(),
        _stream(device))
    build.check(err, what)
    gat_row_stats.launches += 1
    return m, den


def _coef_spmm(what, x, tj, ti, m, words, rate, g: GraphBatch, transpose: bool):
    v = g.num_nodes
    heads = _check_planes(what, (tj, ti, m), v)
    _check_x(what, x, v, heads)
    device = _device(what, (x, tj, ti, m), g)
    _check_rate(rate)
    if device.type == "cpu":
        return gat_coef_spmm_plain(x, tj, ti, m, words, rate, g, transpose)
    drop, _buf = _dropout_args(words, rate, device)
    _check_graph(what, g, device)
    x = x.contiguous()
    hd = x.shape[1]
    _check_walk_width(what, hd, [x], heads)
    tj, ti, m = tj.contiguous(), ti.contiguous(), m.contiguous()
    csr, nbr = (g.send, g.receivers) if transpose else (g.recv, g.senders)
    out = torch.empty((v, hd), dtype=torch.float32, device=device)
    partial = torch.empty((csr.heavy_chunks.shape[0], hd), dtype=torch.float32, device=device)
    err = _lib().gat_coef_spmm_launch(
        x.data_ptr(), _DTYPES[x.dtype], tj.data_ptr(), ti.data_ptr(), m.data_ptr(), heads,
        nbr.data_ptr(), None if csr.perm is None else csr.perm.data_ptr(),
        g.edge_mask.data_ptr(), *_walk_csr(csr), v, hd, *drop, out.data_ptr(),
        partial.data_ptr(), _stream(device))
    build.check(err, what)
    return out


def gat_coef_spmm(x, tj, ti, m, words, rate: float, g: GraphBatch) -> torch.Tensor:
    """K9: [V, H] f32, the per-head sum over live in-edges of q * keep /
    (1 - rate) * x[s]; x [V, H] f32 or bf16, planes [heads, V] f32,
    ``words`` the two uint32 seed words or the seed's buffer (ignored at
    rate 0).  One kernel launch; ``.launches`` counts them."""
    out = _coef_spmm("gat_coef_spmm", x, tj, ti, m, words, rate, g, False)
    if x.device.type == "cuda":
        gat_coef_spmm.launches += 1
    return out


def gat_coef_spmm_t(x, tj, ti, m, words, rate: float, g: GraphBatch) -> torch.Tensor:
    """K9T: K9's weights summed over the sender CSR, out[s] = sum over live
    out-edges of q * keep / (1 - rate) * x[r] (dxh's message term for x =
    gout / denom).  Planes in the forward's roles.  One kernel launch;
    ``.launches`` counts them."""
    out = _coef_spmm("gat_coef_spmm_t", x, tj, ti, m, words, rate, g, True)
    if x.device.type == "cuda":
        gat_coef_spmm_t.launches += 1
    return out


def gat_sddmm_chain(x, w, tj, ti, m, dD, words, rate: float, g: GraphBatch):
    """K10: (dtj, dti) [heads, V] f32 (see ``gat_sddmm_chain_plain``); x
    [V, H] f32 or bf16, w [V, H] f32.  Two kernel launches: the receiver
    pass (per-edge dpre and dti) and the sender sums (dtj).  ``.launches``
    counts calls."""
    what = "gat_sddmm_chain"
    v = g.num_nodes
    heads = _check_planes(what, (tj, ti, m, dD), v)
    _check_x(what, x, v, heads)
    if w.dtype != torch.float32 or w.shape != x.shape:
        raise ValueError(f"{what}: w must be float32 of x's shape")
    device = _device(what, (x, w, tj, ti, m, dD), g)
    _check_rate(rate)
    if device.type == "cpu":
        return gat_sddmm_chain_plain(x, w, tj, ti, m, dD, words, rate, g)
    drop, _buf = _dropout_args(words, rate, device)
    _check_graph(what, g, device)
    x, w = x.contiguous(), w.contiguous()
    hd = x.shape[1]
    _check_walk_width(what, hd, [x], heads)
    _check_kernel_width(what, hd, [w], 16)
    tj, ti, m, dD = (t.contiguous() for t in (tj, ti, m, dD))
    e = g.senders.shape[0]
    edge_out = torch.empty((e, heads), dtype=torch.float32, device=device)
    dtj, dti = torch.empty_like(tj), torch.empty_like(tj)
    partial = torch.empty((max(g.recv.heavy_chunks.shape[0], g.send.heavy_chunks.shape[0]),
                           heads), dtype=torch.float32, device=device)
    err = _lib().gat_sddmm_chain_launch(
        x.data_ptr(), _DTYPES[x.dtype], w.data_ptr(), tj.data_ptr(), ti.data_ptr(),
        m.data_ptr(), dD.data_ptr(), heads, g.senders.data_ptr(), g.edge_mask.data_ptr(),
        *_walk_csr(g.recv), *_walk_csr(g.send), g.send.perm.data_ptr(), v, e, hd, *drop,
        edge_out.data_ptr(), dtj.data_ptr(), dti.data_ptr(), partial.data_ptr(),
        _stream(device))
    build.check(err, what)
    gat_sddmm_chain.launches += 1
    return dtj, dti


gat_row_stats.launches = 0
gat_coef_spmm.launches = 0
gat_coef_spmm_t.launches = 0
gat_sddmm_chain.launches = 0


def _self_keep(words, rate, heads, v, device):
    """[heads, V] keep bits (1.0 / 0.0) of every node's self loop, salt 1."""
    ids = head_ids(torch.arange(v, device=device), heads)
    return keep_mask(ids, words, rate, 1).T


def _forward(xh, att_dst, att_src, words, g, rate, row_stats, coef_spmm):
    """The aggregate's forward from its two kernels (or their twins):
    (out [V, heads, d] f32, (ti, tj, m, denom, q_self))."""
    v, heads, d = xh.shape
    xf = xh.float()
    ti = torch.einsum("vhd,hd->hv", xf, att_dst.float()).contiguous()   # receiver half
    tj = torch.einsum("vhd,hd->hv", xf, att_src.float()).contiguous()   # sender half
    m, den = row_stats(tj, ti, g)
    q_self = torch.exp(leaky_relu(ti + tj, NEG_SLOPE) - m)              # [heads, V] in (0, 1]
    denom = den + q_self
    self_coef = q_self
    if rate > 0.0:
        self_coef = self_coef * _self_keep(words, rate, heads, v, xh.device) / (1.0 - rate)
    agg = coef_spmm(xh.reshape(v, heads * d), tj, ti, m, words, rate, g).view(v, heads, d)
    out = (agg + self_coef.T[:, :, None] * xf) / denom.T[:, :, None]
    return out, (ti, tj, m, denom, q_self)


class _GatSparseFused(torch.autograd.Function):
    """K8 + K9 forward; K9T and K10 backward (cal_tpu ``_gat_fused_fwd`` /
    ``_gat_fused_bwd``).  The backward differentiates through the
    unnormalized weights; m is a constant of the aggregate."""

    @staticmethod
    def forward(ctx, xh, att_dst, att_src, words, g, rate):
        out, (ti, tj, m, denom, q_self) = _forward(xh, att_dst, att_src, words, g, rate,
                                                   gat_row_stats, gat_coef_spmm)
        ctx.save_for_backward(xh, att_dst, att_src, ti, tj, m, denom, q_self, out)
        ctx.g, ctx.words, ctx.rate = g, words, rate
        return out.to(xh.dtype)

    @staticmethod
    def backward(ctx, gout):
        xh, att_dst, att_src, ti, tj, m, denom, q_self, out = ctx.saved_tensors
        g, words, rate = ctx.g, ctx.words, ctx.rate
        v, heads, d = xh.shape
        xf, ad, asr = xh.float(), att_dst.float(), att_src.float()
        u = gout.float()
        w = u / denom.T[:, :, None]                                     # [V, heads, d]
        wflat = w.reshape(v, heads * d)
        dx = gat_coef_spmm_t(wflat, tj, ti, m, words, rate, g).view(v, heads, d)
        dD = -((out * u).sum(-1).T / denom)                             # [heads, V]
        dtj, dti = gat_sddmm_chain(xh.reshape(v, heads * d), wflat, tj, ti, m, dD, words,
                                   rate, g)
        sdot = (xf * w).sum(-1).T
        if rate > 0.0:
            smask = _self_keep(words, rate, heads, v, xh.device) / (1.0 - rate)
            dx = dx + (q_self * smask).T[:, :, None] * w
            dq_self = smask * sdot + dD
        else:
            dx = dx + q_self.T[:, :, None] * w
            dq_self = sdot + dD
        dself_pre = q_self * dq_self * torch.where(ti + tj > 0, 1.0, NEG_SLOPE)
        dti, dtj = dti + dself_pre, dtj + dself_pre
        dxh = dx + dti.T[:, :, None] * ad + dtj.T[:, :, None] * asr
        datt_dst = torch.einsum("hv,vhd->hd", dti, xf)
        datt_src = torch.einsum("hv,vhd->hd", dtj, xf)
        return (dxh.to(xh.dtype), datt_dst.to(att_dst.dtype), datt_src.to(att_src.dtype),
                None, None, None)


def gat_aggregate_sparse_fused(xh, att_dst, att_src, words, g: GraphBatch,
                               rate: float = 0.0) -> torch.Tensor:
    """Sparse multi-head GAT aggregate (counterpart of cal_tpu's
    ``gat_aggregate_sparse_fused``): xh [V, heads, d] f32 or bf16, att_dst
    / att_src [heads, d], ``words`` the two uint32 dropout seed words, or
    the seed's buffer on the card (``flash_gat.seed_buffer``: the kernels
    and the self loops' keep bits read it there; ignored at rate 0).
    Returns [V, heads, d] in xh's dtype (bias not added); differentiable in
    xh, att_dst and att_src."""
    return _GatSparseFused.apply(xh, att_dst, att_src, words, g, rate)


def gat_aggregate_sparse_fused_plain(xh, att_dst, att_src, words, g: GraphBatch,
                                     rate: float = 0.0) -> torch.Tensor:
    """The same forward from the plain twins, differentiated by
    torch.autograd: the reference of the Function's backward."""
    out, _ = _forward(xh, att_dst, att_src, words, g, rate, gat_row_stats_plain,
                      gat_coef_spmm_plain)
    return out.to(xh.dtype)
