"""Sparse-layout GCN aggregates over a GraphBatch's CSR forms (forward).

Counterpart of the forward halves of cal_tpu/ops/pallas_spmm.py
``gcn_aggregate_sparse_plain_pallas`` (the backbone convs) and
``gcn_aggregate_sparse_sigmoid_pair_pallas`` (both masked causal convs in
one pass), whose contract is cal_tpu/ops/gcn.py ``gcn_aggregate_sparse``:
self loops and dead edges are dropped, the degree is 1 + the SENDER sum of
the edge weights, an edge s -> r adds ``dis[s] * w * dis[r] * x[s]`` at r and
the self loop adds ``x[r] / deg[r]``.

Three kernels in ``csrc/spmm.cu`` (its header gives the design and the
rounding points):

* ``pair_sender_degree`` (K1, ``_pair_stats_call``): both branch sender
  degrees [2, V] from the sender CSR; at zero logits it gives the plain
  conv's degree (sigmoid(0) = 0.5 exactly, so 2 deg[0] is exact);
* ``pair_coef_spmm`` (K2, ``_pair_coef_spmm_call``) and ``plain_coef_spmm``
  (K3, ``_plain_coef_spmm_call``): the SpMM over the receiver CSR with the
  coefficient chain and the self term in-kernel.

On CUDA tensors each wrapper launches its kernel (or raises); on CPU tensors
it runs its plain twin ``*_plain``, which rounds at the same points: x and
the logits in the model dtype, everything else f32, each output rounded
once.  No gradient: the sparse training slice adds the backward.
"""
from __future__ import annotations

import ctypes

import torch

from cal_tpu_torch.graph import GraphBatch
from cal_tpu_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _live(g: GraphBatch):
    s, r = g.senders.long(), g.receivers.long()
    return s, r, g.edge_mask & (s != r)


def pair_sender_degree_plain(src, dst, g: GraphBatch) -> torch.Tensor:
    """Plain twin of K1: [2, V] f32 sums over live edges by sender of
    sigmoid(src[s] + dst[r]) and of 1 - it (logits 0 when src is None)."""
    s, r, live = _live(g)
    z = (torch.zeros(s.shape, device=s.device) if src is None
         else src.float()[s] + dst.float()[r])
    sig = torch.sigmoid(z)
    zero = torch.zeros((), device=s.device)
    w = torch.stack([torch.where(live, sig, zero), torch.where(live, 1.0 - sig, zero)])
    return torch.zeros((2, g.num_nodes), device=s.device).index_add_(1, s, w)


def coef_spmm_plain(xs, src, dst, deg, dis, g: GraphBatch) -> list[torch.Tensor]:
    """Plain twin of K2 (two branches, logits src/dst) and K3 (one branch,
    src None): out_k[r] = sum over live e of (dis_k[s] w_k) dis_k[r] x_k[s]
    + x_k[r] / deg_k[r], in f32, rounded once to x's dtype."""
    s, r, live = _live(g)
    zero = torch.zeros((), device=s.device)
    if src is None:
        coefs = [dis[0][s] * dis[0][r]]
    else:
        sig = torch.sigmoid(src.float()[s] + dst.float()[r])
        coefs = [dis[0][s] * sig * dis[0][r], dis[1][s] * (1.0 - sig) * dis[1][r]]
    outs = []
    for k, x in enumerate(xs):
        x32 = x.float()
        msg = torch.where(live, coefs[k], zero)[:, None] * x32[s]
        out = torch.zeros_like(x32).index_add_(0, r, msg) + x32 / deg[k][:, None]
        outs.append(out.to(x.dtype))
    return outs


def _lib():
    lib = build.load("spmm")
    if lib.coef_spmm_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sender_degree_launch.argtypes = [vp, vp, i] + [vp] * 6 + [i, i, vp, vp, vp]
        lib.sender_degree_launch.restype = ctypes.c_int
        lib.coef_spmm_launch.argtypes = [i, vp, vp, vp, vp, i] + [vp] * 7 + [i, i, i,
                                                                             vp, vp, vp, vp]
        lib.coef_spmm_launch.restype = ctypes.c_int
    return lib


def _check_graph(what, g: GraphBatch, device) -> None:
    ts = (g.senders, g.receivers, g.edge_mask, g.recv.ptr, g.recv.chunk_ptr,
          g.recv.chunk_row, g.send.ptr, g.send.chunk_ptr, g.send.chunk_row, g.send.perm)
    if any(t.device != device for t in ts):
        raise ValueError(f"{what}: graph and features on different devices")
    if any(t.dtype != torch.int32 for t in ts[:2] + ts[3:]) or g.edge_mask.dtype != torch.bool:
        raise ValueError(f"{what}: graph index arrays must be int32, edge_mask bool")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: graph arrays must be contiguous")


def _check_features(what, xs, v, h) -> None:
    dt = xs[0].dtype
    if dt not in _DTYPES or any(x.dtype != dt for x in xs):
        raise ValueError(f"{what}: features must share one dtype (float32 or bfloat16)")
    if any(tuple(x.shape) != (v, h) for x in xs):
        raise ValueError(f"{what}: features must be [{v}, {h}]")
    if xs[0].device.type not in ("cpu", "cuda") or any(x.device != xs[0].device for x in xs):
        raise ValueError(f"{what}: features on different or unsupported devices")


def _check_kernel_width(what, h, tensors) -> None:
    if h % 32 or h // 32 not in (1, 2, 4, 8):
        raise ValueError(f"{what}: the kernel takes H in 32, 64, 128, 256, got {h}")
    align = (h // 32) * tensors[0].element_size()
    if any(t.data_ptr() % align for t in tensors):
        raise ValueError(f"{what}: feature rows must be {align}-byte aligned")


def pair_sender_degree(src, dst, g: GraphBatch) -> torch.Tensor:
    """K1: [2, V] f32 sender sums of sigmoid(src[s] + dst[r]) and 1 - it over
    live edges.  ``src``/``dst`` [V] (one dtype) or both None (logits 0).
    ``.launches`` counts kernel launches."""
    v = g.num_nodes
    device = g.senders.device
    if src is not None:
        _check_features("pair_sender_degree", (src[:, None], dst[:, None]), v, 1)
        if src.device != device:
            raise ValueError("pair_sender_degree: logits and graph on different devices")
    if device.type == "cpu":
        return pair_sender_degree_plain(src, dst, g)
    if device.type != "cuda":
        raise ValueError(f"pair_sender_degree: unsupported device {device}")
    _check_graph("pair_sender_degree", g, device)
    if src is not None:
        src, dst = src.contiguous(), dst.contiguous()
    deg = torch.empty((2, v), dtype=torch.float32, device=device)
    partial = torch.empty((g.send.num_chunks, 2), dtype=torch.float32, device=device)
    err = _lib().sender_degree_launch(
        None if src is None else src.data_ptr(), None if dst is None else dst.data_ptr(),
        0 if src is None else _DTYPES[src.dtype], g.receivers.data_ptr(),
        g.edge_mask.data_ptr(), g.send.perm.data_ptr(), g.send.ptr.data_ptr(),
        g.send.chunk_ptr.data_ptr(), g.send.chunk_row.data_ptr(), g.send.num_chunks, v,
        deg.data_ptr(), partial.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "pair_sender_degree")
    pair_sender_degree.launches += 1
    return deg


def _coef_spmm(what, xs, src, dst, deg, dis, g: GraphBatch):
    v, h = xs[0].shape
    nb = len(xs)
    _check_features(what, xs, v, h)
    for t in (deg, dis):
        if t.dtype != torch.float32 or tuple(t.shape) != (nb, v):
            raise ValueError(f"{what}: deg and dis must be [{nb}, {v}] float32")
    if src is not None:
        _check_features(what, (src[:, None], dst[:, None]), v, 1)
        if src.dtype != xs[0].dtype:
            raise ValueError(f"{what}: logits and features of different dtypes")
    device = xs[0].device
    if any(t.device != device for t in (deg, dis, g.senders)) or (
            src is not None and src.device != device):
        raise ValueError(f"{what}: inputs on different devices")
    if device.type == "cpu":
        return coef_spmm_plain(xs, src, dst, deg, dis, g)
    _check_graph(what, g, device)
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    _check_kernel_width(what, h, xs + outs)
    deg, dis = deg.contiguous(), dis.contiguous()
    if src is not None:
        src, dst = src.contiguous(), dst.contiguous()
    partial = torch.empty((g.recv.num_chunks, nb * h), dtype=torch.float32, device=device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _lib().coef_spmm_launch(
        nb, xs[0].data_ptr(), ptr(xs[1] if nb == 2 else None), ptr(src), ptr(dst),
        _DTYPES[xs[0].dtype], g.senders.data_ptr(), g.edge_mask.data_ptr(), deg.data_ptr(),
        dis.data_ptr(), g.recv.ptr.data_ptr(), g.recv.chunk_ptr.data_ptr(),
        g.recv.chunk_row.data_ptr(), g.recv.num_chunks, v, h, outs[0].data_ptr(),
        ptr(outs[1] if nb == 2 else None), partial.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    build.check(err, what)
    return outs


def pair_coef_spmm(xc, xo, src, dst, deg, dis, g: GraphBatch):
    """K2: (oc, oo) [V, H] in x's dtype; ``deg``/``dis`` [2, V] f32 are
    1 + the K1 degrees and their rsqrt.  ``.launches`` counts launches."""
    oc, oo = _coef_spmm("pair_coef_spmm", [xc, xo], src, dst, deg, dis, g)
    if xc.device.type == "cuda":
        pair_coef_spmm.launches += 1
    return oc, oo


def plain_coef_spmm(x, deg, dis, g: GraphBatch) -> torch.Tensor:
    """K3: the unweighted aggregate [V, H] in x's dtype; ``deg``/``dis``
    [1, V] f32.  ``.launches`` counts kernel launches."""
    (out,) = _coef_spmm("plain_coef_spmm", [x], None, None, deg, dis, g)
    if x.device.type == "cuda":
        plain_coef_spmm.launches += 1
    return out


pair_sender_degree.launches = 0
pair_coef_spmm.launches = 0
plain_coef_spmm.launches = 0


def gcn_aggregate_sparse_pair(xc, xo, src, dst, g: GraphBatch):
    """Both masked causal convs of the sparse layout (counterpart of the
    forward of ``gcn_aggregate_sparse_sigmoid_pair_pallas``): out_c with
    w = sigmoid(src[s] + dst[r]) on xc, out_o with 1 - w on xo.  K1, then
    K2."""
    deg = pair_sender_degree(src, dst, g) + 1.0
    return pair_coef_spmm(xc, xo, src, dst, deg, torch.rsqrt(deg), g)


def gcn_aggregate_sparse_plain(x, g: GraphBatch) -> torch.Tensor:
    """Unweighted GCN aggregate of the sparse layout (counterpart of the
    forward of ``gcn_aggregate_sparse_plain_pallas``): K1 at zero logits for
    the degree, then K3."""
    deg = 2.0 * pair_sender_degree(None, None, g)[:1] + 1.0
    return plain_coef_spmm(x, deg, torch.rsqrt(deg), g)
