"""Sparse-layout GCN aggregates over a GraphBatch's CSR forms, forward and
backward.

Counterpart of cal_tpu/ops/pallas_spmm.py ``gcn_aggregate_sparse_plain_pallas``
(the backbone convs) and ``gcn_aggregate_sparse_sigmoid_pair_pallas`` (both
masked causal convs in one pass) with their custom VJPs, whose contract is
cal_tpu/ops/gcn.py ``gcn_aggregate_sparse``: self loops and dead edges are
dropped, the degree is 1 + the SENDER sum of the edge weights, an edge
s -> r adds ``dis[s] * w * dis[r] * x[s]`` at r and the self loop adds
``x[r] / deg[r]``.  Both aggregates are ``torch.autograd.Function``s: the
pair differentiable in xc, xo, src and dst, the plain one in x (its norm
depends on the graph alone).

Kernels in ``csrc/spmm.cu`` (its header gives the design and the rounding
points):

* ``pair_sender_degree`` (K1, ``_pair_stats_call``): both branch sender
  degrees [2, V] from the sender CSR, or (``norm``) deg = 1 + them and dis
  = deg^-1/2 written by the kernel itself, as the pair aggregate takes
  them;
* ``plain_sender_degree`` (K1 at zero logits, as cal_tpu's ``_plain_fwd``
  calls ``_pair_stats_call``): the plain conv's (deg, dis) [1, V], the same
  kernel counting live edges (2 x a sum of sigmoid(0) = 0.5 is that count
  exactly).  It depends on the graph alone, so ``plain_norm`` computes it
  once a batch, at the batch's first plain conv, and keeps it in the
  batch's ``GraphBatch.derived`` for every later conv of the batch (the
  steps hand the model a new batch each step, ``train.steps._as_graph``:
  once a step, and a captured step computes it at each replay);
* ``pair_coef_spmm`` (K2, ``_pair_coef_spmm_call``) and ``plain_coef_spmm``
  (K3, ``_plain_coef_spmm_call``): the SpMM over the receiver CSR with the
  coefficient chain and the self term in-kernel;
* ``pair_coef_spmm_t`` (K2T) and ``plain_coef_spmm_t`` (K3T): the same
  kernel over the sender CSR, the dx of K2/K3 (cal_tpu runs the same calls
  on its transposed tile plan);
* ``pair_sddmm_chain`` (K5, ``_pair_sddmm_chain_call``): the per-edge dot
  products of the cotangent and x, the per-edge chain values and both
  ddis planes;
* ``pair_dpre`` (K6, ``_pair_dpre_call``): the edge logit gradient and its
  sums into dsrc (by sender) and ddst (by receiver).

The single sigmoid-weighted aggregate ``gcn_aggregate_sparse_sigmoid``
(cal_tpu's ``gcn_aggregate_sparse_sigmoid_pallas``: one branch, w =
sigmoid(src[s] + dst[r]) or 1 - it under ``negate``, differentiable in x,
src and dst) runs the same four functions for one branch, also in
``csrc/spmm.cu``:

* ``sigmoid_sender_degree`` (K13): the branch's sender sums, deg = 1 +
  them and dis [V] written by the kernel;
* ``sigmoid_coef_spmm`` (K14) and ``sigmoid_coef_spmm_t`` (K14T): its
  coefficient SpMM over the receiver CSR and, for dx, the sender CSR;
* ``sigmoid_sddmm_chain`` (K15): the per-edge dot products and chain
  values and the ddis sums;
* ``sigmoid_dpre`` (K16): dpre and its sums into dsrc and ddst.

``gcn_aggregate_sparse_sigmoid_plain`` is the whole function in plain
PyTorch ops, differentiated by autograd.

On CUDA tensors each wrapper launches its kernel (or raises); on CPU tensors
it runs its plain twin ``*_plain``, which rounds at the same points: x, the
cotangents and the pair's logits in the model dtype (the single branch takes
its logits in their own dtype, as cal_tpu does, and its kernels read them as
f32), everything else f32, each [V, H] output rounded once.  The backward computes in f32 and rounds each
gradient once to its input's dtype (cal_tpu's ``_pair_bwd`` returns f32).
"""
from __future__ import annotations

import ctypes

import torch

from cal_tpu_torch.graph import GraphBatch
from cal_tpu_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the ctypes of ``_walk_csr``'s arguments
WALK_CSR_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2


def _live(g: GraphBatch):
    s, r = g.senders.long(), g.receivers.long()
    return s, r, g.edge_mask & (s != r)


def pair_sender_degree_plain(src, dst, g: GraphBatch, norm: bool = False):
    """Plain twin of K1: [2, V] f32 sums over live edges by sender of
    sigmoid(src[s] + dst[r]) and of 1 - it (logits 0 when src is None);
    ``norm``: (deg, dis), deg = 1 + the sums and dis = deg^-1/2."""
    s, r, live = _live(g)
    z = (torch.zeros(s.shape, device=s.device) if src is None
         else src.float()[s] + dst.float()[r])
    sig = torch.sigmoid(z)
    zero = torch.zeros((), device=s.device)
    w = torch.stack([torch.where(live, sig, zero), torch.where(live, 1.0 - sig, zero)])
    sums = torch.zeros((2, g.num_nodes), device=s.device).index_add_(1, s, w)
    return _norm(sums) if norm else sums


def _norm(sums):
    deg = sums + 1.0
    return deg, torch.rsqrt(deg)


def plain_sender_degree_plain(g: GraphBatch):
    """Plain twin of the plain conv's degree: (deg, dis) [1, V] f32, deg = 1
    + the live edges by sender and dis = deg^-1/2."""
    s, _, live = _live(g)
    counts = torch.zeros((1, g.num_nodes), device=s.device).index_add_(
        1, s, live.float()[None])
    return _norm(counts)


def coef_spmm_plain(xs, src, dst, deg, dis, g: GraphBatch,
                    transpose: bool = False) -> list[torch.Tensor]:
    """Plain twin of K2 (two branches, logits src/dst) and K3 (one branch,
    src None): out_k[r] = sum over live e of (dis_k[s] w_k) dis_k[r] x_k[s]
    + x_k[r] / deg_k[r], in f32, rounded once to x's dtype.  ``transpose``:
    K2T/K3T, rows and neighbours swapped (out_k[s] = sum of (dis_k[r] w_k)
    dis_k[s] x_k[r] + x_k[s] / deg_k[s]); w_k stays a function of src[s] +
    dst[r]."""
    s, r, live = _live(g)
    row, nbr = (s, r) if transpose else (r, s)
    zero = torch.zeros((), device=s.device)
    if src is None:
        coefs = [dis[0][nbr] * dis[0][row]]
    else:
        sig = torch.sigmoid(src.float()[s] + dst.float()[r])
        coefs = [dis[0][nbr] * sig * dis[0][row], dis[1][nbr] * (1.0 - sig) * dis[1][row]]
    outs = []
    for k, x in enumerate(xs):
        x32 = x.float()
        msg = torch.where(live, coefs[k], zero)[:, None] * x32[nbr]
        out = torch.zeros_like(x32).index_add_(0, row, msg) + x32 / deg[k][:, None]
        outs.append(out.to(x.dtype))
    return outs


def pair_sddmm_chain_plain(xc, xo, gc, go, src, dst, dis, g: GraphBatch):
    """Plain twin of K5: (vec [3, E], ddis_s [2, V], ddis_r [2, V]), all f32.
    dc_k[e] = <g_k[r], x_k[s]>; vec = (dc_0 dis_0[s] dis_0[r], dc_1 dis_1[s]
    dis_1[r], w_0 w_1), zero on dead edges; ddis_s[k] sums dc_k w_k dis_k[r]
    by sender, ddis_r[k] dc_k w_k dis_k[s] by receiver."""
    s, r, live = _live(g)
    v = g.num_nodes
    zero = torch.zeros((), device=s.device)
    sig = torch.sigmoid(src.float()[s] + dst.float()[r])
    w = (torch.where(live, sig, zero), torch.where(live, 1.0 - sig, zero))
    vec, ddis_s, ddis_r = [], torch.zeros((2, v), device=s.device), torch.zeros(
        (2, v), device=s.device)
    for k, (x, gk) in enumerate(((xc, gc), (xo, go))):
        dc = torch.where(live, (gk.float()[r] * x.float()[s]).sum(-1), zero)
        vec.append(dc * dis[k][s] * dis[k][r])
        ddis_s[k].index_add_(0, s, dc * w[k] * dis[k][r])
        ddis_r[k].index_add_(0, r, dc * w[k] * dis[k][s])
    vec.append(w[0] * w[1])
    return torch.stack(vec), ddis_s, ddis_r


def pair_dpre_plain(vec, ddeg, g: GraphBatch):
    """Plain twin of K6: dpre = (vec0 + ddeg_0[s] - vec1 - ddeg_1[s]) * vec2
    summed by sender (dsrc) and by receiver (ddst), [V] f32 each."""
    s, r = g.senders.long(), g.receivers.long()
    dpre = (vec[0] + ddeg[0][s] - vec[1] - ddeg[1][s]) * vec[2]
    z = torch.zeros(g.num_nodes, device=s.device)
    return z.index_add(0, s, dpre), z.index_add(0, r, dpre)


def _lib():
    lib = build.load("spmm")
    if lib.coef_spmm_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        csr = WALK_CSR_ARGTYPES
        lib.sender_degree_launch.argtypes = [i, i, vp, vp, i] + [vp] * 3 + csr + [i] + [vp] * 4
        lib.coef_spmm_launch.argtypes = ([i, vp, vp, vp, vp, i] + [vp] * 5 + csr
                                         + [i, i, vp, vp, vp, vp])
        lib.sig_coef_spmm_launch.argtypes = ([vp, vp, vp, i, i] + [vp] * 5 + csr
                                             + [i, i, vp, vp, vp])
        lib.sddmm_chain_launch.argtypes = ([i, i] + [vp] * 6 + [i] + [vp] * 3 + csr + csr
                                           + [vp, i, i, i] + [vp] * 6)
        lib.dpre_launch.argtypes = [i, i] + [vp] * 3 + csr + csr + [vp, i, i] + [vp] * 4
        for f in (lib.sender_degree_launch, lib.coef_spmm_launch, lib.sig_coef_spmm_launch,
                  lib.sddmm_chain_launch, lib.dpre_launch):
            f.restype = ctypes.c_int
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_graph(what, g: GraphBatch, device) -> None:
    ints = (g.senders, g.receivers, g.recv.ptr, g.recv.chunk_ptr, g.recv.chunk_row,
            g.recv.heavy_chunks, g.recv.heavy_count, g.recv.arrivals, g.send.ptr,
            g.send.chunk_ptr, g.send.chunk_row, g.send.heavy_chunks, g.send.heavy_count,
            g.send.arrivals, g.send.perm)
    bools = (g.edge_mask, g.recv.heavy_masked, g.send.heavy_masked)
    ts = ints + bools
    if any(t.device != device for t in ts):
        raise ValueError(f"{what}: graph and features on different devices")
    if any(t.dtype != torch.int32 for t in ints) or any(t.dtype != torch.bool for t in bools):
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


def _check_kernel_width(what, h, tensors, align=None) -> None:
    if h % 32 or h // 32 not in (1, 2, 4, 8):
        raise ValueError(f"{what}: the kernel takes H in 32, 64, 128, 256, got {h}")
    align = align or (h // 32) * tensors[0].element_size()
    if any(t.data_ptr() % align for t in tensors):
        raise ValueError(f"{what}: feature rows must be {align}-byte aligned")


def _check_walk_width(what, h, tensors, heads: int = 1) -> None:
    """H and the alignment of the walk's feature rows: a lane group's load
    of F features (csr_rows.cuh ``LightShape``: 16 bytes, or H / 32
    features when more, or a head's width when less)."""
    elt = tensors[0].element_size()
    f = min(max(16 // elt, h // 32), h // heads)
    _check_kernel_width(what, h, tensors, min(16, f * elt))


def _walk_csr(csr):
    """The CSR arguments of the walk's C entry points: ptr, chunk_ptr,
    chunk_row, heavy_chunks, heavy_masked, the heavy list's capacity (an
    int: the launch's grid), its live count (a pointer: the kernels read it
    on the device, so a captured launch takes the count of the batch its
    buffers hold) and the arrival counters."""
    return (csr.ptr.data_ptr(), csr.chunk_ptr.data_ptr(), csr.chunk_row.data_ptr(),
            csr.heavy_chunks.data_ptr(), csr.heavy_masked.data_ptr(),
            int(csr.heavy_chunks.shape[0]), csr.heavy_count.data_ptr(),
            csr.arrivals.data_ptr())


def pair_sender_degree(src, dst, g: GraphBatch, norm: bool = False):
    """K1: [2, V] f32 sender sums of sigmoid(src[s] + dst[r]) and 1 - it over
    live edges; ``norm``: (deg, dis) [2, V] f32, deg = 1 + the sums and dis
    = deg^-1/2, written by the kernel.  ``src``/``dst`` [V] (one dtype) or
    both None (logits 0).  One launch.  ``.launches`` counts kernel
    launches."""
    v = g.num_nodes
    device = g.senders.device
    if src is not None:
        _check_features("pair_sender_degree", (src[:, None], dst[:, None]), v, 1)
        if src.device != device:
            raise ValueError("pair_sender_degree: logits and graph on different devices")
    if device.type == "cpu":
        return pair_sender_degree_plain(src, dst, g, norm)
    if device.type != "cuda":
        raise ValueError(f"pair_sender_degree: unsupported device {device}")
    deg, dis = _sender_degree_launch("pair_sender_degree", src, dst, g, 2, False, norm)
    pair_sender_degree.launches += 1
    return (deg, dis) if norm else deg


def plain_sender_degree(g: GraphBatch):
    """The plain conv's (deg, dis) [1, V] f32: deg = 1 + the live edges by
    sender, dis = deg^-1/2; on CUDA one launch of K1's kernel at zero
    logits and one branch, which counts the edges.  ``.launches`` counts
    kernel launches.  The aggregate takes it through ``plain_norm``."""
    device = g.senders.device
    if device.type == "cpu":
        return plain_sender_degree_plain(g)
    if device.type != "cuda":
        raise ValueError(f"plain_sender_degree: unsupported device {device}")
    out = _sender_degree_launch("plain_sender_degree", None, None, g, 1, False, True)
    plain_sender_degree.launches += 1
    return out


def plain_norm(g: GraphBatch):
    """``plain_sender_degree(g)``, computed at the batch's first call and
    kept in ``g.derived`` for the later ones: every plain conv of a batch
    shares one degree."""
    got = g.derived.get("plain_norm")
    if got is None:
        got = g.derived["plain_norm"] = plain_sender_degree(g)
    return got


def _sender_degree_launch(what, src, dst, g: GraphBatch, nb: int, negate: bool, norm: bool):
    """K1 (nb 2), K13 (nb 1, logits given) or the plain conv's count (nb 1,
    logits None) on CUDA tensors, one launch over the sender CSR: (the sums
    [nb, V], None), or with ``norm`` (deg, dis) [nb, V]."""
    device, v = g.senders.device, g.num_nodes
    _check_graph(what, g, device)
    if src is not None:
        src, dst = src.contiguous(), dst.contiguous()
    deg = torch.empty((nb, v), dtype=torch.float32, device=device)
    dis = torch.empty((nb, v), dtype=torch.float32, device=device) if norm else None
    partial = torch.empty((g.send.heavy_chunks.shape[0], nb), dtype=torch.float32,
                          device=device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _lib().sender_degree_launch(
        nb, int(negate), ptr(src), ptr(dst), 0 if src is None else _DTYPES[src.dtype],
        g.receivers.data_ptr(), g.edge_mask.data_ptr(), g.send.perm.data_ptr(),
        *_walk_csr(g.send), v, deg.data_ptr(), ptr(dis), partial.data_ptr(), _stream(device))
    build.check(err, what)
    return deg, dis


def _coef_spmm(what, xs, src, dst, deg, dis, g: GraphBatch, transpose: bool = False):
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
        return coef_spmm_plain(xs, src, dst, deg, dis, g, transpose)
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    _check_graph(what, g, device)
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    _check_walk_width(what, h, xs + outs)
    deg, dis = deg.contiguous(), dis.contiguous()
    if src is not None:
        src, dst = src.contiguous(), dst.contiguous()
    # transposed: the sender CSR, neighbours through its perm, logits swapped
    csr, nbr, perm = ((g.send, g.receivers, g.send.perm) if transpose
                      else (g.recv, g.senders, None))
    if transpose:
        src, dst = dst, src
    partial = torch.empty((csr.heavy_chunks.shape[0], nb * h), dtype=torch.float32,
                          device=device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _lib().coef_spmm_launch(
        nb, xs[0].data_ptr(), ptr(xs[1] if nb == 2 else None), ptr(src), ptr(dst),
        _DTYPES[xs[0].dtype], nbr.data_ptr(), ptr(perm), g.edge_mask.data_ptr(),
        deg.data_ptr(), dis.data_ptr(), *_walk_csr(csr), v, h, outs[0].data_ptr(),
        ptr(outs[1] if nb == 2 else None), partial.data_ptr(), _stream(device))
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


def pair_coef_spmm_t(gc, go, src, dst, deg, dis, g: GraphBatch):
    """K2T: (dxc, dxo) [V, H] in g's dtype, the x-gradient of K2 for the
    cotangents (gc, go), self term g / deg included.  ``src``/``dst`` are the
    forward's logits.  ``.launches`` counts kernel launches."""
    dc, do = _coef_spmm("pair_coef_spmm_t", [gc, go], src, dst, deg, dis, g, transpose=True)
    if gc.device.type == "cuda":
        pair_coef_spmm_t.launches += 1
    return dc, do


def plain_coef_spmm_t(gout, deg, dis, g: GraphBatch) -> torch.Tensor:
    """K3T: the x-gradient of K3 [V, H] in gout's dtype.  ``.launches``
    counts kernel launches."""
    (dx,) = _coef_spmm("plain_coef_spmm_t", [gout], None, None, deg, dis, g, transpose=True)
    if gout.device.type == "cuda":
        plain_coef_spmm_t.launches += 1
    return dx


def pair_sddmm_chain(xc, xo, gc, go, src, dst, dis, g: GraphBatch):
    """K5: (vec [3, E], ddis_s [2, V], ddis_r [2, V]) f32 (see
    ``pair_sddmm_chain_plain``); x, g and the logits of one dtype, ``dis``
    [2, V] f32.  Two kernel launches: the receiver pass (vec, ddis_r) and
    the sender sums (ddis_s).  ``.launches`` counts calls."""
    v, h = xc.shape
    what = "pair_sddmm_chain"
    _check_features(what, (xc, xo, gc, go), v, h)
    _check_features(what, (src[:, None], dst[:, None]), v, 1)
    if src.dtype != xc.dtype or dis.dtype != torch.float32 or tuple(dis.shape) != (2, v):
        raise ValueError(f"{what}: logits in x's dtype and dis [2, {v}] float32")
    device = xc.device
    if any(t.device != device for t in (src, dst, dis, g.senders)):
        raise ValueError(f"{what}: inputs on different devices")
    if device.type == "cpu":
        return pair_sddmm_chain_plain(xc, xo, gc, go, src, dst, dis, g)
    out = _sddmm_chain_launch(what, [xc, xo], [gc, go], src, dst, dis, g, False)
    pair_sddmm_chain.launches += 1
    return out


def _sddmm_chain_launch(what, xs, gs, src, dst, dis, g: GraphBatch, negate: bool):
    """K5 (two x/g planes: vec [3, E], ddis_s and ddis_r [2, V]) or K15 (one:
    vec [2, E], ddis_s and ddis_r [V]) on CUDA tensors: the receiver pass and
    the sender sums, two launches."""
    nb = len(xs)
    device = xs[0].device
    (v, h), e = xs[0].shape, g.senders.shape[0]
    _check_graph(what, g, device)
    xs = [t.contiguous() for t in xs + gs]
    _check_walk_width(what, h, xs)
    src, dst, dis = src.contiguous(), dst.contiguous(), dis.contiguous()
    shape = (nb, v) if nb == 2 else (v,)
    vec = torch.empty((nb + 1, e), dtype=torch.float32, device=device)
    terms = torch.empty((e, nb), dtype=torch.float32, device=device)
    ddis_s = torch.empty(shape, dtype=torch.float32, device=device)
    ddis_r = torch.empty(shape, dtype=torch.float32, device=device)
    partial = torch.empty((max(g.recv.heavy_chunks.shape[0], g.send.heavy_chunks.shape[0]), nb),
                          dtype=torch.float32, device=device)
    x1, g1 = (xs[1], xs[3]) if nb == 2 else (None, None)
    err = _lib().sddmm_chain_launch(
        nb, int(negate), xs[0].data_ptr(), None if x1 is None else x1.data_ptr(),
        xs[nb].data_ptr(), None if g1 is None else g1.data_ptr(), src.data_ptr(),
        dst.data_ptr(), _DTYPES[xs[0].dtype], g.senders.data_ptr(), g.edge_mask.data_ptr(),
        dis.data_ptr(), *_walk_csr(g.recv), *_walk_csr(g.send), g.send.perm.data_ptr(), v, e, h,
        vec.data_ptr(), terms.data_ptr(), ddis_s.data_ptr(), ddis_r.data_ptr(),
        partial.data_ptr(), _stream(device))
    build.check(err, what)
    return vec, ddis_s, ddis_r


def pair_dpre(vec, ddeg, g: GraphBatch):
    """K6: (dsrc, ddst) [V] f32 from K5's ``vec`` [3, E] and the degree
    gradient ``ddeg`` [2, V] f32.  One kernel launch over both CSRs.
    ``.launches`` counts calls."""
    v, e = g.num_nodes, g.senders.shape[0]
    what = "pair_dpre"
    if tuple(vec.shape) != (3, e) or tuple(ddeg.shape) != (2, v) or any(
            t.dtype != torch.float32 for t in (vec, ddeg)):
        raise ValueError(f"{what}: vec must be [3, {e}] and ddeg [2, {v}], float32")
    device = vec.device
    if any(t.device != device for t in (ddeg, g.senders)):
        raise ValueError(f"{what}: inputs on different devices")
    if device.type == "cpu":
        return pair_dpre_plain(vec, ddeg, g)
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    out = _dpre_launch(what, vec, ddeg, g, 2, False)
    pair_dpre.launches += 1
    return out


def _dpre_launch(what, vec, ddeg, g: GraphBatch, nb: int, negate: bool):
    """K6 (nb 2) or K16 (nb 1): (dsrc, ddst) [V] f32 on CUDA tensors, one
    launch over both CSRs."""
    device, v, e = vec.device, g.num_nodes, g.senders.shape[0]
    _check_graph(what, g, device)
    vec, ddeg = vec.contiguous(), ddeg.contiguous()
    dsrc = torch.empty(v, dtype=torch.float32, device=device)
    ddst = torch.empty(v, dtype=torch.float32, device=device)
    partial = torch.empty(g.recv.heavy_chunks.shape[0] + g.send.heavy_chunks.shape[0],
                          dtype=torch.float32, device=device)
    err = _lib().dpre_launch(
        nb, int(negate), vec.data_ptr(), ddeg.data_ptr(), g.senders.data_ptr(),
        *_walk_csr(g.recv), *_walk_csr(g.send), g.send.perm.data_ptr(), v, e, dsrc.data_ptr(),
        ddst.data_ptr(), partial.data_ptr(), _stream(device))
    build.check(err, what)
    return dsrc, ddst


pair_sender_degree.launches = 0
plain_sender_degree.launches = 0
pair_coef_spmm.launches = 0
plain_coef_spmm.launches = 0
pair_coef_spmm_t.launches = 0
plain_coef_spmm_t.launches = 0
pair_sddmm_chain.launches = 0
pair_dpre.launches = 0


class _PairAggregate(torch.autograd.Function):
    """K1 (with its deg / dis epilogue) + K2 forward; K2T, then (when the
    logits need a gradient) K5, the degree chain's elementwise step and K6
    backward (cal_tpu ``_pair_bwd``)."""

    @staticmethod
    def forward(ctx, xc, xo, src, dst, g):
        deg, dis = pair_sender_degree(src, dst, g, norm=True)
        ctx.save_for_backward(xc, xo, src, dst, deg, dis)
        ctx.g = g
        return pair_coef_spmm(xc, xo, src, dst, deg, dis, g)

    @staticmethod
    def backward(ctx, gc, go):
        xc, xo, src, dst, deg, dis = ctx.saved_tensors
        g = ctx.g
        need = ctx.needs_input_grad
        dxc = dxo = dsrc = ddst = None
        if need[0] or need[1]:
            dxc, dxo = pair_coef_spmm_t(gc, go, src, dst, deg, dis, g)
        if need[2] or need[3]:
            vec, ddis_s, ddis_r = pair_sddmm_chain(xc, xo, gc, go, src, dst, dis, g)
            inv = 1.0 / deg
            gx = torch.stack([(gc.float() * xc.float()).sum(1),
                              (go.float() * xo.float()).sum(1)])
            ddeg = -gx * inv * inv + (ddis_s + ddis_r) * (-0.5) * dis * inv
            dsrc, ddst = pair_dpre(vec, ddeg, g)
            dsrc, ddst = dsrc.to(src.dtype), ddst.to(dst.dtype)
        return dxc, dxo, dsrc, ddst, None


class _PlainAggregate(torch.autograd.Function):
    """The batch's plain degree (``plain_norm``: K1 at zero logits once a
    batch) + K3 forward; K3T backward (cal_tpu ``_plain_bwd``)."""

    @staticmethod
    def forward(ctx, x, g):
        deg, dis = plain_norm(g)
        ctx.save_for_backward(deg, dis)
        ctx.g = g
        return plain_coef_spmm(x, deg, dis, g)

    @staticmethod
    def backward(ctx, gout):
        deg, dis = ctx.saved_tensors
        return plain_coef_spmm_t(gout, deg, dis, ctx.g), None


def gcn_aggregate_sparse_pair(xc, xo, src, dst, g: GraphBatch):
    """Both masked causal convs of the sparse layout (counterpart of
    ``gcn_aggregate_sparse_sigmoid_pair_pallas``): out_c with w =
    sigmoid(src[s] + dst[r]) on xc, out_o with 1 - w on xo.  Differentiable
    in xc, xo, src and dst; the backward skips K5/K6 when neither logit
    needs a gradient (the constant weights of ``without_edge_attention``)."""
    return _PairAggregate.apply(xc, xo, src, dst, g)


def gcn_aggregate_sparse_plain(x, g: GraphBatch) -> torch.Tensor:
    """Unweighted GCN aggregate of the sparse layout (counterpart of
    ``gcn_aggregate_sparse_plain_pallas``): the batch's plain degree
    (``plain_norm``), then K3; differentiable in x (K3T)."""
    return _PlainAggregate.apply(x, g)


# ---- row 12: one sigmoid-weighted branch (K13-K16) -----------------------

def _sig_w(src, dst, s, r, live, negate: bool) -> torch.Tensor:
    """Per-edge f32 weight sigmoid(src[s] + dst[r]) (1 - it under
    ``negate``), 0 on dead edges."""
    sig = torch.sigmoid(src.float()[s] + dst.float()[r])
    return torch.where(live, 1.0 - sig if negate else sig, torch.zeros((), device=s.device))


def sigmoid_sender_degree_plain(src, dst, g: GraphBatch, negate: bool = False):
    """Plain twin of K13: (deg, dis) [V] f32, deg = 1 + the sender sums of
    the branch weights over live edges, dis = deg^-1/2."""
    s, r, live = _live(g)
    return _norm(torch.zeros(g.num_nodes, device=s.device).index_add_(
        0, s, _sig_w(src, dst, s, r, live, negate)))


def sigmoid_coef_spmm_plain(x, src, dst, deg, dis, g: GraphBatch, negate: bool = False,
                            transpose: bool = False) -> torch.Tensor:
    """Plain twin of K14: out[r] = sum over live e of (dis[s] w) dis[r] x[s]
    + x[r] / deg[r], in f32, rounded once to x's dtype; ``transpose``: K14T,
    rows and neighbours swapped (w stays a function of src[s] + dst[r])."""
    s, r, live = _live(g)
    row, nbr = (s, r) if transpose else (r, s)
    coef = dis[nbr] * _sig_w(src, dst, s, r, live, negate) * dis[row]
    x32 = x.float()
    out = torch.zeros_like(x32).index_add_(0, row, coef[:, None] * x32[nbr])
    return (out + x32 / deg[:, None]).to(x.dtype)


def sigmoid_sddmm_chain_plain(x, gout, src, dst, dis, g: GraphBatch, negate: bool = False):
    """Plain twin of K15: (vec [2, E], ddis_s [V], ddis_r [V]), all f32.
    dc[e] = <g[r], x[s]>; vec = (dc dis[s] dis[r], w (1 - w)), zero on dead
    edges; ddis_s sums dc w dis[r] by sender, ddis_r dc w dis[s] by
    receiver."""
    s, r, live = _live(g)
    zero = torch.zeros((), device=s.device)
    w = _sig_w(src, dst, s, r, live, negate)
    dc = torch.where(live, (gout.float()[r] * x.float()[s]).sum(-1), zero)
    vec = torch.stack([dc * dis[s] * dis[r], w * (1.0 - w)])
    z = torch.zeros(g.num_nodes, device=s.device)
    return vec, z.index_add(0, s, dc * w * dis[r]), z.index_add(0, r, dc * w * dis[s])


def sigmoid_dpre_plain(vec, ddeg, g: GraphBatch, negate: bool = False):
    """Plain twin of K16: dpre = (vec0 + ddeg[s]) vec1 (negated under
    ``negate``) summed by sender (dsrc) and by receiver (ddst), [V] f32."""
    s, r = g.senders.long(), g.receivers.long()
    dpre = (vec[0] + ddeg[s]) * vec[1]
    if negate:
        dpre = -dpre
    z = torch.zeros(g.num_nodes, device=s.device)
    return z.index_add(0, s, dpre), z.index_add(0, r, dpre)


def _check_logits(what, src, dst, x) -> None:
    """The single branch takes its logits in their own dtype (one for both),
    as cal_tpu's row 12 does; its kernels read them as f32."""
    v = x.shape[0]
    _check_features(what, (src[:, None], dst[:, None]), v, 1)
    if src.device != x.device:
        raise ValueError(f"{what}: logits and features on different devices")


def sigmoid_sender_degree(src, dst, g: GraphBatch, negate: bool = False):
    """K13: (deg, dis) [V] f32: 1 + the sender sums over live edges of
    sigmoid(src[s] + dst[r]) (1 - it under ``negate``), and its rsqrt, both
    written by one launch.  ``src``/``dst`` [V] of one dtype.
    ``.launches`` counts launches."""
    what = "sigmoid_sender_degree"
    v = g.num_nodes
    device = g.senders.device
    _check_features(what, (src[:, None], dst[:, None]), v, 1)
    if src.device != device:
        raise ValueError(f"{what}: logits and graph on different devices")
    if device.type == "cpu":
        return sigmoid_sender_degree_plain(src, dst, g, negate)
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    deg, dis = _sender_degree_launch(what, src.float(), dst.float(), g, 1, negate, True)
    sigmoid_sender_degree.launches += 1
    return deg[0], dis[0]


def _sig_coef_spmm(what, x, src, dst, deg, dis, g: GraphBatch, negate: bool, transpose: bool):
    v, h = x.shape
    _check_features(what, (x,), v, h)
    _check_logits(what, src, dst, x)
    for t in (deg, dis):
        if t.dtype != torch.float32 or tuple(t.shape) != (v,):
            raise ValueError(f"{what}: deg and dis must be [{v}] float32")
    device = x.device
    if any(t.device != device for t in (deg, dis, g.senders)):
        raise ValueError(f"{what}: inputs on different devices")
    if device.type == "cpu":
        return sigmoid_coef_spmm_plain(x, src, dst, deg, dis, g, negate, transpose)
    _check_graph(what, g, device)
    x = x.contiguous()
    out = torch.empty_like(x)
    _check_walk_width(what, h, [x, out])
    deg, dis, src, dst = (t.float().contiguous() for t in (deg, dis, src, dst))
    # transposed: the sender CSR, neighbours through its perm, logits swapped
    csr, nbr, perm = ((g.send, g.receivers, g.send.perm) if transpose
                      else (g.recv, g.senders, None))
    if transpose:
        src, dst = dst, src
    partial = torch.empty((csr.heavy_chunks.shape[0], h), dtype=torch.float32, device=device)
    err = _lib().sig_coef_spmm_launch(
        x.data_ptr(), src.data_ptr(), dst.data_ptr(), _DTYPES[x.dtype], int(negate),
        nbr.data_ptr(), None if perm is None else perm.data_ptr(), g.edge_mask.data_ptr(),
        deg.data_ptr(), dis.data_ptr(), *_walk_csr(csr), v, h, out.data_ptr(),
        partial.data_ptr(), _stream(device))
    build.check(err, what)
    return out


def sigmoid_coef_spmm(x, src, dst, deg, dis, g: GraphBatch, negate: bool = False):
    """K14: the branch's aggregate [V, H] in x's dtype from K13's ``deg`` and
    ``dis``.  ``.launches`` counts kernel launches."""
    out = _sig_coef_spmm("sigmoid_coef_spmm", x, src, dst, deg, dis, g, negate, False)
    if x.device.type == "cuda":
        sigmoid_coef_spmm.launches += 1
    return out


def sigmoid_coef_spmm_t(gout, src, dst, deg, dis, g: GraphBatch, negate: bool = False):
    """K14T: the x-gradient of K14 [V, H] in gout's dtype (self term g / deg
    included).  ``src``/``dst`` are the forward's logits.  ``.launches``
    counts kernel launches."""
    dx = _sig_coef_spmm("sigmoid_coef_spmm_t", gout, src, dst, deg, dis, g, negate, True)
    if gout.device.type == "cuda":
        sigmoid_coef_spmm_t.launches += 1
    return dx


def sigmoid_sddmm_chain(x, gout, src, dst, dis, g: GraphBatch, negate: bool = False):
    """K15: (vec [2, E], ddis_s [V], ddis_r [V]) f32 (see
    ``sigmoid_sddmm_chain_plain``); x, gout and the logits of one dtype,
    ``dis`` [V] f32.  Two kernel launches, as K5's.  ``.launches`` counts
    calls."""
    what = "sigmoid_sddmm_chain"
    v, h = x.shape
    _check_features(what, (x, gout), v, h)
    _check_logits(what, src, dst, x)
    if dis.dtype != torch.float32 or tuple(dis.shape) != (v,):
        raise ValueError(f"{what}: dis must be [{v}] float32")
    device = x.device
    if any(t.device != device for t in (dis, g.senders)):
        raise ValueError(f"{what}: inputs on different devices")
    if device.type == "cpu":
        return sigmoid_sddmm_chain_plain(x, gout, src, dst, dis, g, negate)
    out = _sddmm_chain_launch(what, [x], [gout], src.float(), dst.float(), dis, g, negate)
    sigmoid_sddmm_chain.launches += 1
    return out


def sigmoid_dpre(vec, ddeg, g: GraphBatch, negate: bool = False):
    """K16: (dsrc, ddst) [V] f32 from K15's ``vec`` [2, E] and the degree
    gradient ``ddeg`` [V] f32.  One kernel launch over both CSRs.
    ``.launches`` counts calls."""
    what = "sigmoid_dpre"
    v, e = g.num_nodes, g.senders.shape[0]
    if tuple(vec.shape) != (2, e) or tuple(ddeg.shape) != (v,) or any(
            t.dtype != torch.float32 for t in (vec, ddeg)):
        raise ValueError(f"{what}: vec must be [2, {e}] and ddeg [{v}], float32")
    device = vec.device
    if any(t.device != device for t in (ddeg, g.senders)):
        raise ValueError(f"{what}: inputs on different devices")
    if device.type == "cpu":
        return sigmoid_dpre_plain(vec, ddeg, g, negate)
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    out = _dpre_launch(what, vec, ddeg, g, 1, negate)
    sigmoid_dpre.launches += 1
    return out


sigmoid_sender_degree.launches = 0
sigmoid_coef_spmm.launches = 0
sigmoid_coef_spmm_t.launches = 0
sigmoid_sddmm_chain.launches = 0
sigmoid_dpre.launches = 0


class _SigmoidAggregate(torch.autograd.Function):
    """K13 + K14 forward; K14T, then (when a logit needs a gradient) K15, the
    degree chain's elementwise step and K16 backward (cal_tpu ``_sig_bwd``)."""

    @staticmethod
    def forward(ctx, x, src, dst, g, negate):
        deg, dis = sigmoid_sender_degree(src, dst, g, negate)
        ctx.save_for_backward(x, src, dst, deg, dis)
        ctx.g, ctx.negate = g, negate
        return sigmoid_coef_spmm(x, src, dst, deg, dis, g, negate)

    @staticmethod
    def backward(ctx, gout):
        x, src, dst, deg, dis = ctx.saved_tensors
        g, negate = ctx.g, ctx.negate
        need = ctx.needs_input_grad
        dx = dsrc = ddst = None
        if need[0]:
            dx = sigmoid_coef_spmm_t(gout, src, dst, deg, dis, g, negate).to(x.dtype)
        if need[1] or need[2]:
            vec, ddis_s, ddis_r = sigmoid_sddmm_chain(x, gout.to(x.dtype), src, dst, dis, g,
                                                      negate)
            inv = 1.0 / deg
            gx = (gout.float() * x.float()).sum(1)
            ddeg = -gx * inv * inv + (ddis_s + ddis_r) * (-0.5) * dis * inv
            dsrc, ddst = sigmoid_dpre(vec, ddeg, g, negate)
            dsrc, ddst = dsrc.to(src.dtype), ddst.to(dst.dtype)
        return dx, dsrc, ddst, None, None


def gcn_aggregate_sparse_sigmoid(x, src, dst, g: GraphBatch, negate: bool = False):
    """The single sigmoid-weighted sparse GCN aggregate (counterpart of
    ``gcn_aggregate_sparse_sigmoid_pallas``): w = sigmoid(src[s] + dst[r]),
    or 1 - it when ``negate``, on live edges; deg = 1 + the sender sums of
    w; out = sum of dis[s] w dis[r] x[s] + x / deg, computed in f32 and
    returned in x's dtype.  Differentiable in x, src and dst."""
    return _SigmoidAggregate.apply(x, src, dst, g, bool(negate))


def gcn_aggregate_sparse_sigmoid_plain(x, src, dst, g: GraphBatch, negate: bool = False):
    """``gcn_aggregate_sparse_sigmoid`` in plain PyTorch ops (gathers and
    ``index_add``), differentiated by autograd."""
    s, r, live = _live(g)
    w = _sig_w(src, dst, s, r, live, negate)
    deg = torch.zeros(g.num_nodes, device=s.device).index_add(0, s, w) + 1.0
    dis = torch.rsqrt(deg)
    x32 = x.float()
    out = torch.zeros_like(x32).index_add(0, r, (dis[s] * w * dis[r])[:, None] * x32[s])
    return (out + x32 / deg[:, None]).to(x.dtype)
