"""The dense masked GCN convs in one kernel each, forward and backward.

Counterpart of cal_tpu/ops/pallas_gcn.py: ``SigmoidEdgeWeight``,
``fused_gcn_dense_att_dual`` (both causal convs), ``fused_gcn_dense_att`` (one
sigmoid-weighted conv) and ``fused_gcn_dense`` (the unweighted normalized
aggregate), each with its custom VJP.  Each is a ``torch.autograd.Function``
differentiable in its features and logits (not in the adjacency, which is a
count):

* ``fused_gcn_dense_att_dual``: forward ``_dual_fwd``, backward
  ``fused_gcn_dense_att_dual_bwd`` (``_att_dual_fwd_kernel`` /
  ``_att_dual_bwd_kernel``);
* ``fused_gcn_dense_att`` (row 3): forward K18 (``_att_fwd_kernel``), backward
  ``fused_gcn_dense_att_bwd``, K18B (``_att_bwd_kernel``);
* ``fused_gcn_dense`` (row 4): forward K17 (``_mm_kernel``), backward
  ``fused_gcn_dense_t``, K17T, the same kernel with the adjacency transposed;
  in bf16 on graphs of up to 256 nodes both run in one launch that reads the
  adjacency once (``plain_cluster_size``), else in two passes.

All run modes of the kernels in ``csrc/fused_gcn.cu`` on CUDA tensors and their
plain twins on CPU tensors.  A forward kernel also writes the degree
statistics and the live map (``live_shape``: which 64 x 32 cells of adj hold
an edge); the weighted convs' Functions hand both to their backward, which
then reads adj only in the live cells.  The twins reproduce the TPU kernels' rounding: the
weighted adjacency m is built in f32 and cast to the compute dtype before a
product, ``x * dis`` and ``g * dis`` are formed in f32 and cast, every product
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

    def materialize(self) -> torch.Tensor:
        """Dense [B, N, N] weights in src's dtype (the plain path)."""
        att = torch.sigmoid(self.src.float()[:, None, :] + self.dst.float()[:, :, None])
        return (1.0 - att if self.negate else att).to(self.src.dtype)


_MODES = {"dual": 0, "sig": 1, "neg": 2, "plain": 3, "plain_t": 4}


def _offdiag(adj):
    """adj with a zero diagonal, f32."""
    off = ~torch.eye(adj.shape[-1], dtype=torch.bool, device=adj.device)
    return torch.where(off, adj.float(), torch.zeros((), device=adj.device))


def _weights(adj, src, dst):
    """(sigmoid, off-diagonal adjacency, m_c, m_o), all f32 [B, N, N]."""
    sig = torch.sigmoid(src.float()[:, None, :] + dst.float()[:, :, None])
    a_off = _offdiag(adj)
    mc = a_off * sig
    return sig, a_off, mc, a_off - mc


def _weights_single(adj, src, dst, negate):
    """(sigmoid, off-diagonal adjacency, m = a_off * w), f32 [B, N, N], with
    w = 1 - sigmoid when ``negate`` (cal_tpu's ``_att_weight``)."""
    sig = torch.sigmoid(src.float()[:, None, :] + dst.float()[:, :, None])
    a_off = _offdiag(adj)
    return sig, a_off, a_off * (1.0 - sig if negate else sig)


def _degree(m):
    deg = m.sum(dim=-2) + 1.0                        # [B, N] sender degree
    return torch.rsqrt(deg), 1.0 / deg


def _branch_plain(m, x, cdt, transpose=False):
    dis, inv = _degree(m)
    norm = (m * dis[:, None, :]) * dis[:, :, None]
    if transpose:
        norm = norm.transpose(1, 2)
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


def fused_gcn_dense_plain(x, adj, transpose=False):
    """Plain twin of K17 (K17T with ``transpose``): the unweighted
    normalized aggregate ``D^-1/2 M D^-1/2 x + x/deg`` (Mᵀ for K17T, the
    degree still M's column sums), with the kernel's rounding."""
    return _branch_plain(_offdiag(adj), x.float(), x.dtype, transpose).to(x.dtype)


def fused_gcn_dense_att_plain(x, adj, src, dst, negate=False):
    """Plain twin of K18: one sigmoid-weighted masked conv (1 - sigmoid when
    ``negate``), with the kernel's rounding."""
    _, _, m = _weights_single(adj, src, dst, negate)
    return _branch_plain(m, x.float(), x.dtype).to(x.dtype)


def fused_gcn_dense_att_bwd_plain(x, adj, src, dst, g, negate=False):
    """Plain twin of K18B: the VJP formulas of ``_att_bwd_kernel`` written
    out, with its rounding.  Returns (dx, dsrc, ddst) in the input dtype."""
    sig, a_off, m = _weights_single(adj, src, dst, negate)
    dx, dm = _branch_bwd_plain(m, x.float(), g.float(), x.dtype)
    dpre = dm * a_off * (sig * (1.0 - sig))
    if negate:
        dpre = -dpre
    return (dx.to(x.dtype), dpre.sum(dim=-2).to(src.dtype), dpre.sum(dim=-1).to(dst.dtype))


def _check(what, feats, adj, logits=()):
    """feats: [B, N, H] tensors of one shape; adj [B, N, N]; logits [B, N]."""
    x = feats[0]
    bsz, n, _ = x.shape
    ts = (*feats, adj, *logits)
    if any(t.shape != x.shape for t in feats) or adj.shape != (bsz, n, n) \
            or any(t.shape != (bsz, n) for t in logits):
        raise ValueError(f"{what}: shape mismatch "
                         + " ".join(str(tuple(t.shape)) for t in ts))
    if any(t.dtype != x.dtype for t in ts) or x.dtype not in _DTYPES:
        raise ValueError(f"{what}: inputs must share one dtype (float32 or bfloat16)")
    if any(t.device != x.device for t in ts):
        raise ValueError(f"{what}: inputs on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _lib():
    lib = build.load("fused_gcn")
    if lib.gcn_fwd_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gcn_fwd_launch.argtypes = [vp] * 9 + [i, i, i, i, i, vp]
        lib.gcn_fwd_launch.restype = ctypes.c_int
        lib.gcn_bwd_launch.argtypes = [vp] * 14 + [i, i, i, i, i, vp]
        lib.gcn_bwd_launch.restype = ctypes.c_int
        lib.gcn_bwd_scratch_floats.argtypes = [i] * 5
        lib.gcn_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.gcn_plain_cluster_launch.argtypes = [vp] * 3 + [i] * 5 + [vp]
        lib.gcn_plain_cluster_launch.restype = ctypes.c_int
        lib.gcn_plain_cluster_plan.argtypes = [i, i, vp]
        lib.gcn_plain_cluster_plan.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


LIVE_ROWS, LIVE_COLS = 64, 32   # the live map's cell: a strip of rows x a group of columns


def live_shape(bsz, n):
    """Shape of the live map of a [B, N, N] adjacency: a byte per (64-row
    strip, 32-column group) of each graph, 1 where an edge other than a self
    loop lies."""
    return bsz, -(-n // LIVE_ROWS), -(-n // LIVE_COLS)


def _fwd_launch(what, mode, xs, adj, src=None, dst=None):
    """Launch the forward kernel in ``mode`` on contiguous CUDA tensors:
    (one output per feature tensor in ``xs``, the degree statistics
    [2 * len(xs), B, N] f32: deg^-1/2 and 1/deg of each branch, the live map
    ``live_shape(B, N)`` uint8)."""
    bsz, n, h = xs[0].shape
    outs = [torch.empty_like(x) for x in xs]
    stats = torch.empty((2 * len(xs), bsz, n), dtype=torch.float32, device=adj.device)
    live = torch.empty(live_shape(bsz, n), dtype=torch.uint8, device=adj.device)
    x1, o1 = (xs[1], outs[1]) if len(xs) == 2 else (None, None)
    err = _lib().gcn_fwd_launch(
        adj.data_ptr(), xs[0].data_ptr(), _ptr(x1), _ptr(src), _ptr(dst), outs[0].data_ptr(),
        _ptr(o1), stats.data_ptr(), live.data_ptr(), bsz, n, h, _DTYPES[adj.dtype],
        _MODES[mode], torch.cuda.current_stream(adj.device).cuda_stream)
    build.check(err, what)
    return outs, stats, live


def _check_handed(what, stats, live, branches, x):
    """The forward's degree statistics and live map, handed to a backward on
    x's device: both or neither, each of the forward's shape."""
    if stats is None and live is None:
        return
    bsz, n, _ = x.shape
    if stats is None or live is None:
        raise ValueError(f"{what}: stats and live come together, from one forward call")
    if (stats.shape != (2 * branches, bsz, n) or stats.dtype != torch.float32
            or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError(f"{what}: stats must be the forward's contiguous "
                         f"[{2 * branches}, B, N] float32 on {x.device}")
    if (live.shape != live_shape(bsz, n) or live.dtype != torch.uint8
            or live.device != x.device or not live.is_contiguous()):
        raise ValueError(f"{what}: live must be the forward's contiguous "
                         f"{list(live_shape(bsz, n))} uint8 on {x.device}")


def _bwd_launch(what, mode, xs, gs, adj, src, dst, stats=None, live=None):
    """Launch the backward kernel in ``mode`` on contiguous CUDA tensors:
    (dx per feature tensor, dsrc, ddst).  ``stats`` and ``live``: the
    forward's degree statistics and live map for these inputs, which spare
    the backward its degree pass."""
    bsz, n, h = xs[0].shape
    lib = _lib()
    dxs = [torch.empty_like(x) for x in xs]
    dsrc, ddst = torch.empty_like(src), torch.empty_like(dst)
    words = lib.gcn_bwd_scratch_floats(bsz, n, h, _DTYPES[adj.dtype], _MODES[mode])
    scratch = torch.empty(words, dtype=torch.float32, device=adj.device)
    two = len(xs) == 2
    err = lib.gcn_bwd_launch(
        adj.data_ptr(), xs[0].data_ptr(), _ptr(xs[1] if two else None), src.data_ptr(),
        dst.data_ptr(), gs[0].data_ptr(), _ptr(gs[1] if two else None), dxs[0].data_ptr(),
        _ptr(dxs[1] if two else None), dsrc.data_ptr(), ddst.data_ptr(), scratch.data_ptr(),
        _ptr(stats), _ptr(live), bsz, n, h, _DTYPES[adj.dtype], _MODES[mode],
        torch.cuda.current_stream(adj.device).cuda_stream)
    build.check(err, what)
    return dxs, dsrc, ddst


def _contig(*ts):
    return [t.contiguous() for t in ts]


def _dual_fwd(xc, xo, adj, src, dst):
    """Forward wrapper: the kernel on CUDA tensors, the plain twin on CPU
    tensors (no autograd).  Returns ((oc, oo), the degree statistics and the
    live map for the backward, both None on the CPU)."""
    _check("fused_gcn_dense_att_dual", (xc, xo), adj, (src, dst))
    if xc.device.type == "cpu":
        return fused_gcn_dense_att_dual_plain(xc, xo, adj, src, dst), None, None
    xc, xo, adj, src, dst = _contig(xc, xo, adj, src, dst)
    (oc, oo), stats, live = _fwd_launch("fused_gcn_dense_att_dual", "dual", (xc, xo), adj, src,
                                        dst)
    fused_gcn_dense_att_dual.launches += 1
    return (oc, oo), stats, live


def fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc, go, stats=None, live=None):
    """VJP of both masked convs: cotangents gc/go [B, N, H] of (oc, oo) ->
    (dxc, dxo, dsrc, ddst).  Launches the backward kernel on CUDA tensors,
    runs ``fused_gcn_dense_att_dual_bwd_plain`` on CPU tensors.  ``stats``
    and ``live`` (CUDA only, together): the forward kernel's degree
    statistics ([4, B, N] f32) and live map (``live_shape(B, N)`` uint8) for
    these inputs, which ``fused_gcn_dense_att_dual`` keeps for its backward,
    sparing the kernel its degree pass; the same numbers."""
    what = "fused_gcn_dense_att_dual_bwd"
    _check(what, (xc, xo, gc, go), adj, (src, dst))
    if xc.device.type == "cpu":
        return fused_gcn_dense_att_dual_bwd_plain(xc, xo, adj, src, dst, gc, go)
    _check_handed(what, stats, live, 2, xc)
    xc, xo, adj, src, dst, gc, go = _contig(xc, xo, adj, src, dst, gc, go)
    (dxc, dxo), dsrc, ddst = _bwd_launch(what, "dual", (xc, xo), (gc, go), adj, src, dst,
                                         stats, live)
    fused_gcn_dense_att_dual_bwd.launches += 1
    return dxc, dxo, dsrc, ddst


class _DualGCN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, xo, adj, src, dst):
        outs, stats, live = _dual_fwd(xc, xo, adj, src, dst)
        ctx.save_for_backward(xc, xo, adj, src, dst, stats, live)
        return outs

    @staticmethod
    def backward(ctx, gc, go):
        *args, stats, live = ctx.saved_tensors
        dxc, dxo, dsrc, ddst = fused_gcn_dense_att_dual_bwd(*args, gc, go, stats, live)
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


# ---- row 3: one sigmoid-weighted conv (K18, K18B) ------------------------
def _att_fwd(x, adj, src, dst, negate):
    """K18 on CUDA tensors, its plain twin on CPU tensors (no autograd).
    Returns (out, the degree statistics and the live map for the backward,
    both None on the CPU)."""
    _check("fused_gcn_dense_att", (x,), adj, (src, dst))
    if x.device.type == "cpu":
        return fused_gcn_dense_att_plain(x, adj, src, dst, negate), None, None
    x, adj, src, dst = _contig(x, adj, src, dst)
    (out,), stats, live = _fwd_launch("fused_gcn_dense_att", "neg" if negate else "sig", (x,),
                                      adj, src, dst)
    fused_gcn_dense_att.launches += 1
    return out, stats, live


def fused_gcn_dense_att_bwd(x, adj, src, dst, g, negate=False, stats=None, live=None):
    """K18B: the VJP of one weighted conv, cotangent g [B, N, H] ->
    (dx, dsrc, ddst).  Launches the kernel on CUDA tensors, runs
    ``fused_gcn_dense_att_bwd_plain`` on CPU tensors.  ``stats`` and
    ``live`` (CUDA only, together): K18's degree statistics ([2, B, N] f32)
    and live map for these inputs and ``negate``, sparing the kernel its
    degree pass; the same numbers."""
    what = "fused_gcn_dense_att_bwd"
    _check(what, (x, g), adj, (src, dst))
    if x.device.type == "cpu":
        return fused_gcn_dense_att_bwd_plain(x, adj, src, dst, g, negate)
    _check_handed(what, stats, live, 1, x)
    x, adj, src, dst, g = _contig(x, adj, src, dst, g)
    (dx,), dsrc, ddst = _bwd_launch(what, "neg" if negate else "sig", (x,), (g,), adj, src,
                                    dst, stats, live)
    fused_gcn_dense_att_bwd.launches += 1
    return dx, dsrc, ddst


class _AttGCN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj, src, dst, negate):
        out, stats, live = _att_fwd(x, adj, src, dst, negate)
        ctx.save_for_backward(x, adj, src, dst, stats, live)
        ctx.negate = negate
        return out

    @staticmethod
    def backward(ctx, g):
        x, adj, src, dst, stats, live = ctx.saved_tensors
        dx, dsrc, ddst = fused_gcn_dense_att_bwd(x, adj, src, dst, g, ctx.negate, stats, live)
        return dx, None, dsrc, ddst, None


def fused_gcn_dense_att(x, adj, src, dst, negate=False):
    """One attention-weighted normalized GCN aggregate (row 3): edge s -> r
    weighs sigmoid(src_s + dst_r), or 1 - that when ``negate``; equal to
    ``gcn_aggregate_dense(x, adj, SigmoidEdgeWeight(src, dst, negate)
    .materialize())`` up to rounding.  x [B, N, H], adj [B, N, N], src/dst
    [B, N], one dtype.  Differentiable in x, src and dst; ``.launches``
    counts K18 launches, ``fused_gcn_dense_att_bwd.launches`` K18B ones."""
    return _AttGCN.apply(x, adj, src, dst, bool(negate))


# ---- row 4: the unweighted normalized aggregate (K17, K17T) ---------------
CLUSTER_ROWS = 128    # output rows a CTA of the one-launch path owns
MAX_CLUSTER_N = 256   # its largest graph: two slab buffers and x fill shared memory


def plain_cluster_size(dtype, n, h):
    """CTAs per graph of K17/K17T's one-launch path (a thread-block cluster
    that reads the adjacency once): ceil(N / 128), for bfloat16 with H a
    multiple of 8 and 0 < N <= 256; 0 otherwise, the two-pass path (a
    degree pass, then the aggregate)."""
    if dtype != torch.bfloat16 or h % 8 or not 0 < n <= MAX_CLUSTER_N:
        return 0
    return -(-n // CLUSTER_ROWS)


def _mm(what, x, adj, transpose):
    _check(what, (x,), adj)
    if x.device.type == "cpu":
        return fused_gcn_dense_plain(x, adj, transpose)
    x, adj = _contig(x, adj)
    bsz, n, h = x.shape
    cluster = plain_cluster_size(x.dtype, n, h) if x.data_ptr() % 16 == 0 else 0
    if not cluster:
        (out,), _, _ = _fwd_launch(what, "plain_t" if transpose else "plain", (x,), adj)
        return out
    out = torch.empty_like(x)
    err = _lib().gcn_plain_cluster_launch(
        adj.data_ptr(), x.data_ptr(), out.data_ptr(), bsz, n, h, int(transpose), cluster,
        torch.cuda.current_stream(adj.device).cuda_stream)
    build.check(err, what)
    return out


def _mm_fwd(x, adj):
    out = _mm("fused_gcn_dense", x, adj, False)
    if x.device.type == "cuda":
        fused_gcn_dense.launches += 1
    return out


def fused_gcn_dense_t(g, adj):
    """K17T: ``D^-1/2 Mᵀ D^-1/2 g + g/deg`` (deg M's column sums), the VJP
    of ``fused_gcn_dense``; the kernel on CUDA tensors, the plain twin on
    CPU tensors.  ``.launches`` counts kernel launches."""
    out = _mm("fused_gcn_dense_t", g, adj, True)
    if g.device.type == "cuda":
        fused_gcn_dense_t.launches += 1
    return out


class _PlainGCN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj):
        ctx.save_for_backward(adj)
        return _mm_fwd(x, adj)

    @staticmethod
    def backward(ctx, g):
        (adj,) = ctx.saved_tensors
        return fused_gcn_dense_t(g.to(adj.dtype), adj), None


def fused_gcn_dense(x, adj):
    """The unweighted normalized GCN aggregate (row 4): self loops dropped
    and re-added, sender degree; x [B, N, H], adj [B, N, N] counts of x's
    dtype.  Differentiable in x (K17T); ``.launches`` counts K17 launches."""
    return _PlainGCN.apply(x, adj)


fused_gcn_dense_att_dual.launches = 0
fused_gcn_dense_att_dual_bwd.launches = 0
fused_gcn_dense_att.launches = 0
fused_gcn_dense_att_bwd.launches = 0
fused_gcn_dense.launches = 0
fused_gcn_dense_t.launches = 0
