"""Edge-formulated dense multi-head GAT attention, forward and backward.

Counterpart of cal_tpu/ops/pallas_gat_sparse.py (``edge_gat_dense`` and the
custom VJP of ``_edge_gat_core``): the same PyG-1.1.0 attention as the
flash kernel (``ops/flash_gat.py``), computed over each graph's edge list
(the dense batch's sorted ``edge_flat``) instead of its [N, N] cells.  Self
loops of the list are dropped and one analytic self term is added per node;
each duplicate slot is its own softmax term (the multiplicity weighting of
the count adjacency).  The score halves ``ti``/``tj`` [B, N, heads] are
formed in f32 with plain tensor ops, as in ``flash_gat_dense_flat``.
``_EdgeGAT`` is a ``torch.autograd.Function`` differentiable in ti, tj and
xh.  On CUDA tensors ``edge_gat_fwd`` / ``edge_gat_bwd`` launch the
hand-written kernels in ``csrc/edge_gat.cu``; on CPU tensors they run their
plain twins, which write the formulas out per edge slot.

Attention dropout: each (slot, head) draws its keep bit from Philox-4x32-10
(``flash_gat.philox_bits``) at counter ``slot * heads + h`` under the
layer's 64-bit seed, and each self term (node v = g*N + r, head h) at
counter ``2^40 + v * heads + h``, a range no slot reaches; kept iff the 32
bits, compared unsigned, are >= ``uint32(rate * 2^32)``.  That is cal_tpu's
law for this kernel (one keep bit per duplicate-edge slot and per self
term), not its bits: the TPU kernel draws Mosaic's PRNG.  The backward and
the twins draw the same bits as the forward kernel.
"""
from __future__ import annotations

import ctypes

import torch

from cal_tpu_torch.kernels import build
from cal_tpu_torch.ops.flash_gat import keep_threshold, philox_bits

NEG_SLOPE = 0.2
SELF_COUNTER = 1 << 40
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WIDTHS = (32, 64, 128, 256)     # heads * d of the kernels (columns per lane 1-8)
_M32 = 0xFFFFFFFF


def _leaky(x):
    return torch.maximum(x, NEG_SLOPE * x)


def _scale(rate: float) -> float:
    return 1.0 / (1.0 - rate) if rate > 0.0 else 1.0


def edge_slots(edge_flat: torch.Tensor, bsz: int, n: int):
    """(slot, receiver node, sender node) of the list's real edges that are
    not self loops, as int64 tensors; node ids are g*N + r and g*N + s."""
    ef = edge_flat.long()
    slot = torch.arange(ef.shape[0], device=ef.device)
    real = (ef >= 0) & (ef < bsz * n * n)
    ef, slot = ef[real], slot[real]
    g, r, s = ef // (n * n), (ef // n) % n, ef % n
    keep = r != s
    return slot[keep], (g * n + r)[keep], (g * n + s)[keep]


def edge_keep(slot: torch.Tensor, rows: int, heads: int, seed: int, rate: float):
    """Keep masks (slots [E', heads], self terms [rows, heads]) of attention
    dropout at ``rate`` for the layer seed ``seed``."""
    k0, k1, thresh = seed & _M32, (seed >> 32) & _M32, keep_threshold(rate)
    h = torch.arange(heads, device=slot.device)
    node = torch.arange(rows, device=slot.device)
    keep_e = philox_bits(slot[:, None] * heads + h, k0, k1) >= thresh
    keep_v = philox_bits(SELF_COUNTER + node[:, None] * heads + h, k0, k1) >= thresh
    return keep_e, keep_v


def _alphas(ti, tj, edge_flat, seed, rate):
    """Per-edge and self attention of the twins: (rv, sv, pre_e, pre_v,
    alpha_e, alpha_v, keep_e, keep_v), alpha before dropout, all f32 over
    flattened [B*N, heads] nodes (keep None without dropout)."""
    bsz, n, heads = ti.shape
    slot, rv, sv = edge_slots(edge_flat, bsz, n)
    tif, tjf = ti.reshape(bsz * n, heads), tj.reshape(bsz * n, heads)
    pre_e, pre_v = tif[rv] + tjf[sv], tif + tjf
    sc_e, sc_v = _leaky(pre_e), _leaky(pre_v)
    m = sc_v.scatter_reduce(0, rv[:, None].expand(-1, heads), sc_e, "amax")
    num_e, num_v = torch.exp(sc_e - m[rv]), torch.exp(sc_v - m)
    inv = 1.0 / num_v.index_add(0, rv, num_e)
    keep_e = keep_v = None
    if rate > 0.0:
        keep_e, keep_v = edge_keep(slot, bsz * n, heads, seed, rate)
    return rv, sv, pre_e, pre_v, num_e * inv[rv], num_v * inv, keep_e, keep_v


def _dropped(alpha, keep, rate):
    """keep * alpha * scale (alpha itself without dropout)."""
    if keep is None:
        return alpha
    return torch.where(keep, alpha * _scale(rate), torch.zeros((), device=alpha.device))


def edge_gat_fwd_plain(ti, tj, xh, edge_flat, seed: int = 0, rate: float = 0.0):
    """Plain twin of the forward kernel: out [B, N, heads * d] in xh's dtype,
    accumulated in f32."""
    bsz, n, heads = ti.shape
    rv, sv, _, _, a_e, a_v, keep_e, keep_v = _alphas(ti, tj, edge_flat, seed, rate)
    x = xh.float().reshape(bsz * n, heads, -1)
    w_e, w_v = _dropped(a_e, keep_e, rate), _dropped(a_v, keep_v, rate)
    out = (w_v[..., None] * x).index_add(0, rv, w_e[..., None] * x[sv])
    return out.reshape(xh.shape).to(xh.dtype)


def edge_gat_bwd_plain(ti, tj, xh, edge_flat, g, seed: int = 0, rate: float = 0.0):
    """Plain twin of the backward kernels: the VJP written out per edge (not
    autograd of the forward twin).  g [B, N, heads * d] is the cotangent of
    out; returns dti, dtj [B, N, heads] f32 and dxh in xh's dtype."""
    bsz, n, heads = ti.shape
    rv, sv, pre_e, pre_v, a_e, a_v, keep_e, keep_v = _alphas(ti, tj, edge_flat, seed, rate)
    x = xh.float().reshape(bsz * n, heads, -1)
    gf = g.float().reshape(bsz * n, heads, -1)
    da_e = _dropped((gf[rv] * x[sv]).sum(-1), keep_e, rate)
    da_v = _dropped((gf * x).sum(-1), keep_v, rate)
    t = (a_v * da_v).index_add(0, rv, a_e * da_e)
    ds_e, ds_v = a_e * (da_e - t[rv]), a_v * (da_v - t)
    dpre_e = torch.where(pre_e >= 0, ds_e, NEG_SLOPE * ds_e)
    dpre_v = torch.where(pre_v >= 0, ds_v, NEG_SLOPE * ds_v)
    dti = dpre_v.index_add(0, rv, dpre_e)
    dtj = dpre_v.index_add(0, sv, dpre_e)
    w_e, w_v = _dropped(a_e, keep_e, rate), _dropped(a_v, keep_v, rate)
    dxh = (w_v[..., None] * gf).index_add(0, sv, w_e[..., None] * gf[rv])
    return (dti.view(bsz, n, heads), dtj.view(bsz, n, heads),
            dxh.reshape(xh.shape).to(xh.dtype))


def _check(what, ti, tj, xh, edge_flat, g=None):
    bsz, n, heads = ti.shape
    hd = xh.shape[-1]
    if tj.shape != ti.shape or xh.shape[:2] != (bsz, n) or xh.dim() != 3 or hd % heads \
            or edge_flat.dim() != 1 or (g is not None and g.shape != xh.shape):
        raise ValueError(f"{what}: shape mismatch " + " ".join(
            str(tuple(t.shape)) for t in (ti, tj, xh, edge_flat) + ((g,) if g is not None else ())))
    if ti.dtype != torch.float32 or tj.dtype != torch.float32:
        raise ValueError(f"{what}: ti and tj must be float32")
    if xh.dtype not in _DTYPES or (g is not None and g.dtype != xh.dtype):
        raise ValueError(f"{what}: xh (and g) must be float32 or bfloat16, of one dtype")
    if edge_flat.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: edge_flat must be int32 or int64")
    if any(t.device != ti.device for t in (tj, xh, edge_flat) + ((g,) if g is not None else ())):
        raise ValueError(f"{what}: inputs on different devices")
    if ti.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {ti.device}")
    if ti.device.type == "cuda":
        if edge_flat.dtype != torch.int32 or bsz * n * n >= 2**31:
            raise ValueError(f"{what}: the kernels take int32 edge_flat with B*N*N < 2^31")
        if hd not in _WIDTHS or heads not in (1, 2, 4, 8):
            raise ValueError(f"{what}: the kernels take heads in (1, 2, 4, 8) and heads * d "
                             f"in {_WIDTHS}, got {heads} x {hd // heads}")


def _lib():
    lib = build.load("edge_gat")
    if lib.edge_gat_fwd_launch.argtypes is None:
        vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.edge_gat_fwd_launch.argtypes = [vp] * 4 + [i, vp, vp] + [i] * 5 + [u, u, u, f, vp]
        lib.edge_gat_fwd_launch.restype = ctypes.c_int
        lib.edge_gat_bwd_launch.argtypes = ([vp] * 7 + [i] + [vp] * 6 + [i] * 5
                                            + [u, u, u, f, vp])
        lib.edge_gat_bwd_launch.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned for the kernels' vector loads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _seed_args(seed: int, rate: float):
    return seed & _M32, (seed >> 32) & _M32, keep_threshold(rate) if rate > 0.0 else 0, \
        _scale(rate)


def edge_gat_fwd(ti, tj, xh, edge_flat, seed: int = 0, rate: float = 0.0):
    """Forward: ti, tj [B, N, heads] f32; xh [B, N, heads * d] (float32 or
    bfloat16); edge_flat [E] sorted -> out [B, N, heads * d] in xh's dtype.
    Launches the kernel on CUDA tensors, runs ``edge_gat_fwd_plain`` on CPU
    tensors."""
    _check("edge_gat_fwd", ti, tj, xh, edge_flat)
    if ti.device.type == "cpu":
        return edge_gat_fwd_plain(ti, tj, xh, edge_flat, seed, rate)
    ti, tj, xh, edge_flat = (_aligned(t) for t in (ti, tj, xh, edge_flat))
    bsz, n, heads = ti.shape
    out = torch.empty_like(xh)
    ptr = torch.empty(bsz * n + 1, dtype=torch.int32, device=xh.device)
    err = _lib().edge_gat_fwd_launch(
        ti.data_ptr(), tj.data_ptr(), xh.data_ptr(), edge_flat.data_ptr(), edge_flat.shape[0],
        ptr.data_ptr(), out.data_ptr(), bsz, n, heads, xh.shape[-1], _DTYPES[xh.dtype],
        *_seed_args(seed, rate), torch.cuda.current_stream(xh.device).cuda_stream)
    build.check(err, "edge_gat_fwd")
    edge_gat_fwd.launches += 1
    return out


def _sender_order(edge_flat: torch.Tensor, bsz: int, n: int):
    """(keyt, perm): the keys (g*N + s)*N + r of the slots sorted ascending
    (padding keeps B*N*N) and the slot of each, int32 — the sender-major
    order that the backward's sender kernel walks."""
    ef = edge_flat.long()
    total = bsz * n * n
    key = torch.where(ef < total, (ef // (n * n) * n + ef % n) * n + (ef // n) % n,
                      torch.full((), total, device=ef.device))
    keyt, perm = torch.sort(key, stable=True)
    return keyt.int(), perm.int()


def edge_gat_bwd(ti, tj, xh, edge_flat, g, seed: int = 0, rate: float = 0.0):
    """VJP of ``edge_gat_fwd``'s out: g [B, N, heads * d] in xh's dtype ->
    (dti, dtj [B, N, heads] f32, dxh in xh's dtype).  Launches the backward
    kernels on CUDA tensors, runs ``edge_gat_bwd_plain`` on CPU tensors."""
    _check("edge_gat_bwd", ti, tj, xh, edge_flat, g)
    if ti.device.type == "cpu":
        return edge_gat_bwd_plain(ti, tj, xh, edge_flat, g, seed, rate)
    ti, tj, xh, edge_flat, g = (_aligned(t) for t in (ti, tj, xh, edge_flat, g))
    bsz, n, heads = ti.shape
    e = edge_flat.shape[0]
    keyt, perm = _sender_order(edge_flat, bsz, n)
    dti, dtj = torch.empty_like(ti), torch.empty_like(ti)
    dxh = torch.empty_like(xh)
    ptrs = torch.empty(2, bsz * n + 1, dtype=torch.int32, device=xh.device)
    scratch = torch.empty(2 * (e + bsz * n) * heads, dtype=torch.float32, device=xh.device)
    err = _lib().edge_gat_bwd_launch(
        ti.data_ptr(), tj.data_ptr(), xh.data_ptr(), g.data_ptr(), edge_flat.data_ptr(),
        keyt.data_ptr(), perm.data_ptr(), e, ptrs[0].data_ptr(), ptrs[1].data_ptr(),
        scratch.data_ptr(), dti.data_ptr(), dtj.data_ptr(), dxh.data_ptr(), bsz, n, heads,
        xh.shape[-1], _DTYPES[xh.dtype], *_seed_args(seed, rate),
        torch.cuda.current_stream(xh.device).cuda_stream)
    build.check(err, "edge_gat_bwd")
    edge_gat_bwd.launches += 1
    return dti, dtj, dxh


edge_gat_fwd.launches = 0
edge_gat_bwd.launches = 0


class _EdgeGAT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ti, tj, xh, edge_flat, seed, rate):
        out = edge_gat_fwd(ti, tj, xh, edge_flat, seed, rate)
        ctx.save_for_backward(ti, tj, xh, edge_flat)
        ctx.seed, ctx.rate = seed, rate
        return out

    @staticmethod
    def backward(ctx, g):
        ti, tj, xh, edge_flat = ctx.saved_tensors
        dti, dtj, dxh = edge_gat_bwd(ti, tj, xh, edge_flat, g.to(xh.dtype), ctx.seed, ctx.rate)
        return dti, dtj, dxh, None, None, None


def edge_gat_dense_flat(xh_flat: torch.Tensor, edge_flat: torch.Tensor, att_dst: torch.Tensor,
                        att_src: torch.Tensor, dropout_rate: float = 0.0,
                        seed: int | None = None) -> torch.Tensor:
    """Dense multi-head GAT over the batch's edge list, on xh in its
    [B, N, heads * d] layout.

    edge_flat [E]: the sorted flat (g*N + r)*N + s list of the packed batch
    (padding >= B*N*N); att_dst / att_src [heads, d].  Dropout runs at
    ``dropout_rate`` when a ``seed`` (a non-negative int below 2^64) is
    given.  Returns [B, N, heads * d] in xh's dtype; differentiable in xh,
    att_dst and att_src."""
    bsz, n, _ = xh_flat.shape
    heads, d = att_dst.shape
    x4 = xh_flat.float().view(bsz, n, heads, d)
    dt = xh_flat.dtype
    ti = torch.einsum("bnhd,hd->bnh", x4, att_dst.to(dt).float())
    tj = torch.einsum("bnhd,hd->bnh", x4, att_src.to(dt).float())
    rate = float(dropout_rate) if seed is not None and dropout_rate > 0.0 else 0.0
    return _EdgeGAT.apply(ti, tj, xh_flat, edge_flat, 0 if seed is None else int(seed), rate)
