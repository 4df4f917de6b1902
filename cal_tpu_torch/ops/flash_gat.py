"""Flash-style dense multi-head GAT attention, forward and backward.

Counterpart of cal_tpu/ops/pallas_gat.py (``flash_gat_dense_flat``,
``flash_gat_dense`` and the custom VJP of ``_flash_core``).  The score
halves ``ti = xh . att_dst`` (receiver) and ``tj = xh . att_src`` (sender)
are formed here in f32 with plain tensor ops; the masked multiplicity
softmax, the attention dropout and ``alpha @ xh`` run in one kernel that
never writes the [B, heads, N, N] scores out, and a second kernel computes
the VJP from the saved row max and denominator.  ``_FlashGAT`` is a
``torch.autograd.Function`` differentiable in ti, tj and xh (not in the
count adjacency or the seed).  On CUDA tensors ``flash_gat_fwd`` /
``flash_gat_bwd`` launch the hand-written kernels in ``csrc/flash_gat.cu``;
on CPU tensors they run their plain twins, which write out the TPU kernels'
formulas (``_fwd_kernel`` / ``_bwd_kernel``).

Attention dropout: the keep bit of cell (b, h, r, s) comes from the
counter-based generator Philox-4x32-10 with that cell's flat index as the
counter and a 64-bit seed as the key (``dropout_keep``); the cell is kept
iff the 32 bits, compared unsigned, are >= ``uint32(rate * 2^32)``.  Graph
and head enter the counter, so no two cells share bits; the backward draws
the same bits as the forward, and the twins draw the kernels' bits exactly.
The TPU kernel draws Mosaic's PRNG instead, so dropout agrees with the JAX
package in law only.  The kernels read the seed from device memory: a seed
is an int or a seed buffer (``seed_buffer``: one int64 holding the 64 bits
on the card), which a captured step (a CUDA graph) reads at each replay, so
the host writes the step's seed into the buffer before it replays; an int
seed is put into a new buffer at the launch (an 8-byte host copy, no
kernel).  The twins take either.
"""
from __future__ import annotations

import ctypes

import torch

from cal_tpu_torch.kernels import build

NEG_SLOPE = 0.2
_BIG_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128          # a head's columns fit one warp, 4 a lane
_M32 = 0xFFFFFFFF
_M64 = 2**64 - 1


def _leaky(x):
    return torch.maximum(x, NEG_SLOPE * x)


def _mulhilo32(a, c: int):
    """(high, low) 32-bit words of a * c for int64 tensors a in [0, 2^32):
    the product is split in 16-bit halves of c so nothing leaves int64."""
    p0, p1 = a * (c & 0xFFFF), a * (c >> 16)            # each < 2^48
    low = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (low >> 32), low & _M32


def philox_bits(cell, k0: int, k1: int):
    """Philox-4x32-10's first output word for the counters (cell mod 2^32,
    cell div 2^32, 0, 0) under the key (k0, k1); ``cell`` int64 >= 0."""
    c0, c1 = cell & _M32, cell >> 32
    c2 = c3 = torch.zeros_like(cell)
    for _ in range(10):
        hi0, lo0 = _mulhilo32(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo32(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
    return c0


def seed_buffer(seed: int, device=None) -> torch.Tensor:
    """A 64-bit seed (an int in [0, 2^64)) as one int64 on ``device``, its
    bits unchanged: the low word (k0) first in memory, as the kernels read
    it.  An 8-byte host-to-device copy, not a kernel, and without a wait
    (CUDA stages pageable memory before the call returns)."""
    seed = int(seed) & _M64
    buf = torch.tensor([seed - 2**64 if seed >= 2**63 else seed], dtype=torch.int64)
    return buf if device is None else buf.to(device, non_blocking=True)


def seed_value(seed) -> int:
    """The 64-bit seed of an int or of a ``seed_buffer`` (read back to the
    host)."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError("a seed buffer is one int64")
        return int(seed.reshape(()).item()) & _M64
    return int(seed) & _M64


def keep_threshold(rate: float) -> int:
    """uint32 threshold of the keep test ``bits >= threshold``."""
    return min(int(rate * 2.0 ** 32), _M32)


def dropout_keep(seed: int, bsz: int, heads: int, n: int, rate: float,
                 device=None) -> torch.Tensor:
    """Keep mask [B, heads, N, N] (bool) of attention dropout at ``rate``:
    cell i = ((b * heads + h) * N + r) * N + s is kept iff
    philox_bits(i, seed mod 2^32, seed div 2^32) >= keep_threshold(rate).
    The kernels compute the same bits in uint32 arithmetic."""
    cell = torch.arange(bsz * heads * n * n, dtype=torch.int64, device=device)
    bits = philox_bits(cell, seed & _M32, (seed >> 32) & _M32)
    return (bits >= keep_threshold(rate)).view(bsz, heads, n, n)


def _heads_first(t, heads):
    """[B, N, heads * d] -> [B, heads, N, d] in f32."""
    b, n, hd = t.shape
    return t.float().view(b, n, heads, hd // heads).permute(0, 2, 1, 3)


def _cells(ti, tj, counts):
    """(raw score pre, allowed, ceff), each [B, heads, N, N] or [B, 1, N, N]."""
    n = counts.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=counts.device)
    ceff = torch.where(eye, torch.ones((), device=counts.device), counts.float())[:, None]
    pre = ti.transpose(1, 2)[..., :, None] + tj.transpose(1, 2)[..., None, :]
    return pre, ceff > 0, ceff


def _scale(rate):
    return 1.0 / (1.0 - rate) if rate > 0.0 else 1.0


def flash_gat_fwd_plain(ti, tj, counts, xh, seed=0, rate: float = 0.0):
    """Plain twin of the forward kernel (``_fwd_kernel``): returns out
    [B, N, heads * d], row max m and denominator den [B, N, heads], all f32."""
    bsz, n, heads = ti.shape
    pre, allowed, ceff = _cells(ti, tj, counts)
    s = torch.where(allowed, _leaky(pre), torch.full((), _BIG_NEG, device=ti.device))
    m = s.amax(dim=-1, keepdim=True)
    num = torch.exp(s - m) * ceff
    den = num.sum(dim=-1, keepdim=True)
    alpha = num * (1.0 / den)
    if rate > 0.0:
        keep = dropout_keep(seed_value(seed), bsz, heads, n, rate, ti.device)
        alpha = torch.where(keep, alpha, torch.zeros((), device=ti.device))
    acc = torch.matmul(alpha, _heads_first(xh, heads))
    if rate > 0.0:
        acc = _scale(rate) * acc
    out = acc.permute(0, 2, 1, 3).reshape(bsz, n, -1)
    return out, m[..., 0].transpose(1, 2).contiguous(), den[..., 0].transpose(1, 2).contiguous()


def flash_gat_bwd_plain(ti, tj, counts, xh, m, den, g, seed=0, rate: float = 0.0):
    """Plain twin of the backward kernel (``_bwd_kernel``): the VJP written
    out, not autograd of the forward twin.  g [B, N, heads * d] is the
    cotangent of the f32 output; returns dti, dtj [B, N, heads] in f32 and
    dxh in xh's dtype."""
    bsz, n, heads = ti.shape
    c = _scale(rate)
    pre, allowed, ceff = _cells(ti, tj, counts)
    lpre = torch.where(allowed, _leaky(pre), torch.full((), _BIG_NEG, device=ti.device))
    mh = m.transpose(1, 2)[..., None]
    dh = den.transpose(1, 2)[..., None]
    alpha = torch.exp(lpre - mh) * (ceff * (1.0 / dh))          # before dropout
    gh, xhh = _heads_first(g, heads), _heads_first(xh, heads)
    dalpha = torch.matmul(gh, xhh.transpose(-1, -2))
    if rate > 0.0:
        keep = dropout_keep(seed_value(seed), bsz, heads, n, rate, ti.device)
        zero = torch.zeros((), device=ti.device)
        alpha_drop = torch.where(keep, alpha, zero)
        dalpha = torch.where(keep, dalpha, zero)
    else:
        alpha_drop = alpha
    dxh = torch.matmul(alpha_drop.transpose(-1, -2), gh)
    t = (dalpha * alpha).sum(dim=-1, keepdim=True)
    ds = alpha * (dalpha - t)
    dpre = torch.where(pre >= 0, ds, NEG_SLOPE * ds)
    dti, dtj = dpre.sum(dim=-1), dpre.sum(dim=-2)
    if c != 1.0:
        dxh, dti, dtj = c * dxh, c * dti, c * dtj
    return (dti.transpose(1, 2).contiguous(), dtj.transpose(1, 2).contiguous(),
            dxh.permute(0, 2, 1, 3).reshape(bsz, n, -1).to(xh.dtype))


def _check(what, ti, tj, counts, xh, stats=()):
    bsz, n, heads = ti.shape
    hd = xh.shape[-1]
    if tj.shape != ti.shape or counts.shape != (bsz, n, n) or xh.shape[:2] != (bsz, n) \
            or hd % heads or any(t.shape != ti.shape for t in stats[:2]) \
            or any(t.shape != xh.shape for t in stats[2:]):
        raise ValueError(f"{what}: shape mismatch " + " ".join(
            str(tuple(t.shape)) for t in (ti, tj, counts, xh, *stats)))
    if any(t.dtype != torch.float32 for t in (ti, tj, *stats)):
        raise ValueError(f"{what}: ti, tj, m, den and g must be float32")
    if xh.dtype not in _DTYPES or counts.dtype != xh.dtype:
        raise ValueError(f"{what}: xh and counts must share one dtype (float32 or bfloat16)")
    if any(t.device != ti.device for t in (tj, counts, xh, *stats)):
        raise ValueError(f"{what}: inputs on different devices")
    if ti.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {ti.device}")
    if ti.device.type == "cuda" and hd // heads > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head width {hd // heads} > {MAX_HEAD_DIM}")


def _lib():
    lib = build.load("flash_gat")
    if lib.flash_gat_fwd_launch.argtypes is None:
        vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.flash_gat_fwd_launch.argtypes = [vp] * 7 + [i, i, i, i, i, vp, u, f, vp]
        lib.flash_gat_fwd_launch.restype = ctypes.c_int
        lib.flash_gat_bwd_launch.argtypes = [vp] * 11 + [i, i, i, i, i, vp, u, f, vp]
        lib.flash_gat_bwd_launch.restype = ctypes.c_int
    return lib


def as_seed_buffer(seed, device) -> torch.Tensor:
    """The seed buffer of a launch on ``device``: a seed buffer, checked to
    be one int64 there, or an int put into a new one."""
    if not isinstance(seed, torch.Tensor):
        return seed_buffer(seed, device)
    if seed.device != device or seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError(f"the seed buffer must be one int64 on {device}")
    return seed.contiguous()


def _seed_args(seed, rate: float, device):
    """(seed buffer or None, threshold, scale) of a launch, and the buffer
    to keep alive until the launch is enqueued."""
    if rate <= 0.0:
        return (None, 0, 1.0), None
    buf = as_seed_buffer(seed, device)
    return (buf.data_ptr(), keep_threshold(rate), _scale(rate)), buf


def flash_gat_fwd(ti, tj, counts, xh, seed=0, rate: float = 0.0):
    """Forward: ti, tj [B, N, heads] f32; counts [B, N, N] and xh
    [B, N, heads * d] of one dtype (float32 or bfloat16) -> (out [B, N,
    heads * d], m, den [B, N, heads]), all f32.  ``seed``: an int or a
    ``seed_buffer`` on the inputs' device.  Launches the kernel on CUDA
    tensors, runs ``flash_gat_fwd_plain`` on CPU tensors."""
    _check("flash_gat_fwd", ti, tj, counts, xh)
    if ti.device.type == "cpu":
        return flash_gat_fwd_plain(ti, tj, counts, xh, seed, rate)
    ti, tj, counts, xh = (t.contiguous() for t in (ti, tj, counts, xh))
    bsz, n, heads = ti.shape
    out = torch.empty(xh.shape, dtype=torch.float32, device=xh.device)
    m = torch.empty_like(ti)
    den = torch.empty_like(ti)
    args, _buf = _seed_args(seed, rate, xh.device)
    err = _lib().flash_gat_fwd_launch(
        ti.data_ptr(), tj.data_ptr(), counts.data_ptr(), xh.data_ptr(), out.data_ptr(),
        m.data_ptr(), den.data_ptr(), bsz, n, heads, xh.shape[-1] // heads,
        _DTYPES[xh.dtype], *args, torch.cuda.current_stream(xh.device).cuda_stream)
    build.check(err, "flash_gat_fwd")
    flash_gat_fwd.launches += 1
    return out, m, den


def flash_gat_bwd(ti, tj, counts, xh, m, den, g, seed=0, rate: float = 0.0):
    """VJP of ``flash_gat_fwd``'s out: g [B, N, heads * d] f32 -> (dti, dtj
    [B, N, heads] f32, dxh in xh's dtype); ``seed`` as the forward's.
    Launches the backward kernels on CUDA tensors, runs
    ``flash_gat_bwd_plain`` on CPU tensors."""
    if g.dtype != torch.float32:
        raise ValueError("flash_gat_bwd: g must be float32")
    _check("flash_gat_bwd", ti, tj, counts, xh, (m, den, g))
    if ti.device.type == "cpu":
        return flash_gat_bwd_plain(ti, tj, counts, xh, m, den, g, seed, rate)
    ti, tj, counts, xh, m, den, g = (t.contiguous() for t in (ti, tj, counts, xh, m, den, g))
    bsz, n, heads = ti.shape
    dti = torch.empty_like(ti)
    dtj = torch.empty_like(ti)
    dxh = torch.empty_like(xh)
    t_scratch = torch.empty((bsz, n, heads, 4), dtype=torch.float32, device=ti.device)
    args, _buf = _seed_args(seed, rate, xh.device)
    err = _lib().flash_gat_bwd_launch(
        ti.data_ptr(), tj.data_ptr(), counts.data_ptr(), xh.data_ptr(), m.data_ptr(),
        den.data_ptr(), g.data_ptr(), dti.data_ptr(), dtj.data_ptr(), dxh.data_ptr(),
        t_scratch.data_ptr(), bsz, n, heads, xh.shape[-1] // heads, _DTYPES[xh.dtype],
        *args, torch.cuda.current_stream(xh.device).cuda_stream)
    build.check(err, "flash_gat_bwd")
    flash_gat_bwd.launches += 1
    return dti, dtj, dxh


flash_gat_fwd.launches = 0
flash_gat_bwd.launches = 0


def _seed_arg(seed):
    """None -> 0; an int stays an int, a seed buffer a buffer."""
    if seed is None:
        return 0
    return seed if isinstance(seed, torch.Tensor) else int(seed)


class _FlashGAT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ti, tj, counts, xh, seed, rate):
        out, m, den = flash_gat_fwd(ti, tj, counts, xh, seed, rate)
        ctx.save_for_backward(ti, tj, counts, xh, m, den)
        ctx.seed, ctx.rate = seed, rate
        return out

    @staticmethod
    def backward(ctx, g):
        dti, dtj, dxh = flash_gat_bwd(*ctx.saved_tensors, g.float(), ctx.seed, ctx.rate)
        return dti, dtj, None, dxh, None, None


def flash_gat_dense_flat(xh_flat: torch.Tensor, adj: torch.Tensor, att_dst: torch.Tensor,
                         att_src: torch.Tensor, dropout_rate: float = 0.0,
                         seed: int | torch.Tensor | None = None) -> torch.Tensor:
    """Dense multi-head GAT on xh in its [B, N, heads * d] layout.

    adj [B, N, N] counts (row = receiver) of xh's dtype; att_dst / att_src
    [heads, d].  Dropout runs at ``dropout_rate`` when a ``seed`` (a
    non-negative int below 2^64, or a ``seed_buffer``) is given.  Returns [B, N, heads * d] in
    xh's dtype; differentiable in xh, att_dst and att_src."""
    bsz, n, hd = xh_flat.shape
    heads, d = att_dst.shape
    x4 = xh_flat.float().view(bsz, n, heads, d)
    dt = xh_flat.dtype
    ti = torch.einsum("bnhd,hd->bnh", x4, att_dst.to(dt).float())
    tj = torch.einsum("bnhd,hd->bnh", x4, att_src.to(dt).float())
    rate = float(dropout_rate) if seed is not None and dropout_rate > 0.0 else 0.0
    out = _FlashGAT.apply(ti, tj, adj.to(dt), xh_flat, _seed_arg(seed), rate)
    return out.to(dt)


def flash_gat_dense(xh: torch.Tensor, adj: torch.Tensor, att_dst: torch.Tensor,
                    att_src: torch.Tensor, dropout_rate: float = 0.0,
                    seed: int | torch.Tensor | None = None) -> torch.Tensor:
    """``flash_gat_dense_flat`` on xh [B, N, heads, d]; as the JAX version,
    the score halves are formed in xh's dtype.  Returns [B, N, heads, d]."""
    bsz, n, heads, d = xh.shape
    ti = torch.einsum("bnhd,hd->bnh", xh, att_dst).float()
    tj = torch.einsum("bnhd,hd->bnh", xh, att_src).float()
    rate = float(dropout_rate) if seed is not None and dropout_rate > 0.0 else 0.0
    out = _FlashGAT.apply(ti, tj, adj.to(xh.dtype), xh.reshape(bsz, n, heads * d),
                          _seed_arg(seed), rate)
    return out.view(bsz, n, heads, d).to(xh.dtype)
