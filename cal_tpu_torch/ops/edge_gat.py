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
hand-written kernels in ``csrc/edge_gat.cu`` / ``csrc/edge_gat_bwd.cu`` over
the batch's ``EdgeIndex`` (built once a batch, on first use, and shared by
every layer), the backward taking the forward's softmax statistics; on CPU
tensors they run their plain twins, which write the formulas out per edge
slot.

Attention dropout: each (slot, head) draws its keep bit from Philox-4x32-10
(``flash_gat.philox_bits``) at counter ``slot * heads + h`` under the
layer's 64-bit seed, and each self term (node v = g*N + r, head h) at
counter ``2^40 + v * heads + h``, a range no slot reaches; kept iff the 32
bits, compared unsigned, are >= ``uint32(rate * 2^32)``.  That is cal_tpu's
law for this kernel (one keep bit per duplicate-edge slot and per self
term), not its bits: the TPU kernel draws Mosaic's PRNG.  The backward and
the twins draw the same bits as the forward kernel.  The seed is an int or
a seed buffer (``flash_gat.seed_buffer``), which the kernels read on the
card, so a captured step draws each replay's seed (an int is put into a new
buffer at the launch); the twins take either.
"""
from __future__ import annotations

import ctypes

import torch

from cal_tpu_torch.kernels import build
from cal_tpu_torch.ops.flash_gat import (
    _seed_arg,
    _seed_args,
    keep_threshold,
    philox_bits,
    seed_value,
)

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


def edge_keep(slot: torch.Tensor, rows: int, heads: int, seed, rate: float):
    """Keep masks (slots [E', heads], self terms [rows, heads]) of attention
    dropout at ``rate`` for the layer seed ``seed`` (an int or a seed
    buffer)."""
    seed = seed_value(seed)
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


def edge_gat_fwd_plain(ti, tj, xh, edge_flat, seed: int | torch.Tensor = 0, rate: float = 0.0):
    """Plain twin of the forward kernel: out [B, N, heads * d] in xh's dtype,
    accumulated in f32."""
    bsz, n, heads = ti.shape
    rv, sv, _, _, a_e, a_v, keep_e, keep_v = _alphas(ti, tj, edge_flat, seed, rate)
    x = xh.float().reshape(bsz * n, heads, -1)
    w_e, w_v = _dropped(a_e, keep_e, rate), _dropped(a_v, keep_v, rate)
    out = (w_v[..., None] * x).index_add(0, rv, w_e[..., None] * x[sv])
    return out.reshape(xh.shape).to(xh.dtype)


def edge_gat_bwd_plain(ti, tj, xh, edge_flat, g, seed: int | torch.Tensor = 0, rate: float = 0.0):
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
        lib.edge_keys_launch.argtypes = [vp, i, i, i, vp, vp]
        lib.edge_index_launch.argtypes = [vp, vp, vp, i, i, i, vp, vp]
        lib.edge_gat_fwd_launch.argtypes = [vp] * 10 + [i] * 5 + [vp, u, f, vp]
        for fn in (lib.edge_keys_launch, lib.edge_index_launch, lib.edge_gat_fwd_launch):
            fn.restype = ctypes.c_int
    return lib


def _lib_bwd():
    lib = build.load("edge_gat_bwd")
    if lib.edge_gat_bwd_launch.argtypes is None:
        vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.edge_gat_bwd_launch.argtypes = [vp] * 12 + [i] * 7 + [vp, u, f, vp]
        lib.edge_gat_bwd_launch.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned for the kernels' vector loads."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# A node with at most SPAN slots as receiver (or as sender) is walked by one
# lane group; a heavier one is cut into chunks of SPAN slots, one group each
# (csrc/edge_gat.cuh kSpan).
SPAN = 32


class EdgeIndex:
    """The index of a dense batch's sorted edge list that the edge GAT
    kernels walk: built once, on first use (``build``), on the list's
    device, and shared by every GAT layer's forward and backward of the
    batch (``graph.DenseGraphBatch.edge_index``).

    Over ``rows = B*N`` nodes and the list's E slots, in receiver order (the
    list's own, by ``(g*N + r)*N + s``) and in sender order (the slots
    sorted stably by ``(g*N + s)*N + r``), int32:

    - ``rrange`` [rows, 2]: node v's receiver slots [first, end); (0, 0)
      when it has none; ``srange`` [rows, 2] its sender-order places;
    - ``spos`` [E]: the sender-order place of each slot; ``srecv`` [E]: the
      receiver node at each sender-order place (-1 for padding);
    - ``light_r``: the nodes with 1..SPAN receiver slots; ``heavy_r`` [., 2]:
      one (node, place of its first chunk) per SPAN-slot chunk of a heavier
      receiver, a node's chunks at consecutive places in slot order;
      ``light_s`` / ``heavy_s`` the same over sender runs, ``light_s`` also
      holding the receivers without sender slots; ``counts`` [4] the valid
      lengths of the four lists (the arrays have capacity ``cap_l`` and
      ``cap_h``);
    - ``arrivals`` [2, cap_h]: the kernels' arrival counters of the heavy
      rows, 0 between launches (a launch sets back what it counted): the
      batch's launches share them, so they must run one after another, on
      the CUDA stream the index was built on (``stream``; a launch on
      another stream raises).

    On CUDA the lists' order follows the build's schedule (no result depends
    on it) and nothing synchronizes the host; on the CPU (``build_plain``)
    they are ascending."""

    def __init__(self, edge_flat: torch.Tensor, bsz: int, n: int):
        self.edge_flat, self.bsz, self.n = edge_flat, bsz, n
        self.num_slots = int(edge_flat.shape[0])
        self.rows = bsz * n
        self.cap_l = min(self.rows, 2 * self.num_slots)
        self.cap_h = self.num_slots // 16 + 1   # > sum of ceil(len / SPAN) over rows of > SPAN
        self.zeroed = self.rest = self._ptrs = self.stream = None

    @property
    def device(self):
        return self.edge_flat.device

    def _alloc(self):
        dev, rows, e = self.device, self.rows, self.num_slots
        if dev.type == "cuda":
            self.stream = torch.cuda.current_stream(dev).cuda_stream
        zeroed = torch.zeros(4 * rows + 8 + 2 * self.cap_h, dtype=torch.int32, device=dev)
        rest = torch.empty(2 * e + 2 * self.cap_l + 4 * self.cap_h, dtype=torch.int32,
                           device=dev)
        return zeroed, rest

    def _views(self):
        rows, e, cl, ch = self.rows, self.num_slots, self.cap_l, self.cap_h
        z, r = self.zeroed, self.rest
        o = 2 * e + 2 * cl
        return {"rrange": z[:2 * rows].view(rows, 2), "srange": z[2 * rows:4 * rows].view(rows, 2),
                "counts": z[4 * rows:4 * rows + 4],
                "arrivals": z[4 * rows + 8:].view(2, ch),
                "spos": r[:e], "srecv": r[e:2 * e], "light_r": r[2 * e:2 * e + cl],
                "light_s": r[2 * e + cl:o], "heavy_r": r[o:o + 2 * ch].view(ch, 2),
                "heavy_s": r[o + 2 * ch:].view(ch, 2)}

    def __getattr__(self, name):
        if name in ("rrange", "srange", "counts", "arrivals", "spos", "srecv", "light_r",
                    "light_s", "heavy_r", "heavy_s"):
            return self.build()._views()[name]
        raise AttributeError(name)

    def build(self) -> "EdgeIndex":
        """Build the index on the list's device, once."""
        if self.zeroed is None:
            if self.device.type == "cuda":
                self._build_cuda()
            else:
                self.build_plain()
        return self

    def _build_cuda(self):
        ef = _aligned(self.edge_flat)
        e, n, rows = self.num_slots, self.n, self.rows
        if ef.dtype != torch.int32 or rows * n >= 2**31:
            raise ValueError("EdgeIndex: the kernels take int32 edge_flat with B*N*N < 2^31")
        lib, stream = _lib(), _stream(ef)
        keys = torch.empty(e, dtype=torch.int32, device=ef.device)
        build.check(lib.edge_keys_launch(ef.data_ptr(), e, n, rows, keys.data_ptr(), stream),
                    "edge_index keys")
        keyt, perm = torch.sort(keys, stable=True)
        self.zeroed, self.rest = self._alloc()
        build.check(lib.edge_index_launch(ef.data_ptr(), keyt.data_ptr(), perm.data_ptr(), e, n,
                                          rows, self.pointers(), stream), "edge_index")

    def build_plain(self) -> "EdgeIndex":
        """The same index with plain tensor ops (lists ascending), on the
        list's device: the CPU path, and the reference of the kernels."""
        ef = self.edge_flat.long()
        dev, rows, n, e = ef.device, self.rows, self.n, self.num_slots
        total = rows * n
        real = (ef >= 0) & (ef < total)
        key = torch.where(real, (ef // (n * n) * n + ef % n) * n + (ef // n) % n,
                          torch.full((), total, device=dev))
        keyt, perm = torch.sort(key, stable=True)
        bounds = torch.arange(rows + 1, device=dev) * n
        node = torch.arange(rows, device=dev)
        zeroed, rest = self._alloc()
        self.zeroed, self.rest = zeroed, rest.fill_(-1)
        v = self._views()
        lens = []
        for name, keys in (("rrange", ef), ("srange", keyt)):
            ptr = torch.searchsorted(keys, bounds)
            beg, end = ptr[:-1], ptr[1:]
            live = end > beg
            v[name][:, 0] = torch.where(live, beg, 0)
            v[name][:, 1] = torch.where(live, end, 0)
            lens.append(end - beg)
        rlen, slen = lens
        v["spos"][perm] = torch.arange(e, dtype=torch.int32, device=dev)
        v["srecv"][:] = torch.where(keyt < total, keyt // (n * n) * n + keyt % n, -1)
        lists = (node[(rlen >= 1) & (rlen <= SPAN)], None,
                 node[((slen >= 1) & (slen <= SPAN)) | ((slen == 0) & (rlen > 0))], None)
        for i, (name, length) in enumerate((("light_r", rlen), ("heavy_r", rlen),
                                            ("light_s", slen), ("heavy_s", slen))):
            if lists[i] is None:
                heavy = node[length > SPAN]
                nch = (length[heavy] + SPAN - 1) // SPAN
                p0 = torch.cumsum(nch, 0) - nch
                items = torch.stack([heavy.repeat_interleave(nch), p0.repeat_interleave(nch)], 1)
            else:
                items = lists[i]
            v[name][:items.shape[0]] = items
            v["counts"][i] = items.shape[0]
        return self

    def as_lists(self) -> dict:
        """The index as Python lists, whatever order the build listed its
        nodes in: the ranges and maps as they are, the light lists sorted,
        the heavy lists as sorted (node, chunk) pairs.  Raises if a node's
        chunks do not take consecutive places from the place its entries
        name, or if an arrival counter is not 0."""
        counts = self.counts.tolist()
        out = {k: getattr(self, k).tolist() for k in ("spos", "srecv", "rrange", "srange")}
        out["light_r"] = sorted(self.light_r[:counts[0]].tolist())
        out["light_s"] = sorted(self.light_s[:counts[2]].tolist())
        for name, cnt in (("heavy_r", counts[1]), ("heavy_s", counts[3])):
            items = getattr(self, name)[:cnt].tolist()
            for p, (v, p0) in enumerate(items):
                if items[p0] != [v, p0] or (p != p0 and items[p - 1][0] != v):
                    raise ValueError(f"{name}: place {p} ({v}, {p0}) out of its node's run")
            out[name] = sorted((v, p - p0) for p, (v, p0) in enumerate(items))
        if self.arrivals.any():
            raise ValueError("an arrival counter is not 0")
        return out

    def pointers(self):
        """The 11 device pointers of csrc/edge_gat.cuh's ``Index``."""
        if self._ptrs is None:
            v = self._views()
            names = ("rrange", "srange", "spos", "srecv", "light_r", "heavy_r", "light_s",
                     "heavy_s", "counts")
            ptrs = [v[k].data_ptr() for k in names] + [v["arrivals"][i].data_ptr() for i in (0, 1)]
            self._ptrs = (ctypes.c_void_p * 11)(*ptrs)
        return self._ptrs


def _index_for(index, edge_flat, bsz: int, n: int) -> EdgeIndex:
    """``index`` built (a new one for ``edge_flat`` when None), checked
    against the list it is handed with and the stream of the launch."""
    if index is None:
        index = EdgeIndex(edge_flat, bsz, n)
    if (index.num_slots, index.bsz, index.n) != (edge_flat.shape[0], bsz, n) \
            or index.device != edge_flat.device:
        raise ValueError(f"edge index of {index.num_slots} slots, B {index.bsz}, N {index.n} on "
                         f"{index.device} does not fit edge_flat {tuple(edge_flat.shape)} on "
                         f"{edge_flat.device} at B {bsz}, N {n}")
    index.build()
    if index.stream is not None and index.stream != _stream(edge_flat):
        raise ValueError("edge index built on another CUDA stream: the launches over it share "
                         "its arrival counters and must run in order on its stream")
    return index


def _fwd_launch(ti, tj, xh, edge_flat, seed, rate, index):
    """The forward kernels on CUDA tensors: (out, stats [2, B*N, heads] f32:
    m_v and 1 / den_v of the nodes with slots)."""
    bsz, n, heads = ti.shape
    hd = xh.shape[-1]
    out = torch.empty_like(xh)
    stats = torch.empty((2, bsz * n, heads), dtype=torch.float32, device=xh.device)
    part_ml = torch.empty((index.cap_h, 2 * heads), dtype=torch.float32, device=xh.device)
    part_acc = torch.empty((index.cap_h, hd), dtype=torch.float32, device=xh.device)
    drop, _buf = _seed_args(seed, rate, xh.device)
    err = _lib().edge_gat_fwd_launch(
        ti.data_ptr(), tj.data_ptr(), xh.data_ptr(), edge_flat.data_ptr(), index.pointers(),
        out.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), part_ml.data_ptr(),
        part_acc.data_ptr(), bsz, n, heads, hd, _DTYPES[xh.dtype], *drop, _stream(xh))
    build.check(err, "edge_gat_fwd")
    return out, stats


def edge_gat_fwd(ti, tj, xh, edge_flat, seed: int | torch.Tensor = 0, rate: float = 0.0,
                 index: EdgeIndex | None = None, with_stats: bool = False):
    """Forward: ti, tj [B, N, heads] f32; xh [B, N, heads * d] (float32 or
    bfloat16); edge_flat [E] sorted -> out [B, N, heads * d] in xh's dtype,
    or (out, stats) with ``with_stats``: the softmax statistics that
    ``edge_gat_bwd`` takes ([2, B*N, heads] f32; None on the CPU).  Launches
    the kernels on CUDA tensors, over ``index`` (the batch's EdgeIndex of
    ``edge_flat``; built for this call when None), and runs
    ``edge_gat_fwd_plain`` on CPU tensors."""
    _check("edge_gat_fwd", ti, tj, xh, edge_flat)
    if ti.device.type == "cpu":
        out = edge_gat_fwd_plain(ti, tj, xh, edge_flat, seed, rate)
        return (out, None) if with_stats else out
    ti, tj, xh, edge_flat = (_aligned(t) for t in (ti, tj, xh, edge_flat))
    index = _index_for(index, edge_flat, *ti.shape[:2])
    out, stats = _fwd_launch(ti, tj, xh, edge_flat, seed, rate, index)
    edge_gat_fwd.launches += 1
    return (out, stats) if with_stats else out


def _bwd_scratch(slots: int, rows: int, heads: int, hd: int, cap_h: int) -> int:
    """f32 scratch of the backward (csrc/edge_gat_bwd.cu edge_gat_bwd_launch)."""
    r4 = lambda x: (x + 3) // 4 * 4
    return 2 * r4(slots * heads) + 2 * r4(rows * heads) + 4 * r4(cap_h * heads) + r4(cap_h * hd)


def edge_gat_bwd(ti, tj, xh, edge_flat, g, seed: int | torch.Tensor = 0, rate: float = 0.0,
                 index: EdgeIndex | None = None, stats: torch.Tensor | None = None):
    """VJP of ``edge_gat_fwd``'s out: g [B, N, heads * d] in xh's dtype ->
    (dti, dtj [B, N, heads] f32, dxh in xh's dtype).  Launches the backward
    kernels on CUDA tensors, over ``index`` (built when None) and the
    forward's ``stats`` (formed by the forward kernels when None), and runs
    ``edge_gat_bwd_plain`` on CPU tensors."""
    _check("edge_gat_bwd", ti, tj, xh, edge_flat, g)
    if ti.device.type == "cpu":
        return edge_gat_bwd_plain(ti, tj, xh, edge_flat, g, seed, rate)
    ti, tj, xh, edge_flat, g = (_aligned(t) for t in (ti, tj, xh, edge_flat, g))
    bsz, n, heads = ti.shape
    hd = xh.shape[-1]
    index = _index_for(index, edge_flat, bsz, n)
    if stats is None:
        stats = _fwd_launch(ti, tj, xh, edge_flat, seed, rate, index)[1]
    elif stats.shape != (2, bsz * n, heads) or stats.dtype != torch.float32 \
            or stats.device != ti.device:
        raise ValueError(f"edge_gat_bwd: stats {tuple(stats.shape)} {stats.dtype} on "
                         f"{stats.device}, want (2, {bsz * n}, {heads}) float32")
    stats = _aligned(stats)
    dti, dtj = torch.empty_like(ti), torch.empty_like(ti)
    dxh = torch.empty_like(xh)
    scratch = torch.empty(_bwd_scratch(index.num_slots, bsz * n, heads, hd, index.cap_h),
                          dtype=torch.float32, device=xh.device)
    drop, _buf = _seed_args(seed, rate, xh.device)
    err = _lib_bwd().edge_gat_bwd_launch(
        ti.data_ptr(), tj.data_ptr(), xh.data_ptr(), g.data_ptr(), edge_flat.data_ptr(),
        index.pointers(), stats[0].data_ptr(), stats[1].data_ptr(), scratch.data_ptr(),
        dti.data_ptr(), dtj.data_ptr(), dxh.data_ptr(), index.num_slots, index.cap_h, bsz, n,
        heads, hd, _DTYPES[xh.dtype], *drop, _stream(xh))
    build.check(err, "edge_gat_bwd")
    edge_gat_bwd.launches += 1
    return dti, dtj, dxh


edge_gat_fwd.launches = 0
edge_gat_bwd.launches = 0


class _EdgeGAT(torch.autograd.Function):
    """Differentiable in ti, tj and xh.  The forward hands its softmax
    statistics and the batch's index to the backward."""

    @staticmethod
    def forward(ctx, ti, tj, xh, edge_flat, seed, rate, index=None):
        if index is None:
            index = EdgeIndex(edge_flat, *ti.shape[:2])
        out, stats = edge_gat_fwd(ti, tj, xh, edge_flat, seed, rate, index, with_stats=True)
        ctx.save_for_backward(ti, tj, xh, edge_flat, *(() if stats is None else (stats,)))
        ctx.seed, ctx.rate, ctx.index = seed, rate, index
        return out

    @staticmethod
    def backward(ctx, g):
        ti, tj, xh, edge_flat, *stats = ctx.saved_tensors
        dti, dtj, dxh = edge_gat_bwd(ti, tj, xh, edge_flat, g.to(xh.dtype), ctx.seed, ctx.rate,
                                     ctx.index, stats[0] if stats else None)
        return dti, dtj, dxh, None, None, None, None


def edge_gat_dense_flat(xh_flat: torch.Tensor, edge_flat: torch.Tensor, att_dst: torch.Tensor,
                        att_src: torch.Tensor, dropout_rate: float = 0.0,
                        seed: int | torch.Tensor | None = None,
                        index: EdgeIndex | None = None) -> torch.Tensor:
    """Dense multi-head GAT over the batch's edge list, on xh in its
    [B, N, heads * d] layout.

    edge_flat [E]: the sorted flat (g*N + r)*N + s list of the packed batch
    (padding >= B*N*N); att_dst / att_src [heads, d].  Dropout runs at
    ``dropout_rate`` when a ``seed`` (a non-negative int below 2^64, or a
    ``flash_gat.seed_buffer``) is given; ``index`` is the batch's EdgeIndex
    of ``edge_flat`` (built for the call when None).  Returns [B, N, heads *
    d] in xh's dtype; differentiable in xh, att_dst and att_src."""
    bsz, n, _ = xh_flat.shape
    heads, d = att_dst.shape
    x4 = xh_flat.float().view(bsz, n, heads, d)
    dt = xh_flat.dtype
    ti = torch.einsum("bnhd,hd->bnh", x4, att_dst.to(dt).float())
    tj = torch.einsum("bnhd,hd->bnh", x4, att_src.to(dt).float())
    rate = float(dropout_rate) if seed is not None and dropout_rate > 0.0 else 0.0
    return _EdgeGAT.apply(ti, tj, xh_flat, edge_flat, _seed_arg(seed), rate, index)
