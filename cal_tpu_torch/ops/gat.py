"""Multi-head GAT aggregation written with plain tensor ops, and the keep-bit
hash of the sparse layout's attention dropout.

Counterpart of cal_tpu/ops/gat.py ``gat_aggregate_dense``,
``gat_aggregate_sparse`` and ``_mix32`` / ``_keep_mask`` / ``_head_ids``:
PyG-1.1.0 ``GATConv`` attention.  Per head h and edge s -> r: ``e =
leaky_relu(att_dst . xh_r + att_src . xh_s, 0.2)``, softmaxed over the
receiver's incoming edges with each duplicate edge one term and an analytic
self loop of multiplicity 1; ``out_r = sum_s alpha xh_s``.  The two
aggregates here materialize their scores ([B, N, N, heads] dense, [E,
heads] sparse), so the model path never calls them: the layer runs the
flash-GAT kernel (``ops/flash_gat.py``, Philox dropout bits the backward
replays) on the dense layout and the sparse GAT kernels
(``ops/gat_sparse.py``) on the sparse one, and the tests hold those
kernels' plain twins against these references.  ``gat_aggregate_sparse_mh``
(cal_tpu's ``gat_aggregate_sparse_pallas``) keeps the score and softmax
chain in torch ops and aggregates on the multi-head coefficient SpMM of
``ops/coo_spmm.py``; only the on-card parity entry point calls it.  The
sparse references apply attention dropout as cal_tpu's ``_alpha_dropout``
does, with Bernoulli bits from an explicit ``torch.Generator``: first the
edges' [E, heads] mask, then the self terms' [V, heads].

The sparse layout's keep bits are an integer hash of the edge id, the head
and a two-word seed, bit for bit cal_tpu's: the forward over the receiver
CSR and the dxh pass over the sender CSR draw the same bit per (edge,
head).  The hash runs here in int64 arithmetic masked to 32 bits (torch has
no full uint32 arithmetic); the kernels run it in uint32.  The words are
ints, or come from a seed buffer (``flash_gat.seed_buffer``, one int64 on
the card) as int64 tensors on its device, so a captured step draws the
seed that the host wrote into the buffer before each replay.
"""
from __future__ import annotations

import torch

from cal_tpu_torch.ops.coo_spmm import coo_spmm_mh
from cal_tpu_torch.ops.segment import segment_sum

NEG_SLOPE = 0.2   # PyG 1.1.0 GATConv default negative_slope
_BIG_NEG = -1e30
_M32 = 0xFFFFFFFF
_SALT = 0x632BE59B


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): c is split in 16-bit
    halves so no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def mix32(x: torch.Tensor, s0: int, s1: int) -> torch.Tensor:
    """Murmur3-style finalizer of uint32 counters ``x`` (int64 in [0, 2^32))
    under the seed words (s0, s1); cal_tpu/ops/gat.py ``_mix32``."""
    x = (_mul32(x, 0x9E3779B9) + s0) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13) ^ s1
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def seed_words(seed: int | torch.Tensor) -> tuple:
    """The two uint32 words (low, high) of a 64-bit dropout seed: ints of an
    int, int64 tensors on its device of a seed buffer (no host read)."""
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(())
    return seed & _M32, (seed >> 32) & _M32


def salted_word(s1, salt: int):
    """The second hash word of stream ``salt`` (0: edges, 1: self loops)."""
    return (s1 + _SALT * salt) & _M32


def keep_threshold(rate: float) -> int:
    """uint32 threshold of the keep test ``hash < threshold`` (probability
    1 - rate; truncated as numpy's uint32 conversion does)."""
    return int(min((1.0 - rate) * 4294967296.0, 4294967295.0))


def keep_mask(ids: torch.Tensor, words, rate: float, salt: int) -> torch.Tensor:
    """1.0 / 0.0 keep mask of ``ids`` (int, >= 0) at probability 1 - rate;
    cal_tpu/ops/gat.py ``_keep_mask``.  ``words``: the seed's two words, or
    its seed buffer."""
    s0, s1 = seed_words(words) if isinstance(words, torch.Tensor) else words
    h = mix32(ids.long(), s0, salted_word(s1, salt))
    return (h < keep_threshold(rate)).float()


def head_ids(base: torch.Tensor, heads: int) -> torch.Tensor:
    """[n] edge or node ids -> [n, heads] ids ``base * heads + h``."""
    return base.long()[:, None] * heads + torch.arange(heads, device=base.device)


def gat_aggregate_dense(xh: torch.Tensor, adj: torch.Tensor, att_dst: torch.Tensor,
                        att_src: torch.Tensor) -> torch.Tensor:
    """xh [B, N, heads, d]; adj [B, N, N] counts (row = receiver);
    att_dst / att_src [heads, d] (receiver / sender half).  Returns
    [B, N, heads, d] in xh's dtype; the aggregate accumulates in f32."""
    ti = torch.einsum("bnhd,hd->bnh", xh, att_dst)
    tj = torch.einsum("bnhd,hd->bnh", xh, att_src)
    score = torch.nn.functional.leaky_relu(ti[:, :, None, :] + tj[:, None, :, :], NEG_SLOPE)
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
    counts = adj * (1.0 - eye) + eye          # self loop has multiplicity 1
    allowed = (counts > 0)[..., None]
    masked = torch.where(allowed, score, torch.full_like(score, _BIG_NEG))
    m = masked.amax(dim=2, keepdim=True)
    num = torch.exp(masked - m) * counts[..., None]
    alpha = num / num.sum(dim=2, keepdim=True)
    return torch.einsum("brsh,bshd->brhd", alpha.float(), xh.float()).to(xh.dtype)


def _alpha_dropout(alpha: torch.Tensor, rate: float,
                   generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout on attention coefficients (cal_tpu ``_alpha_dropout``):
    keep with probability 1 - rate, a uniform draw of ``generator`` per
    entry."""
    if rate <= 0.0 or generator is None:
        return alpha
    keep = torch.rand(alpha.shape, generator=generator, device=alpha.device) < 1.0 - rate
    return torch.where(keep, alpha / (1.0 - rate), torch.zeros((), dtype=alpha.dtype,
                                                                 device=alpha.device))


def _sparse_alphas(ti, tj, s, r, live, v):
    """(alpha_e [E, heads], alpha_self [V, heads]) of the segment softmax
    with the analytic self loop, in ti's dtype."""
    heads = ti.shape[1]
    score = torch.nn.functional.leaky_relu(ti[r] + tj[s], NEG_SLOPE)
    score = torch.where(live, score, torch.full_like(score, _BIG_NEG))
    self_score = torch.nn.functional.leaky_relu(ti + tj, NEG_SLOPE)
    m = self_score.scatter_reduce(0, r[:, None].expand(-1, heads), score, "amax")
    num_e = torch.where(live, torch.exp(score - m[r]), torch.zeros_like(score))
    num_self = torch.exp(self_score - m)
    denom = segment_sum(num_e, r, v) + num_self
    return num_e / denom[r], num_self / denom


def gat_aggregate_sparse(xh: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
                         edge_mask: torch.Tensor, att_dst: torch.Tensor,
                         att_src: torch.Tensor, dropout_rate: float = 0.0,
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """Sparse multi-head GAT: SDDMM edge scores, segment softmax with the
    analytic self loop, attention dropout (with a ``generator``), SpMM.  xh
    [V, heads, d]; senders/receivers/edge_mask [E] (receiver-sorted);
    att_dst / att_src [heads, d].  Dead edges and self-loop edges are
    dropped.  Computes in xh's dtype, as the JAX version does."""
    v = xh.shape[0]
    ti = torch.einsum("vhd,hd->vh", xh, att_dst)
    tj = torch.einsum("vhd,hd->vh", xh, att_src)
    s, r = senders.long(), receivers.long()
    live = (edge_mask & (s != r))[:, None]
    alpha_e, alpha_self = _sparse_alphas(ti, tj, s, r, live, v)
    alpha_e = _alpha_dropout(alpha_e, dropout_rate, generator)
    alpha_self = _alpha_dropout(alpha_self, dropout_rate, generator)
    out = segment_sum(alpha_e[..., None] * xh[s], r, v)
    return out + alpha_self[..., None] * xh


def gat_aggregate_sparse_mh(xh: torch.Tensor, g, att_dst: torch.Tensor,
                            att_src: torch.Tensor, dropout_rate: float = 0.0,
                            generator: torch.Generator | None = None) -> torch.Tensor:
    """``gat_aggregate_sparse`` with the message aggregation on the
    multi-head coefficient SpMM (counterpart of cal_tpu's
    ``gat_aggregate_sparse_pallas``).  xh [V, heads, d] and g a GraphBatch.
    The score and softmax chain and the dropout (bits drawn as
    ``gat_aggregate_sparse`` draws them) run in f32 torch ops; K19 sums
    alpha_e x[s] per head by receiver, the self term is added in f32 and the
    result rounded once to xh's dtype.  Differentiable in xh, att_dst and
    att_src (K19T for the messages' dx, K20 for dalpha_e)."""
    v, heads, d = xh.shape
    xf = xh.float()
    ti = torch.einsum("vhd,hd->vh", xf, att_dst.float())
    tj = torch.einsum("vhd,hd->vh", xf, att_src.float())
    s, r = g.senders.long(), g.receivers.long()
    live = (g.edge_mask & (s != r))[:, None]
    alpha_e, alpha_self = _sparse_alphas(ti, tj, s, r, live, v)
    alpha_e = _alpha_dropout(alpha_e, dropout_rate, generator)
    alpha_self = _alpha_dropout(alpha_self, dropout_rate, generator)
    out = coo_spmm_mh(xf.reshape(v, heads * d), alpha_e.contiguous(), g, heads)
    out = out.reshape(v, heads, d) + alpha_self[..., None] * xf
    return out.to(xh.dtype)
