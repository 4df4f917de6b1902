"""Layers: mask-aware BatchNorm, reference-init linear layers, GCN, GIN and
GAT convs, readout.

Counterpart of cal_tpu/nn/layers.py.  Parameter names and layouts follow the
flax modules exactly (``kernel`` is [in, out], ``bias`` [out]; BatchNorm has
``scale``/``bias`` parameters and ``mean``/``var`` buffers), so a flax
checkpoint maps onto ``state_dict`` keys by joining the tree path with dots.

Initializers of the reference stack:
  * torch ``nn.Linear``: weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in));
  * PyG ``glorot``: U(-sqrt(6/(fan_in+fan_out)), +...), bias zeros;
  * BatchNorm1d: eps 1e-5, momentum 0.1, weight 1 and bias 1e-4 (the
    reference re-initializes every BN so).
Parameters stay f32; ``dtype`` is the compute dtype of a layer's output, and
its products accumulate in f32.
"""
from __future__ import annotations

import torch
from torch import nn

from cal_tpu_torch.graph import GraphBatch
from cal_tpu_torch.ops.edge_gat import edge_gat_dense_flat
from cal_tpu_torch.ops.flash_gat import flash_gat_dense_flat
from cal_tpu_torch.ops.gat import seed_words
from cal_tpu_torch.ops.gat_sparse import gat_aggregate_sparse_fused
from cal_tpu_torch.ops.gcn import gcn_aggregate
from cal_tpu_torch.ops.gin import gin_aggregate


def torch_linear_init(t: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    bound = 1.0 / fan_in ** 0.5
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def glorot_init(t: torch.Tensor, fan_in: int, fan_out: int,
                generator=None) -> torch.Tensor:
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def linear(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` of both cast to ``dtype``, accumulated and returned in f32."""
    return torch.matmul(x.to(dtype).float(), w.to(dtype).float())


class TorchLinear(nn.Module):
    """nn.Linear with torch's default init (attention MLPs, readout FCs)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch_linear_init(
            torch.empty(in_features, features), in_features, generator))
        self.bias = (nn.Parameter(torch_linear_init(
            torch.empty(features), in_features, generator)) if use_bias else None)

    def forward(self, x):
        y = linear(x, self.kernel, self.dtype)
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class GlorotLinear(nn.Module):
    """Linear with PyG glorot weight and zero bias."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(glorot_init(
            torch.empty(in_features, features), in_features, features, generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        y = linear(x, self.kernel, self.dtype)
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the last axis with statistics over real rows only.

    Statistics are f32 and the output returns in the input dtype.  Training
    mode normalizes with the biased batch variance and moves the running
    stats with the unbiased one (torch semantics, momentum 0.1); eval mode
    uses the running stats."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5,
                 bias_init_value: float = 1e-4):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.full((channels,), bias_init_value))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, mask=None, train: bool = False):
        in_dtype = x.dtype
        x = x.float()
        c = x.shape[-1]
        if not train:
            mean, var = self.mean, self.var
        else:
            rows = x.reshape(-1, c)
            if mask is None:
                n = torch.full((), float(rows.shape[0]), device=x.device)  # no host copy
                mean = rows.mean(dim=0)
                var = ((rows - mean) ** 2).mean(dim=0)
            else:
                m = mask.reshape(-1).float()
                n = torch.clamp(m.sum(), min=1.0)
                mean = (rows * m[:, None]).sum(dim=0) / n
                var = (((rows - mean) ** 2) * m[:, None]).sum(dim=0) / n
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                mom = self.momentum
                self.mean.copy_((1 - mom) * self.mean + mom * mean)
                self.var.copy_((1 - mom) * self.var + mom * unbiased)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(in_dtype)


class GCNConvLayer(nn.Module):
    """Reference GCNConv: glorot weight, zero bias, optional ``gfn`` mode
    (pure linear, bias not added)."""

    def __init__(self, in_features: int, features: int, gfn: bool = False,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.gfn, self.dtype = gfn, dtype
        self.kernel = nn.Parameter(glorot_init(
            torch.empty(in_features, features), in_features, features, generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, g=None, transform_only: bool = False):
        x = linear(x, self.kernel, self.dtype).to(self.dtype)
        b = self.bias.to(self.dtype)
        if transform_only:
            # linear part and bias of a conv whose aggregate runs elsewhere
            # (the fused dual-branch kernel of the causal models)
            return x, b
        if self.gfn:
            return x
        return gcn_aggregate(x, g) + b


class GINConvLayer(nn.Module):
    """PyG ``GINConv`` with the reference MLP Linear -> BN -> ReLU -> Linear
    -> ReLU and fixed eps 0 (counterpart of cal_tpu/nn/layers.py
    ``GINConvLayer``; parameters ``lin1``, ``bn``, ``lin2``)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.lin1 = TorchLinear(in_features, features, dtype=dtype, generator=generator)
        self.bn = MaskedBatchNorm(features)
        self.lin2 = TorchLinear(features, features, dtype=dtype, generator=generator)

    def forward(self, x, g, node_mask=None, train: bool = False):
        h = gin_aggregate(x.to(self.dtype), g)
        h = torch.relu(self.bn(self.lin1(h), node_mask, train))
        return torch.relu(self.lin2(h))


# cal_tpu's switch from the flash kernel to the edge-formulated one
# (cal_tpu/nn/layers.py GATConvLayer): at N >= 384 when the per-graph edge
# window, ceil(eg_budget / 128) + 2 rows of 128 slots, fits in 3N.  The
# constants encode a crossover measured on a TPU v5e
# (benchmarks/sweep_gat_sparse.py), kept so the port computes the reference's
# function with its dropout law; PERF.md holds the H100 sweep.
EDGE_MIN_N = 384
EDGE_WINDOW_PER_N = 3


def edge_kernel_at(eg_budget: int, n: int) -> bool:
    """cal_tpu's predicate on a batch that carries its edge list: N >= 384
    and the edge window of ``eg_budget`` edges fits in 3N."""
    eg_rows = -(-max(eg_budget, 1) // 128) + 2
    return n >= EDGE_MIN_N and eg_rows * 128 <= EDGE_WINDOW_PER_N * n


def takes_edge_kernel(g, n: int) -> bool:
    """Whether a dense GAT conv on batch ``g`` with node budget ``n`` runs
    the edge-formulated kernel (cal_tpu's predicate)."""
    return g.edge_flat is not None and edge_kernel_at(g.eg_budget, n)


class GATConvLayer(nn.Module):
    """PyG-1.1.0 ``GATConv`` (counterpart of cal_tpu/nn/layers.py
    ``GATConvLayer``, its dense branch and its sparse fused branch).

    Parameters ``kernel`` [in, heads * d] and ``att`` [heads, 2d] (glorot),
    ``bias`` [heads * d] (zeros); ``att[:, :d]`` multiplies the receiver,
    ``att[:, d:]`` the sender.  A ``GraphBatch`` runs the sparse GAT kernels
    (``ops/gat_sparse.py``), whose dropout keep bits hash the edge id under
    the two 32-bit words of the layer's seed.  Below a node budget of 2048
    cal_tpu drops its tile plans and draws ``jax.random`` keep bits instead;
    eval numerics are the same.  A dense batch runs, as cal_tpu's layer,
    the edge-formulated kernel (``ops/edge_gat.py``) when
    ``takes_edge_kernel`` holds (the batch carries its int32 edge list, N >=
    384 and the edge window fits in 3N) and the flash kernel
    (``ops/flash_gat.py``) otherwise.  Both compute the same attention; the
    training dropout draws one keep bit per duplicate-edge slot on the edge
    kernel and one per (receiver, sender) cell on flash, so the two laws
    differ only on multigraphs."""

    def __init__(self, in_features: int, out_per_head: int, heads: int = 4,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator=None):
        super().__init__()
        self.heads, self.out_per_head = heads, out_per_head
        self.dropout, self.dtype = dropout, dtype
        hd = heads * out_per_head
        self.kernel = nn.Parameter(glorot_init(
            torch.empty(in_features, hd), in_features, hd, generator))
        self.att = nn.Parameter(glorot_init(
            torch.empty(heads, 2 * out_per_head), heads, 2 * out_per_head, generator))
        self.bias = nn.Parameter(torch.zeros(hd))

    def forward(self, x, g, seed: int | torch.Tensor | None = None):
        """x [B, N, in] (dense) or [V, in] (sparse); ``seed`` (64 bits: an
        int, or a ``flash_gat.seed_buffer`` on the card, which every GAT
        kernel reads there, so a captured step takes each replay's seed)
        turns attention dropout on (training)."""
        dt, d = self.dtype, self.out_per_head
        xh = linear(x, self.kernel, dt).to(dt)
        att = self.att.to(dt)
        if isinstance(g, GraphBatch):
            v = xh.shape[0]
            rate = self.dropout if seed is not None else 0.0
            words = (0, 0) if seed is None else (
                seed if isinstance(seed, torch.Tensor) else seed_words(seed))
            out = gat_aggregate_sparse_fused(xh.view(v, self.heads, d), att[:, :d], att[:, d:],
                                             words, g, rate).reshape(v, self.heads * d)
        elif takes_edge_kernel(g, xh.shape[1]):
            out = edge_gat_dense_flat(xh, g.edge_flat, att[:, :d], att[:, d:], self.dropout,
                                      seed, g.edge_index)
        else:
            out = flash_gat_dense_flat(xh, g.adj, att[:, :d], att[:, d:], self.dropout, seed)
        return out.to(dt) + self.bias.to(dt)


class ReadoutMLP(nn.Module):
    """BN -> FC -> ReLU -> BN -> FC -> log_softmax, in f32."""

    def __init__(self, in_features: int, hidden: int, num_classes: int,
                 generator=None):
        super().__init__()
        self.bn1 = MaskedBatchNorm(in_features)
        self.fc1 = TorchLinear(in_features, hidden, generator=generator)
        self.bn2 = MaskedBatchNorm(hidden)
        self.fc2 = TorchLinear(hidden, num_classes, generator=generator)

    def forward(self, x, mask=None, train: bool = False):
        x = self.bn1(x, mask, train)
        x = torch.relu(self.fc1(x))
        x = self.bn2(x, mask, train)
        return torch.log_softmax(self.fc2(x), dim=-1)
