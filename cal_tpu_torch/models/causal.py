"""Causal attention models: CausalGCN, CausalGIN and CausalGAT.

Counterpart of cal_tpu/models/causal.py (``intervention_permutation`` and
``CausalGNN`` with backbones 'gcn', 'gin' and 'gat').  Input BN -> linear "gfn"
projection -> K backbone layers -> factored edge attention and node
attention -> BN -> both masked context/object GCN convs in ONE fused pass
-> sum pooling -> three readout MLPs (context, object, intervention).

Layouts: a ``DenseGraphBatch`` runs the dense kernels (the masked convs in
``fused_gcn_dense_att_dual``); a ``GraphBatch`` (sparse layout) runs the
CSR kernels (the masked convs of both backbones in
``gcn_aggregate_sparse_pair``, pooling by ``node_graph``).

* backbone 'gcn': BN -> GCNConv -> ReLU per layer; honors ``with_random``
  and the attention-ablation flags;
* backbone 'gin': GINConv (its own Linear -> BN -> ReLU -> Linear -> ReLU
  MLP, no BN/ReLU wrapper) per layer; the aggregate is the dense product or
  the coefficient SpMM (``ops/gin.py``); the masked convs stay GCN convs.
  Like 'gat' it ignores the ablation flags and ``with_random``;
* backbone 'gat': BN -> GATConv (4 heads, attention dropout 0.2 in
  training; the flash-GAT kernel on the dense layout, the sparse GAT
  kernels on the sparse one) -> ReLU per layer; the masked convs are still
  GCN convs.  It ignores the ablation flags and ``with_random``: the
  intervention shuffle follows ``eval_random`` alone, as in the reference.

Precision follows the JAX model: the conv stack runs in ``dtype`` (bf16 in
production), BatchNorm statistics, pooling and the readouts in f32.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from cal_tpu_torch.graph import DenseGraphBatch, GraphBatch
from cal_tpu_torch.nn.layers import (
    GATConvLayer,
    GCNConvLayer,
    GINConvLayer,
    MaskedBatchNorm,
    ReadoutMLP,
)
from cal_tpu_torch.ops.attention import edge_attention, global_add_pool, node_attention
from cal_tpu_torch.ops.fused_gcn import fused_gcn_dense_att_dual
from cal_tpu_torch.ops.spmm import gcn_aggregate_sparse_pair


def build_backbone(model: nn.Module, num_features: int, hidden: int, num_layers: int,
                   backbone: str, heads: int, gat_dropout: float, dtype: torch.dtype,
                   gen: torch.Generator) -> None:
    """Adds the stem and backbone layers that the causal models and the
    baselines share, under the flax names: ``bn_feat``, ``conv_feat`` (gfn),
    then per layer ``convs_{i}`` (GIN) or ``bns_conv_{i}`` + ``convs_{i}``
    (GCN, GAT: 4 heads, attention dropout ``gat_dropout`` in training)."""
    if backbone not in ("gcn", "gin", "gat"):
        raise ValueError(backbone)
    if backbone == "gat" and hidden % heads:
        raise ValueError(f"hidden {hidden} is not a multiple of heads {heads}")
    model.bn_feat = MaskedBatchNorm(num_features)
    model.conv_feat = GCNConvLayer(num_features, hidden, gfn=True, dtype=dtype, generator=gen)
    for i in range(num_layers):
        if backbone == "gin":
            model.add_module(f"convs_{i}", GINConvLayer(hidden, hidden, dtype=dtype,
                                                        generator=gen))
            continue
        model.add_module(f"bns_conv_{i}", MaskedBatchNorm(hidden))
        conv = (GCNConvLayer(hidden, hidden, dtype=dtype, generator=gen)
                if backbone == "gcn" else
                GATConvLayer(hidden, hidden // heads, heads, gat_dropout, dtype=dtype,
                             generator=gen))
        model.add_module(f"convs_{i}", conv)


def run_backbone(model: nn.Module, g, backbone: str, num_layers: int, train: bool,
                 dropout_seeds: Sequence[int] | torch.Tensor | None) -> torch.Tensor:
    """The layers of ``build_backbone`` on ``g``: BN -> gfn -> ReLU, then per
    layer GINConv, or BN -> GCNConv / GATConv -> ReLU (``dropout_seeds``, one
    per layer, turn on GAT's attention dropout in training: ints, or an
    int64 [layers] seed table on the card whose rows the flash kernel
    reads).  Node features in ``model.dtype``."""
    node_mask = g.node_mask
    x = model.bn_feat(g.x.to(model.dtype), node_mask, train)
    x = torch.relu(model.conv_feat(x))
    for i in range(num_layers):
        conv = getattr(model, f"convs_{i}")
        if backbone == "gin":
            x = conv(x, g, node_mask, train)
            continue
        x = getattr(model, f"bns_conv_{i}")(x, node_mask, train)
        if backbone == "gat":
            seed = dropout_seeds[i] if train and dropout_seeds is not None else None
            x = torch.relu(conv(x, g, seed))
        else:
            x = torch.relu(conv(x, g))
    return x


def intervention_permutation(generator: torch.Generator,
                             graph_mask: torch.Tensor) -> torch.Tensor:
    """Uniform random permutation of the real graphs; padded slots map to
    themselves.  Real slots may sit at any positions."""
    u = torch.rand(graph_mask.shape, generator=generator,
                   device=graph_mask.device)
    u = torch.where(graph_mask, u, torch.full_like(u, float("inf")))
    order = torch.argsort(u)               # random real slots first
    rank = torch.cumsum(graph_mask.long(), 0) - 1
    return torch.where(graph_mask, order[rank.clamp(min=0)],
                       torch.arange(graph_mask.shape[0], device=graph_mask.device))


class CausalGNN(nn.Module):
    """CausalGCN / CausalGAT.  Parameter names follow the flax module
    (``bn_feat``, ``conv_feat``, ``bns_conv_{i}``, ``convs_{i}``,
    ``edge_att_kernel`` [2H, 2], ``edge_att_bias``, ``node_att_kernel``
    [H, 2], ``node_att_bias``, ``bnc``, ``bno``, ``context_convs``,
    ``objects_convs``, ``{context,objects,random}_readout``)."""

    def __init__(self, num_features: int, hidden: int, num_classes: int,
                 num_layers: int = 3, backbone: str = "gcn",
                 cat_or_add: str = "add", with_random: bool = True,
                 without_node_attention: bool = False,
                 without_edge_attention: bool = False, heads: int = 4,
                 gat_dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        if cat_or_add not in ("cat", "add"):
            raise ValueError(cat_or_add)
        gen = torch.Generator().manual_seed(seed)
        self.backbone = backbone
        self.hidden, self.num_layers, self.dtype = hidden, num_layers, dtype
        self.cat_or_add, self.with_random = cat_or_add, with_random
        # only CausalGCN has the ablation branches (model.py:99-107)
        ablate = backbone == "gcn"
        self.without_node_attention = ablate and without_node_attention
        self.without_edge_attention = ablate and without_edge_attention

        build_backbone(self, num_features, hidden, num_layers, backbone, heads, gat_dropout,
                       dtype, gen)
        uniform = lambda shape, fan_in: nn.Parameter(
            torch.empty(shape).uniform_(-fan_in ** -0.5, fan_in ** -0.5,
                                        generator=gen))
        if not self.without_edge_attention:
            self.edge_att_kernel = uniform((2 * hidden, 2), 2 * hidden)
            self.edge_att_bias = uniform((2,), 2 * hidden)
        if not self.without_node_attention:
            self.node_att_kernel = uniform((hidden, 2), hidden)
            self.node_att_bias = uniform((2,), hidden)
        self.bnc = MaskedBatchNorm(hidden)
        self.bno = MaskedBatchNorm(hidden)
        self.context_convs = GCNConvLayer(hidden, hidden, dtype=dtype, generator=gen)
        self.objects_convs = GCNConvLayer(hidden, hidden, dtype=dtype, generator=gen)
        self.context_readout = ReadoutMLP(hidden, hidden, num_classes, gen)
        self.objects_readout = ReadoutMLP(hidden, hidden, num_classes, gen)
        co_in = 2 * hidden if cat_or_add == "cat" else hidden
        self.random_readout = ReadoutMLP(co_in, hidden, num_classes, gen)

    def forward(self, g: DenseGraphBatch | GraphBatch, eval_random: bool = True,
                train: bool = False, generator: torch.Generator | None = None,
                dropout_seeds: Sequence[int] | torch.Tensor | None = None):
        """Returns (c_log_probs, o_log_probs, co_log_probs), each [B, C].
        ``generator`` drives the intervention shuffle when it is on;
        ``dropout_seeds`` (one per layer) turn on the GAT layers' attention
        dropout in training."""
        dt = self.dtype
        sparse = isinstance(g, GraphBatch)
        node_mask = g.node_mask
        x = run_backbone(self, g, self.backbone, self.num_layers, train, dropout_seeds)

        if self.without_edge_attention:
            # sigmoid(0 + 0) = 0.5 exactly: the constant ablation weights
            src = dst = torch.zeros(x.shape[:-1], dtype=dt, device=x.device)
        else:
            w_c, _ = edge_attention(x, self.edge_att_kernel[:self.hidden],
                                    self.edge_att_kernel[self.hidden:],
                                    self.edge_att_bias)
            src, dst = w_c.src, w_c.dst

        if self.without_node_attention:
            att_c = att_o = torch.full(x.shape[:-1], 0.5, dtype=dt, device=x.device)
        else:
            att_c, att_o = node_attention(x, self.node_att_kernel, self.node_att_bias)
        xc = att_c[..., None] * x
        xo = att_o[..., None] * x

        xc = self.bnc(xc, node_mask, train)
        xo = self.bno(xo, node_mask, train)
        xc_t, bc = self.context_convs(xc, transform_only=True)
        xo_t, bo = self.objects_convs(xo, transform_only=True)
        if sparse:
            oc, oo = gcn_aggregate_sparse_pair(xc_t, xo_t, src, dst, g)
        else:
            oc, oo = fused_gcn_dense_att_dual(xc_t, xo_t, g.adj.to(dt), src, dst)
        xc = torch.relu(oc + bc)
        xo = torch.relu(oo + bo)

        xc = global_add_pool(xc, g)
        xo = global_add_pool(xo, g)
        gm = g.graph_mask
        xc_logis = self.context_readout(xc, gm, train)
        xo_logis = self.objects_readout(xo, gm, train)

        if eval_random and (self.with_random or self.backbone != "gcn"):
            xc_mix = xc[intervention_permutation(generator, gm)]
        else:
            xc_mix = xc
        xco = (torch.cat([xc_mix, xo], dim=-1) if self.cat_or_add == "cat"
               else xc_mix + xo)
        xco_logis = self.random_readout(xco, gm, train)
        return xc_logis, xo_logis, xco_logis
