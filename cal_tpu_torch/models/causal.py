"""Causal attention model, GCN backbone, dense layout (CausalGCN).

Counterpart of cal_tpu/models/causal.py (``intervention_permutation`` and
``CausalGNN`` with backbone 'gcn').  Input BN -> linear "gfn" projection ->
K x (BN -> GCNConv -> ReLU) -> factored edge attention and node attention
-> BN -> both masked context/object GCN convs in ONE fused kernel ->
sum pooling -> three readout MLPs (context, object, intervention).

Precision follows the JAX model: the conv stack runs in ``dtype`` (bf16 in
production), BatchNorm statistics, pooling and the readouts in f32.
"""
from __future__ import annotations

import torch
from torch import nn

from cal_tpu_torch.graph import DenseGraphBatch
from cal_tpu_torch.nn.layers import GCNConvLayer, MaskedBatchNorm, ReadoutMLP
from cal_tpu_torch.ops.attention import edge_attention, global_add_pool, node_attention
from cal_tpu_torch.ops.fused_gcn import fused_gcn_dense_att_dual


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
    """CausalGCN.  Parameter names follow the flax module (``bn_feat``,
    ``conv_feat``, ``bns_conv_{i}``, ``convs_{i}``, ``edge_att_kernel``
    [2H, 2], ``edge_att_bias``, ``node_att_kernel`` [H, 2],
    ``node_att_bias``, ``bnc``, ``bno``, ``context_convs``,
    ``objects_convs``, ``{context,objects,random}_readout``)."""

    def __init__(self, num_features: int, hidden: int, num_classes: int,
                 num_layers: int = 3, backbone: str = "gcn",
                 cat_or_add: str = "add", with_random: bool = True,
                 without_node_attention: bool = False,
                 without_edge_attention: bool = False,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        if backbone != "gcn":
            raise NotImplementedError(
                f"backbone {backbone!r} not ported yet (ROADMAP queue 1 items 6-7)")
        if cat_or_add not in ("cat", "add"):
            raise ValueError(cat_or_add)
        gen = torch.Generator().manual_seed(seed)
        self.hidden, self.num_layers, self.dtype = hidden, num_layers, dtype
        self.cat_or_add, self.with_random = cat_or_add, with_random
        self.without_node_attention = without_node_attention
        self.without_edge_attention = without_edge_attention

        self.bn_feat = MaskedBatchNorm(num_features)
        self.conv_feat = GCNConvLayer(num_features, hidden, gfn=True, dtype=dtype,
                                      generator=gen)
        for i in range(num_layers):
            self.add_module(f"bns_conv_{i}", MaskedBatchNorm(hidden))
            self.add_module(f"convs_{i}", GCNConvLayer(hidden, hidden, dtype=dtype,
                                                       generator=gen))
        uniform = lambda shape, fan_in: nn.Parameter(
            torch.empty(shape).uniform_(-fan_in ** -0.5, fan_in ** -0.5,
                                        generator=gen))
        if not without_edge_attention:
            self.edge_att_kernel = uniform((2 * hidden, 2), 2 * hidden)
            self.edge_att_bias = uniform((2,), 2 * hidden)
        if not without_node_attention:
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

    def forward(self, g: DenseGraphBatch, eval_random: bool = True,
                train: bool = False, generator: torch.Generator | None = None):
        """Returns (c_log_probs, o_log_probs, co_log_probs), each [B, C].
        ``generator`` drives the intervention shuffle when it is on."""
        dt = self.dtype
        x = g.x.to(dt)
        adj = g.adj.to(dt)
        node_mask = g.node_mask

        x = self.bn_feat(x, node_mask, train)
        x = torch.relu(self.conv_feat(x))
        for i in range(self.num_layers):
            x = getattr(self, f"bns_conv_{i}")(x, node_mask, train)
            x = torch.relu(getattr(self, f"convs_{i}")(x, g))

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
        oc, oo = fused_gcn_dense_att_dual(xc_t, xo_t, adj, src, dst)
        xc = torch.relu(oc + bc)
        xo = torch.relu(oo + bo)

        xc = global_add_pool(xc, node_mask)
        xo = global_add_pool(xo, node_mask)
        gm = g.graph_mask
        xc_logis = self.context_readout(xc, gm, train)
        xo_logis = self.objects_readout(xo, gm, train)

        if self.with_random and eval_random:
            xc_mix = xc[intervention_permutation(generator, gm)]
        else:
            xc_mix = xc
        xco = (torch.cat([xc_mix, xo], dim=-1) if self.cat_or_add == "cat"
               else xc_mix + xo)
        xco_logis = self.random_readout(xco, gm, train)
        return xc_logis, xo_logis, xco_logis
