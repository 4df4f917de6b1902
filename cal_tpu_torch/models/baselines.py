"""Baseline models GCNNet / GINNet / GATNet.

Counterpart of cal_tpu/models/baselines.py ``BaselineGNN``: input BN ->
linear "gfn" projection -> K conv layers -> sum pooling -> (num_fc_layers
- 1) x (BN -> FC -> ReLU) -> BN -> [dropout, GAT only, in training] ->
classifier -> log_softmax.

* backbone 'gcn': BN -> GCNConv -> ReLU per layer;
* backbone 'gin': GINConv (its own MLP) per layer;
* backbone 'gat': BN -> GATConv (4 heads, attention dropout ``dropout`` in
  training) -> ReLU per layer.

Both layouts, as the causal models: a ``DenseGraphBatch`` or a
``GraphBatch``.  The conv stack runs in ``dtype``; BatchNorm statistics,
pooling and the FC head in f32.  Parameter names follow the flax module.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from cal_tpu_torch.models.causal import build_backbone, run_backbone
from cal_tpu_torch.nn.layers import MaskedBatchNorm, TorchLinear
from cal_tpu_torch.ops.attention import global_add_pool


class BaselineGNN(nn.Module):
    """GCN / GIN / GAT baseline.  Parameters: ``bn_feat``, ``conv_feat``,
    ``bns_conv_{i}`` (GCN, GAT), ``convs_{i}``, ``bns_fc_{i}``, ``lins_{i}``,
    ``bn_hidden``, ``lin_class``."""

    def __init__(self, num_features: int, hidden: int, num_classes: int,
                 num_layers: int = 3, backbone: str = "gcn", num_fc_layers: int = 2,
                 heads: int = 4, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.backbone, self.num_layers, self.num_fc_layers = backbone, num_layers, num_fc_layers
        self.dropout, self.dtype = dropout, dtype
        build_backbone(self, num_features, hidden, num_layers, backbone, heads, dropout, dtype,
                       gen)
        for i in range(num_fc_layers - 1):
            self.add_module(f"bns_fc_{i}", MaskedBatchNorm(hidden))
            self.add_module(f"lins_{i}", TorchLinear(hidden, hidden, generator=gen))
        self.bn_hidden = MaskedBatchNorm(hidden)
        self.lin_class = TorchLinear(hidden, num_classes, generator=gen)

    def forward(self, g, train: bool = False,
                dropout_seeds: Sequence[int] | torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """[B, C] log-probs.  In training with dropout > 0 (GAT),
        ``dropout_seeds`` (one per layer) drive the layers' attention
        dropout and ``generator`` the dropout before the classifier."""
        x = global_add_pool(run_backbone(self, g, self.backbone, self.num_layers, train,
                                         dropout_seeds), g)
        gm = g.graph_mask
        for i in range(self.num_fc_layers - 1):
            x = getattr(self, f"bns_fc_{i}")(x, gm, train)
            x = torch.relu(getattr(self, f"lins_{i}")(x))
        x = self.bn_hidden(x, gm, train)
        if self.backbone == "gat" and self.dropout > 0 and train:
            keep_prob = 1.0 - self.dropout
            keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
            x = torch.where(keep, x / keep_prob, torch.zeros((), device=x.device))
        return torch.log_softmax(self.lin_class(x), dim=-1)
