"""Layers: mask-aware BatchNorm, reference-init linear layers, GCN conv, readout.

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

from cal_tpu_torch.ops.gcn import gcn_aggregate


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
                n = torch.tensor(float(rows.shape[0]), device=x.device)
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
