"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``; every test skips on a machine without CUDA.  This file
imports neither JAX nor cal_tpu, so a GPU machine without JAX runs it
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q
"""
import numpy as np
import pytest
import torch

from cal_tpu_torch.ops.adj_build import adj_build, adj_build_plain
from cal_tpu_torch.ops.fused_gcn import (
    fused_gcn_dense_att_dual,
    fused_gcn_dense_att_dual_plain,
)

pytestmark = pytest.mark.cuda
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# see chip_smoke.py DUAL_TOL for the reasons: (atol, rtol)
DUAL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 1.6e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _edge_flat(rng, b, n, per_graph, idx):
    ef = []
    for g in range(b - 1):                     # the last slot stays empty
        r = rng.integers(0, n, per_graph)
        s = rng.integers(0, n, per_graph)
        ef.append((g * n + r) * n + s)
    ef.append(np.full(per_graph // 3, (0 * n + 1) * n + 2))  # one heavy duplicate
    ef = np.sort(np.concatenate(ef))
    return np.concatenate([ef, np.full(13, b * n * n)]).astype(idx)


@pytest.mark.parametrize("b,n,per_graph,idx,dtype", [
    (3, 7, 20, np.int32, "float32"),
    (5, 40, 300, np.int64, "bfloat16"),
    (2, 300, 2000, np.int32, "bfloat16"),
    (128, 256, 1000, np.int32, "bfloat16"),
    (4, 256, 900, np.int64, "float32"),
])
def test_adj_build_kernel_exact(cuda, b, n, per_graph, idx, dtype):
    rng = np.random.default_rng(n)
    ef = torch.from_numpy(_edge_flat(rng, b, n, per_graph, idx)).to(cuda)
    before = adj_build.launches
    got = adj_build(ef, b, n, DT[dtype])
    torch.cuda.synchronize()
    assert adj_build.launches == before + 1
    assert torch.equal(got, adj_build_plain(ef, b, n, DT[dtype]))


def test_adj_build_kernel_only_padding(cuda):
    ef = torch.full((40,), 2 * 9 * 9, dtype=torch.int32, device=cuda)
    got = adj_build(ef, 2, 9, torch.float32)
    torch.cuda.synchronize()
    assert got.shape == (2, 9, 9) and not got.any()


@pytest.mark.parametrize("b,n,h,dtype", [
    (2, 5, 3, "float32"),
    (3, 70, 130, "bfloat16"),
    (1, 33, 64, "bfloat16"),
    (2, 256, 128, "float32"),
    (4, 256, 128, "bfloat16"),
    (2, 100, 256, "bfloat16"),
])
def test_dual_kernel_matches_plain(cuda, b, n, h, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n * h)
    adj = torch.randint(0, 3, (b, n, n), generator=gen, device=cuda).float()
    adj = (adj * (torch.rand((b, n, n), generator=gen, device=cuda) < 0.1)).to(DT[dtype])
    xc, xo = (torch.randn((b, n, h), generator=gen, device=cuda).to(DT[dtype])
              for _ in range(2))
    src = torch.randn((b, n), generator=gen, device=cuda).to(DT[dtype])
    dst = (2 * torch.randn((b, n), generator=gen, device=cuda)).to(DT[dtype])
    before = fused_gcn_dense_att_dual.launches
    got = fused_gcn_dense_att_dual(xc, xo, adj, src, dst)
    ref = fused_gcn_dense_att_dual_plain(xc, xo, adj, src, dst)
    torch.cuda.synchronize()
    assert fused_gcn_dense_att_dual.launches == before + 1
    atol, rtol = DUAL_TOL[dtype]
    for a, r in zip(got, ref):
        assert a.dtype == DT[dtype] and a.shape == (b, n, h)
        torch.testing.assert_close(a.float(), r.float(), atol=atol, rtol=rtol)


def test_wrappers_raise_on_mixed_devices(cuda):
    x = torch.zeros((1, 4, 2), device=cuda)
    with pytest.raises(ValueError):
        fused_gcn_dense_att_dual(x, x, torch.zeros((1, 4, 4)), x[..., 0], x[..., 0])
