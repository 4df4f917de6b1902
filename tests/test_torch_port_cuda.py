"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``; every test skips on a machine without CUDA.  This file
imports neither JAX nor cal_tpu, so a GPU machine without JAX runs it
without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch
from edge_lists import hub_edges

from cal_tpu_torch.ops.adj_build import adj_build, adj_build_plain
from cal_tpu_torch.ops.flash_gat import (
    _FlashGAT,
    dropout_keep,
    flash_gat_bwd,
    flash_gat_bwd_plain,
    flash_gat_fwd,
    flash_gat_fwd_plain,
)
from cal_tpu_torch.ops.fused_gcn import (
    fused_gcn_dense_att_dual,
    fused_gcn_dense_att_dual_bwd,
    fused_gcn_dense_att_dual_bwd_plain,
    fused_gcn_dense_att_dual_plain,
)

pytestmark = pytest.mark.cuda
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# see chip_smoke.py DUAL_TOL and DUAL_BWD_TOL for the reasons: (atol, rtol)
DUAL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 1.6e-2)}
DUAL_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 1.6e-2)}
# see chip_smoke.py FLASH_TOL: f32 results (out, m, den, dti, dtj) 1e-4;
# dxh in the input dtype, so one bf16 rounding (2^-7 relative) in bf16
FLASH_TOL = (1e-4, 1e-4)
FLASH_DXH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 8e-3)}


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


# edge lists at the kernel's chunk edges: (b, n, what) -> sorted flat edges
def _adj_case(rng, b, n, case):
    total = b * n * n
    if case == "empty_chunks":      # edges in graph 0's first rows and the last graph only
        ef = np.concatenate([rng.integers(0, 3 * n, 200), rng.integers((b - 1) * n * n, total,
                                                                       300)])
    elif case == "last_chunk_only":
        ef = rng.integers(total - 100, total, 150)
    elif case == "long_run":        # a duplicate run of 300 (> 256 threads) beside others
        ef = np.concatenate([np.full(300, n + 1), rng.integers(0, total, 400)])
    elif case == "first_cell":      # cell 0 and the last cell, besides a few
        ef = np.concatenate([[0, 0, total - 1], rng.integers(0, total, 50)])
    else:                           # random edges over every graph
        ef = rng.integers(0, total, 40 * b * n // 8 + 10)
    return np.sort(ef)


@pytest.mark.parametrize("b,n,case", [
    (4, 256, "empty_chunks"),
    (4, 256, "last_chunk_only"),
    (3, 64, "long_run"),
    (5, 13, "random"),
    (3, 37, "first_cell"),
    (2, 250, "random"),
    (2, 3840, "empty_chunks"),
    (2, 3840, "random"),
])
@pytest.mark.parametrize("idx", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adj_build_kernel_chunk_edges(cuda, b, n, case, idx, dtype):
    """Row 1 equals its twin bit for bit, in one launch, on chunks without an
    edge, edges only in the last chunk, a duplicate run longer than a
    block's threads (its count rounds in bf16 as the twin's), N no multiple
    of 8 and N = 3,840 at small B; negative values and the padding sentinel
    are dropped."""
    rng = np.random.default_rng(n + b)
    ef = _adj_case(rng, b, n, case)
    ef = np.concatenate([[-5, -1], ef, np.full(9, b * n * n)]).astype(idx)
    ef = torch.from_numpy(ef).to(cuda)
    before = adj_build.launches
    got = adj_build(ef, b, n, DT[dtype])
    torch.cuda.synchronize()
    assert adj_build.launches == before + 1
    assert torch.equal(got, adj_build_plain(ef, b, n, DT[dtype]))


@pytest.mark.parametrize("idx,dtype", [(np.int32, "bfloat16"), (np.int64, "float32")])
def test_adj_build_is_one_device_kernel(cuda, idx, dtype):
    """A call of row 1 runs one device kernel, adj_build_kernel: no pass
    over the edges before it."""
    ef = torch.from_numpy(_adj_case(np.random.default_rng(1), 4, 256, "random")
                          .astype(idx)).to(cuda)
    names = _device_kernels(lambda: adj_build(ef, 4, 256, DT[dtype]))
    assert len(names) == 1 and "adj_build_kernel" in names[0], names


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


def _dual_bwd_inputs(device, b, n, h, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    adj = torch.randint(0, 3, (b, n, n), generator=gen, device=device).float()
    adj = adj * (torch.rand((b, n, n), generator=gen, device=device) < 0.1)
    if n > 1:
        adj[0, 1, 1] = 3.0                               # self loop, dropped
    xc, xo, gc, go = (torch.randn((b, n, h), generator=gen, device=device)
                      for _ in range(4))
    if b > 1:
        adj[-1] = 0.0                                    # padded graph slot
        xc[-1] = 0.0
    src = torch.randn((b, n), generator=gen, device=device)
    dst = 2 * torch.randn((b, n), generator=gen, device=device)
    return tuple(t.to(DT[dtype]) for t in (xc, xo, adj, src, dst, gc, go))


# Shapes across the backward's tiles: 64-node blocks walking 64-node (f32:
# 32) steps and 128-column chunks (node pass), 128 x 128 tiles walking 32-
# (f32: 16-) column steps (edge pass), 16-deep products, the live map's 64 x
# 32 cells; N = 1 has no edge, N = 3,840 is SYNREDDIT's.
BWD_TILE_SHAPES = [(1 if n == 3840 else 3, n, h, dtype)
                   for n in (1, 63, 65, 129, 3840) for h in (8, 40, 200, 256)
                   for dtype in ("bfloat16", "float32")]


@pytest.mark.parametrize("b,n,h,dtype", [
    (2, 24, 8, "float32"),
    (3, 24, 40, "bfloat16"),
    (4, 256, 128, "float32"),
    (4, 256, 128, "bfloat16"),
    (2, 384, 128, "float32"),
    (2, 384, 200, "bfloat16"),
] + BWD_TILE_SHAPES)
def test_dual_backward_kernel_matches_plain(cuda, b, n, h, dtype):
    args = _dual_bwd_inputs(cuda, b, n, h, dtype, seed=n + h)
    before = fused_gcn_dense_att_dual_bwd.launches
    got = fused_gcn_dense_att_dual_bwd(*args)
    ref = fused_gcn_dense_att_dual_bwd_plain(*args)
    torch.cuda.synchronize()
    assert fused_gcn_dense_att_dual_bwd.launches == before + 1
    atol, rtol = DUAL_BWD_TOL[dtype]
    for a, r, like in zip(got, ref, (args[0], args[1], args[3], args[4])):
        assert a.dtype == DT[dtype] and a.shape == like.shape
        assert torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), r.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("b,n,h,dtype", BWD_TILE_SHAPES)
def test_single_conv_backward_kernel_matches_plain(cuda, b, n, h, dtype):
    """K18B (the dual backward's one-branch modes, sig and neg) on the same
    shapes, against fused_gcn_dense_att_bwd_plain."""
    from cal_tpu_torch.ops import fused_gcn as fg

    x, _, adj, src, dst, g, _ = _dual_bwd_inputs(cuda, b, n, h, dtype, seed=n + h + 5)
    atol, rtol = DUAL_BWD_TOL[dtype]
    for negate in (False, True):
        before = fg.fused_gcn_dense_att_bwd.launches
        got = fg.fused_gcn_dense_att_bwd(x, adj, src, dst, g, negate)
        ref = fg.fused_gcn_dense_att_bwd_plain(x, adj, src, dst, g, negate)
        torch.cuda.synchronize()
        assert fg.fused_gcn_dense_att_bwd.launches == before + 1
        for a, r, like in zip(got, ref, (x, src, dst)):
            assert a.dtype == DT[dtype] and a.shape == like.shape
            assert torch.isfinite(a.float()).all()
            torch.testing.assert_close(a.float(), r.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dual_backward_kernel_skips_empty_tiles(cuda, dtype):
    """The kernels skip adjacency tiles without an edge (the live map): a
    graph on a prefix of the slots, one whose edges lie only in far tiles,
    one with self loops only, and an empty slot, against the plain twins."""
    from cal_tpu_torch.ops import fused_gcn as fg

    xc, xo, _, src, dst, gc, go = _dual_bwd_inputs(cuda, 4, 300, 72, dtype, 31)
    gen = torch.Generator(device=cuda).manual_seed(37)
    adj = torch.zeros((4, 300, 300), device=cuda)
    adj[0, :41, :41] = torch.randint(0, 3, (41, 41), generator=gen, device=cuda).float()
    adj[1, 250:, 5:11] = 1.0                               # only far tiles
    adj[1, 7, 290] = 2.0
    adj[2].fill_diagonal_(1.0)                             # self loops only
    adj = adj.to(DT[dtype])
    atol, rtol = DUAL_BWD_TOL[dtype]
    pairs = list(zip(fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc, go),
                     fused_gcn_dense_att_dual_bwd_plain(xc, xo, adj, src, dst, gc, go)))
    for negate in (False, True):
        pairs += list(zip(fg.fused_gcn_dense_att_bwd(xc, adj, src, dst, gc, negate),
                          fg.fused_gcn_dense_att_bwd_plain(xc, adj, src, dst, gc, negate)))
    torch.cuda.synchronize()
    for a, r in pairs:
        assert torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), r.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dual_backward_kernels_are_deterministic(cuda, dtype):
    """No atomics: two calls on one input give the same bits (dual and both
    one-branch modes, several tiles in each direction and column chunks)."""
    from cal_tpu_torch.ops import fused_gcn as fg

    xc, xo, adj, src, dst, gc, go = _dual_bwd_inputs(cuda, 2, 300, 200, dtype, 23)
    calls = [lambda: fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc, go)]
    calls += [lambda neg=neg: fg.fused_gcn_dense_att_bwd(xc, adj, src, dst, gc, neg)
              for neg in (False, True)]
    for call in calls:
        first, second = call(), call()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_dual_backward_kernel_matches_autograd(cuda):
    """f32 kernel VJP against torch.autograd of the forward plain twin."""
    xc, xo, adj, src, dst, gc, go = _dual_bwd_inputs(cuda, 3, 256, 128, "float32", 7)
    leaves = [t.clone().requires_grad_() for t in (xc, xo, src, dst)]
    oc, oo = fused_gcn_dense_att_dual_plain(leaves[0], leaves[1], adj, leaves[2], leaves[3])
    ref = torch.autograd.grad((oc * gc).sum() + (oo * go).sum(), leaves)
    got = fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc, go)
    atol, rtol = DUAL_BWD_TOL["float32"]
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=atol, rtol=rtol)


def test_dual_autograd_on_card_launches_both_kernels(cuda):
    xc, xo, adj, src, dst, gc, go = _dual_bwd_inputs(cuda, 2, 64, 32, "bfloat16", 3)
    leaves = [t.clone().requires_grad_() for t in (xc, xo, src, dst)]
    before = (fused_gcn_dense_att_dual.launches, fused_gcn_dense_att_dual_bwd.launches)
    oc, oo = fused_gcn_dense_att_dual(leaves[0], leaves[1], adj, leaves[2], leaves[3])
    ((oc.float() * gc.float()).sum() + (oo.float() * go.float()).sum()).backward()
    torch.cuda.synchronize()
    assert (fused_gcn_dense_att_dual.launches,
            fused_gcn_dense_att_dual_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad.float()).all() for t in leaves)


def test_dual_autograd_hands_the_forward_degrees_to_the_backward(cuda):
    """The Function's backward takes the forward kernel's degree statistics
    and skips its own degree pass: the same bits as the backward alone."""
    for dtype in ("bfloat16", "float32"):
        xc, xo, adj, src, dst, gc, go = _dual_bwd_inputs(cuda, 3, 200, 72, dtype, 29)
        leaves = [t.clone().requires_grad_() for t in (xc, xo, src, dst)]
        oc, oo = fused_gcn_dense_att_dual(leaves[0], leaves[1], adj, leaves[2], leaves[3])
        torch.autograd.backward((oc, oo), (gc, go))
        ref = fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc, go)
        for leaf, r in zip(leaves, ref):
            assert torch.equal(leaf.grad, r)
    with pytest.raises(ValueError, match="stats"):
        fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc, go,
                                     torch.zeros((2, 3, 200), device=cuda))


def test_wrappers_raise_on_mixed_devices(cuda):
    x = torch.zeros((1, 4, 2), device=cuda)
    with pytest.raises(ValueError):
        fused_gcn_dense_att_dual(x, x, torch.zeros((1, 4, 4)), x[..., 0], x[..., 0])
    with pytest.raises(ValueError):
        fused_gcn_dense_att_dual_bwd(x, x, torch.zeros((1, 4, 4)), x[..., 0], x[..., 0],
                                     x, x)


def _flash_inputs(device, b, n, heads, d, dtype, seed, density="random"):
    """Score halves with a wide spread, the output cotangent, xh and counts
    of one of the densities the kernels treat apart: "random" multigraph
    counts (a self-loop count that the kernel overrides, an isolated node,
    a padded graph slot); "self_loops" (no edge: every row's only live cell
    is its diagonal; the last graph all padding, xh 0); "full" (every cell
    counts 1-3); "hubs" (sparse, with receiver 0 hearing every node and
    sender n - 1 heard by every node)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ti = 2 * torch.randn((b, n, heads), generator=gen, device=device)
    tj = 2 * torch.randn((b, n, heads), generator=gen, device=device)
    counts = torch.randint(0, 3, (b, n, n), generator=gen, device=device).float()
    xh = torch.randn((b, n, heads * d), generator=gen, device=device)
    g = torch.randn((b, n, heads * d), generator=gen, device=device)
    if density == "full":
        counts = counts + 1.0
    else:
        counts = counts * (torch.rand((b, n, n), generator=gen, device=device) < 0.1)
    if density == "random":
        counts[0, 1, 1] = 3.0
        counts[0, 2, :] = 0.0
        counts[0, :, 2] = 0.0
        counts[-1] = 0.0
    elif density == "self_loops":
        counts.zero_()
        xh[-1] = 0.0
        ti[-1] = tj[-1] = 0.0
    elif density == "hubs":
        counts[:, 0, :] = 1.0
        counts[:, :, n - 1] = 1.0
    return ti, tj, counts.to(DT[dtype]), xh.to(DT[dtype]), g


_DENSITY_CASES = [
    (b, n, heads, d, dtype, rate, density)
    for b, n, heads, d, dtype, density in (
        (3, 256, 4, 32, "bfloat16", "self_loops"),
        (3, 256, 4, 32, "float32", "full"),
        (3, 256, 4, 32, "bfloat16", "hubs"),
        (2, 33, 4, 32, "float32", "hubs"),
        (2, 384, 4, 32, "bfloat16", "full"),
        (2, 384, 4, 32, "float32", "full"),
    )
    for rate in (0.0, 0.2)]


@pytest.mark.parametrize("b,n,heads,d,dtype,rate,density", [
    (4, 256, 4, 32, "bfloat16", 0.0, "random"),
    (4, 256, 4, 32, "bfloat16", 0.2, "random"),
    (2, 256, 4, 32, "float32", 0.2, "random"),
    (3, 70, 4, 32, "float32", 0.0, "random"),
    (3, 70, 4, 32, "bfloat16", 0.2, "random"),
    (2, 45, 3, 40, "float32", 0.2, "random"),
    (2, 33, 2, 8, "bfloat16", 0.0, "random"),
    (2, 40, 3, 6, "bfloat16", 0.2, "random"),
    (2, 64, 9, 128, "float32", 0.2, "random"),
] + _DENSITY_CASES)
def test_flash_gat_kernels_match_plain(cuda, b, n, heads, d, dtype, rate, density):
    ti, tj, counts, xh, g = _flash_inputs(cuda, b, n, heads, d, dtype, seed=n + d,
                                          density=density)
    seed = 0x1234_5678_9ABC
    before = (flash_gat_fwd.launches, flash_gat_bwd.launches)
    got = flash_gat_fwd(ti, tj, counts, xh, seed, rate)
    ref = flash_gat_fwd_plain(ti, tj, counts, xh, seed, rate)
    torch.cuda.synchronize()
    atol, rtol = FLASH_TOL
    for a, r in zip(got, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, r, atol=atol, rtol=rtol)
    m, den = ref[1], ref[2]
    bgot = flash_gat_bwd(ti, tj, counts, xh, m, den, g, seed, rate)
    bref = flash_gat_bwd_plain(ti, tj, counts, xh, m, den, g, seed, rate)
    torch.cuda.synchronize()
    assert (flash_gat_fwd.launches, flash_gat_bwd.launches) == (before[0] + 1, before[1] + 1)
    for a, r in zip(bgot[:2], bref[:2]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, r, atol=atol, rtol=rtol)
    assert bgot[2].dtype == DT[dtype] and torch.isfinite(bgot[2].float()).all()
    atol, rtol = FLASH_DXH_TOL[dtype]
    torch.testing.assert_close(bgot[2].float(), bref[2].float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_gat_diagonal_only_rows_copy_xh(cuda, dtype, rate):
    """A row whose only live cell is its diagonal (a padded node) gives, bit
    for bit, m = leaky(ti + tj), den = 1 and out = keep * scale * xh_r."""
    b, n, heads, d = 2, 96, 4, 32
    ti, tj, counts, xh, _ = _flash_inputs(cuda, b, n, heads, d, dtype, seed=11)
    counts[:, 40:] = 0.0                       # rows 40.. have no edge
    counts[:, :, 40:] = 0.0
    seed = 0xBEEF_0000_1234
    out, m, den = flash_gat_fwd(ti, tj, counts, xh, seed, rate)
    torch.cuda.synchronize()
    pre = ti[:, 40:] + tj[:, 40:]
    assert torch.equal(m[:, 40:], torch.maximum(pre, 0.2 * pre))
    assert torch.equal(den[:, 40:], torch.ones_like(den[:, 40:]))
    keep = dropout_keep(seed, b, heads, n, rate, cuda).diagonal(dim1=2, dim2=3)  # [B, heads, N]
    keep = keep.transpose(1, 2)[:, 40:, :, None].expand(-1, -1, -1, d).reshape(b, n - 40, -1)
    scale = 1.0 / (1.0 - rate) if rate > 0 else 1.0
    want = torch.where(keep, scale * xh[:, 40:].float(), torch.zeros((), device=cuda))
    assert torch.equal(out[:, 40:], want)
    assert rate == 0.0 or not keep.all()


def test_flash_gat_backward_matches_autograd(cuda):
    """f32 kernel VJP with dropout on against torch.autograd of the forward
    plain twin drawing the same keep bits: the backward replays the mask."""
    ti, tj, counts, xh, g = _flash_inputs(cuda, 3, 256, 4, 32, "float32", seed=5)
    leaves = [t.clone().requires_grad_() for t in (ti, tj, xh)]
    out, _, _ = flash_gat_fwd_plain(leaves[0], leaves[1], counts, leaves[2], 77, 0.2)
    ref = torch.autograd.grad((out * g).sum(), leaves)
    _, m, den = flash_gat_fwd(ti, tj, counts, xh, 77, 0.2)
    got = flash_gat_bwd(ti, tj, counts, xh, m, den, g, 77, 0.2)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)


def test_flash_gat_dropout_law_on_card(cuda):
    """Keep fraction of the mask within 0.002 of 1 - rate over 8.4 M cells,
    and the kernel's output sum with dropout within 0.02 of the sum without."""
    keep = dropout_keep(99, 32, 4, 256, 0.2, cuda)
    assert abs(float(keep.float().mean()) - 0.8) < 2e-3
    ti, tj, counts, xh, _ = _flash_inputs(cuda, 8, 256, 4, 32, "float32", seed=9)
    xh = xh.abs()
    base = flash_gat_fwd(ti, tj, counts, xh)[0].sum()
    drop = flash_gat_fwd(ti, tj, counts, xh, 99, 0.2)[0].sum()
    assert abs(float(drop / base) - 1.0) < 0.02


def test_flash_gat_autograd_on_card_launches_both_kernels(cuda):
    ti, tj, counts, xh, g = _flash_inputs(cuda, 2, 64, 4, 8, "bfloat16", seed=3)
    leaves = [t.clone().requires_grad_() for t in (ti, tj, xh)]
    before = (flash_gat_fwd.launches, flash_gat_bwd.launches)
    out = _FlashGAT.apply(leaves[0], leaves[1], counts, leaves[2], 5, 0.2)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert (flash_gat_fwd.launches, flash_gat_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad.float()).all() for t in leaves)


def test_flash_wrappers_raise_on_mixed_devices(cuda):
    ti = torch.zeros((1, 4, 2), device=cuda)
    xh = torch.zeros((1, 4, 8), device=cuda)
    with pytest.raises(ValueError):
        flash_gat_fwd(ti, ti, torch.zeros((1, 4, 4)), xh)
    with pytest.raises(ValueError):
        flash_gat_bwd(ti, ti, torch.zeros((1, 4, 4), device=cuda), xh, ti, ti, xh.cpu())


# ---- sparse layout: K1-K4 (csrc/spmm.cu, csrc/pool.cu) --------------------
# See chip_smoke.py DEG_TOL, SPARSE_TOL and POOL_TOL: kernel and twin share
# the rounding points; f32 sums in another order, fmaf and expf (a few ulp);
# bf16 outputs may land one bf16 ulp (2^-7 relative at most) apart when the
# f32 sums straddle a rounding boundary.  (atol, rtol)
DEG_TOL = (1e-4, 1e-5)
SPARSE_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-5, 8e-3)}
POOL_TOL = (1e-3, 1e-4)


def _sparse_graph(device, v, e, hub, pad, seed, isolated=0, masked_rows=()):
    """A receiver-sorted GraphBatch with self loops, a hub (``hub`` in- and
    out-edges at node 3), ``pad`` padded edges at node V-1 and the last
    ``isolated`` nodes without edges; node_graph cuts V into 5 graphs and
    the trash segment.  A tuple ``hub`` gives nodes 3, 4, ... rows of
    exactly those lengths in both CSRs (the e random edges avoid them): the
    walk's degree classes beside the random rows (e / V of ~2 makes most of
    those leaves of 1-4 edges, some empty).  The in-edges of the receivers
    ``masked_rows`` are masked out as well as the padded ones."""
    from cal_tpu_torch.graph import sparse_batch

    rng = np.random.default_rng(seed)
    live_v = v - 1 - isolated
    rows = hub if isinstance(hub, tuple) else ()
    lo = 3 + len(rows) if rows else 0
    s = rng.integers(lo, live_v, e)
    r = rng.integers(lo, live_v, e)
    s[: e // 30] = r[: e // 30]                           # self loops
    if rows:
        for node, n in enumerate(rows, start=3):
            s = np.concatenate([s, np.full(n, node), rng.integers(lo, live_v, n)])
            r = np.concatenate([r, rng.integers(lo, live_v, n), np.full(n, node)])
    else:
        s = np.concatenate([s, np.full(hub, 3), rng.integers(0, live_v, hub)])
        r = np.concatenate([r, rng.integers(0, live_v, hub), np.full(hub, 3)])
    o = np.argsort(r, kind="stable")
    s = np.concatenate([s[o], np.full(pad, v - 1)])
    r = np.concatenate([r[o], np.full(pad, v - 1)])
    mask = (np.arange(s.size) < s.size - pad) & ~np.isin(r, masked_rows)
    ng = np.minimum(np.arange(v) * 5 // max(v - 40, 1), 5).astype(np.int32)
    return sparse_batch(np.zeros((v, 1), np.float32), s, r, mask, ng < 5, ng,
                        np.zeros(5, np.int32), np.ones(5, bool)).to(device)


# rows of the walk's degree classes (_sparse_graph with a tuple hub):
# leaves, empty rows, rows of exactly 32 and 33 edges, a row past the 64-chunk
# cap (> 2,048 edges), padded runs of one chunk and of several
WALK_CASES = [
    (3000, 6000, (32, 33, 2100), 300, 32, "float32"),
    (3000, 6000, (32, 33, 2100), 20, 32, "bfloat16"),
    (3000, 6000, (32, 33, 2100), 300, 64, "float32"),
    (3000, 6000, (32, 33, 2100), 300, 64, "bfloat16"),
    (3000, 6000, (32, 33, 2100), 2500, 128, "float32"),
    (3000, 6000, (32, 33, 2100), 300, 128, "bfloat16"),
    (3000, 6000, (32, 33, 2100), 20, 256, "float32"),
    (3000, 6000, (32, 33, 2100), 300, 256, "bfloat16"),
]


@pytest.mark.parametrize("v,e,hub,pad,h,dtype", [
    (300, 900, 0, 0, 32, "float32"),
    (1000, 4000, 700, 300, 128, "bfloat16"),
    (1000, 4000, 700, 300, 128, "float32"),
    (2048, 6000, 3000, 5000, 64, "bfloat16"),
    (512, 1500, 40, 33, 256, "bfloat16"),
] + WALK_CASES)
def test_sparse_kernels_match_plain(cuda, v, e, hub, pad, h, dtype):
    from cal_tpu_torch.ops.pool import segment_pool, segment_pool_plain
    from cal_tpu_torch.ops.spmm import (
        coef_spmm_plain, pair_coef_spmm, pair_sender_degree, pair_sender_degree_plain,
        plain_coef_spmm)

    g = _sparse_graph(cuda, v, e, hub, pad, seed=v + h, isolated=7)
    gen = torch.Generator(device=cuda).manual_seed(v * h)
    xc, xo = (torch.randn((v, h), generator=gen, device=cuda).to(DT[dtype]) for _ in range(2))
    src = torch.randn(v, generator=gen, device=cuda).to(DT[dtype])
    dst = (2 * torch.randn(v, generator=gen, device=cuda)).to(DT[dtype])
    atol, rtol = SPARSE_TOL[dtype]
    before = (pair_sender_degree.launches, pair_coef_spmm.launches,
              plain_coef_spmm.launches, segment_pool.launches)

    degs = pair_sender_degree(src, dst, g)
    torch.testing.assert_close(degs, pair_sender_degree_plain(src, dst, g), atol=DEG_TOL[0],
                               rtol=DEG_TOL[1])
    deg = degs + 1.0
    dis = torch.rsqrt(deg)
    got = pair_coef_spmm(xc, xo, src, dst, deg, dis, g)
    ref = coef_spmm_plain([xc, xo], src, dst, deg, dis, g)
    for a, b in zip(got, ref):
        assert a.dtype == DT[dtype] and torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)

    zero = pair_sender_degree(None, None, g)
    torch.testing.assert_close(zero, pair_sender_degree_plain(None, None, g), atol=0, rtol=0)
    pdeg = 2.0 * zero[:1] + 1.0
    got = plain_coef_spmm(xc, pdeg, torch.rsqrt(pdeg), g)
    (ref,) = coef_spmm_plain([xc], None, None, pdeg, torch.rsqrt(pdeg), g)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)

    pooled = segment_pool(xc, g.node_graph, 6)
    torch.testing.assert_close(pooled, segment_pool_plain(xc, g.node_graph, 6),
                               atol=POOL_TOL[0], rtol=POOL_TOL[1])
    torch.cuda.synchronize()
    assert (pair_sender_degree.launches, pair_coef_spmm.launches, plain_coef_spmm.launches,
            segment_pool.launches) == (before[0] + 2, before[1] + 1, before[2] + 1,
                                       before[3] + 1)


def test_sparse_kernels_are_deterministic(cuda):
    from cal_tpu_torch.ops.spmm import gcn_aggregate_sparse_pair

    g = _sparse_graph(cuda, 2048, 6000, 3000, 5000, seed=1)
    gen = torch.Generator(device=cuda).manual_seed(1)
    xc, xo = (torch.randn((2048, 128), generator=gen, device=cuda) for _ in range(2))
    src, dst = (torch.randn(2048, generator=gen, device=cuda) for _ in range(2))
    a = gcn_aggregate_sparse_pair(xc, xo, src, dst, g)
    b = gcn_aggregate_sparse_pair(xc, xo, src, dst, g)
    assert all(torch.equal(u, w) for u, w in zip(a, b))


def test_sparse_wrappers_raise_on_mixed_devices(cuda):
    from cal_tpu_torch.ops.pool import segment_pool
    from cal_tpu_torch.ops.spmm import pair_coef_spmm, pair_sender_degree

    g = _sparse_graph(cuda, 64, 100, 0, 5, seed=2)
    x = torch.zeros((64, 32))
    with pytest.raises(ValueError):
        pair_sender_degree(x[:, 0], x[:, 0], g)
    deg = torch.ones((2, 64), device=cuda)
    with pytest.raises(ValueError):
        pair_coef_spmm(x, x, x[:, 0], x[:, 0], deg, deg, g)
    with pytest.raises(ValueError):
        segment_pool(x.to(cuda), g.node_graph.cpu(), 6)


# ---- sparse backward: K2T, K3T, K5, K6 (csrc/spmm.cu), K7 (csrc/pool.cu) --
# Same rounding points in kernel and twin (csrc/spmm.cu header).  K2T/K3T as
# K2/K3 (SPARSE_TOL).  K5/K6 outputs stay f32: dot products of H terms and
# sums over a row's edges (up to thousands at the hub) in another order,
# fmaf and expf, on values of order 10-100 here: (atol, rtol) 1e-3 / 1e-4.
# K7 copies f32 rows and rounds them once: exact.
CHAIN_TOL = (1e-3, 1e-4)


def _bwd_inputs(device, v, h, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    xc, xo, gc, go = (torch.randn((v, h), generator=gen, device=device).to(DT[dtype])
                      for _ in range(4))
    src = torch.randn(v, generator=gen, device=device).to(DT[dtype])
    dst = (2 * torch.randn(v, generator=gen, device=device)).to(DT[dtype])
    return xc, xo, gc, go, src, dst


@pytest.mark.parametrize("v,e,hub,pad,h,dtype", [
    (300, 900, 0, 0, 32, "float32"),
    (1000, 4000, 700, 300, 128, "bfloat16"),
    (1000, 4000, 700, 300, 128, "float32"),
    (2048, 6000, 3000, 5000, 64, "bfloat16"),
    (512, 1500, 40, 33, 256, "bfloat16"),
] + WALK_CASES)
def test_sparse_backward_kernels_match_plain(cuda, v, e, hub, pad, h, dtype):
    from cal_tpu_torch.ops import spmm
    from cal_tpu_torch.ops.pool import segment_pool_bwd, segment_pool_bwd_plain

    g = _sparse_graph(cuda, v, e, hub, pad, seed=v + h + 1, isolated=7)
    xc, xo, gc, go, src, dst = _bwd_inputs(cuda, v, h, dtype, v * h + 1)
    counters = (spmm.pair_coef_spmm_t, spmm.plain_coef_spmm_t, spmm.pair_sddmm_chain,
                spmm.pair_dpre, segment_pool_bwd)
    before = [k.launches for k in counters]
    deg = spmm.pair_sender_degree_plain(src, dst, g) + 1.0
    dis = torch.rsqrt(deg)
    atol, rtol = SPARSE_TOL[dtype]
    got = spmm.pair_coef_spmm_t(gc, go, src, dst, deg, dis, g)
    ref = spmm.coef_spmm_plain([gc, go], src, dst, deg, dis, g, transpose=True)
    for a, b in zip(got, ref):
        assert a.dtype == DT[dtype] and torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)

    pdeg = 2.0 * spmm.pair_sender_degree_plain(None, None, g)[:1] + 1.0
    got = spmm.plain_coef_spmm_t(gc, pdeg, torch.rsqrt(pdeg), g)
    (ref,) = spmm.coef_spmm_plain([gc], None, None, pdeg, torch.rsqrt(pdeg), g, transpose=True)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)

    # K5 and K6: their sums by sender and by receiver against the twins'
    # per-edge terms summed in f64 (_sum_f64; the hub's f32 index_add_ sum of
    # 3,000 terms moves between runs on the card by about the tolerance)
    # K5 and K6 leave both CSRs' arrival counters at 0, give the same bits
    # on a second call, and write vec = 0 exactly on dead edges (the padded
    # run included), which keeps them out of K6's sums
    s, r = g.senders.long(), g.receivers.long()
    live = g.edge_mask & (s != r)
    idle = lambda: not g.recv.arrivals.any() and not g.send.arrivals.any()
    got = spmm.pair_sddmm_chain(xc, xo, gc, go, src, dst, dis, g)
    torch.cuda.synchronize()
    assert idle() and (got[0][:, ~live] == 0).all()
    again = spmm.pair_sddmm_chain(xc, xo, gc, go, src, dst, dis, g)
    torch.cuda.synchronize()
    assert idle() and all(torch.equal(a, b) for a, b in zip(got, again))
    ref = spmm.pair_sddmm_chain_plain(xc, xo, gc, go, src, dst, dis, g)
    sig = torch.sigmoid(src.float()[s] + dst.float()[r])
    w = torch.stack([sig, 1.0 - sig]).double() * live
    dc = torch.stack([(gk.float()[r] * x.float()[s]).sum(-1)
                      for x, gk in ((xc, gc), (xo, go))]).double() * live
    ddis = dis.double()
    ref = (ref[0], _sum_f64(s, (dc * w * ddis[:, r]).T, v).T,
           _sum_f64(r, (dc * w * ddis[:, s]).T, v).T)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=CHAIN_TOL[0], rtol=CHAIN_TOL[1])
    vec = ref[0]
    ddeg = torch.randn((2, v), generator=torch.Generator(device=cuda).manual_seed(v),
                       device=cuda)
    dpre = ((vec[0] + ddeg[0][s] - vec[1] - ddeg[1][s]) * vec[2])[:, None]
    got = spmm.pair_dpre(vec, ddeg, g)
    torch.cuda.synchronize()
    assert idle()
    for a, b in zip(got, (_sum_f64(s, dpre, v)[:, 0], _sum_f64(r, dpre, v)[:, 0])):
        torch.testing.assert_close(a, b, atol=CHAIN_TOL[0], rtol=CHAIN_TOL[1])
    again = spmm.pair_dpre(vec, ddeg, g)
    torch.cuda.synchronize()
    assert idle() and all(torch.equal(a, b) for a, b in zip(got, again))

    dpooled = torch.randn((6, h), generator=torch.Generator(device=cuda).manual_seed(h),
                          device=cuda)
    got = segment_pool_bwd(dpooled, g.node_graph, DT[dtype])
    assert torch.equal(got, segment_pool_bwd_plain(dpooled, g.node_graph, DT[dtype]))
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 1, 2, 2, 1]


def test_sparse_backward_kernels_match_autograd(cuda):
    """f32 Functions on the card (every backward kernel) against
    torch.autograd of the forward twins."""
    from cal_tpu_torch.ops import spmm
    from cal_tpu_torch.ops.pool import segment_pool, segment_pool_plain

    g = _sparse_graph(cuda, 1000, 4000, 700, 300, seed=9, isolated=7)
    xc, xo, gc, go, src, dst = _bwd_inputs(cuda, 1000, 128, "float32", 9)
    leaves = [t.clone().requires_grad_() for t in (xc, xo, src, dst)]
    deg = spmm.pair_sender_degree_plain(leaves[2], leaves[3], g) + 1.0
    oc, oo = spmm.coef_spmm_plain(leaves[:2], leaves[2], leaves[3], deg, torch.rsqrt(deg), g)
    ref = torch.autograd.grad((oc * gc).sum() + (oo * go).sum(), leaves)
    leaves = [t.clone().requires_grad_() for t in (xc, xo, src, dst)]
    oc, oo = spmm.gcn_aggregate_sparse_pair(*leaves, g)
    got = torch.autograd.grad((oc * gc).sum() + (oo * go).sum(), leaves)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=CHAIN_TOL[0], rtol=CHAIN_TOL[1])

    x = xc.clone().requires_grad_()
    pdeg = 2.0 * spmm.pair_sender_degree_plain(None, None, g)[:1] + 1.0
    (o,) = spmm.coef_spmm_plain([x], None, None, pdeg, torch.rsqrt(pdeg), g)
    ref = torch.autograd.grad((o * gc).sum(), x)[0]
    x = xc.clone().requires_grad_()
    got = torch.autograd.grad((spmm.gcn_aggregate_sparse_plain(x, g) * gc).sum(), x)[0]
    torch.testing.assert_close(got, ref, atol=SPARSE_TOL["float32"][0],
                               rtol=SPARSE_TOL["float32"][1])

    dp = torch.randn((6, 128), device=cuda)
    x = xc.clone().requires_grad_()
    ref = torch.autograd.grad((segment_pool_plain(x, g.node_graph, 6) * dp).sum(), x)[0]
    x = xc.clone().requires_grad_()
    got = torch.autograd.grad((segment_pool(x, g.node_graph, 6) * dp).sum(), x)[0]
    assert torch.equal(got, ref)


def test_sparse_autograd_on_card_launches_kernels(cuda):
    """One bf16 backward through both aggregates and the pool launches each
    backward kernel once; constant logits skip K5 and K6."""
    from cal_tpu_torch.ops import spmm
    from cal_tpu_torch.ops.pool import segment_pool, segment_pool_bwd

    g = _sparse_graph(cuda, 512, 1500, 40, 33, seed=4)
    xc, xo, gc, go, src, dst = _bwd_inputs(cuda, 512, 128, "bfloat16", 4)
    counters = (spmm.pair_coef_spmm_t, spmm.plain_coef_spmm_t, spmm.pair_sddmm_chain,
                spmm.pair_dpre, segment_pool_bwd)
    for logits_grad, want in ((True, [1, 1, 1, 1, 1]), (False, [1, 1, 0, 0, 1])):
        before = [k.launches for k in counters]
        leaves = [t.clone().requires_grad_(i < 2 or logits_grad)
                  for i, t in enumerate((xc, xo, src, dst))]
        oc, oo = spmm.gcn_aggregate_sparse_pair(*leaves, g)
        y = spmm.gcn_aggregate_sparse_plain(oc, g) + oo
        pooled = segment_pool(y, g.node_graph, 6)
        pooled.sum().backward()
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(counters, before)] == want
        assert all(torch.isfinite(t.grad.float()).all() for t in leaves if t.requires_grad)


def test_sparse_backward_kernels_are_deterministic(cuda):
    from cal_tpu_torch.ops import spmm

    g = _sparse_graph(cuda, 2048, 6000, 3000, 5000, seed=3)
    xc, xo, gc, go, src, dst = _bwd_inputs(cuda, 2048, 128, "float32", 3)

    def grads():
        leaves = [t.clone().requires_grad_() for t in (xc, xo, src, dst)]
        oc, oo = spmm.gcn_aggregate_sparse_pair(*leaves, g)
        return torch.autograd.grad((oc * gc).sum() + (oo * go).sum(), leaves)

    assert all(torch.equal(a, b) for a, b in zip(grads(), grads()))


def test_chain_kernel_launches(cuda):
    """K5 and K15 are two device kernels a call (the receiver pass and
    csr_reduce_kernel's sender sums), K6 and K16 one over both CSRs; none of
    them is a pass over all V rows (row_combine)."""
    from cal_tpu_torch.ops import spmm

    v = 3000
    g = _sparse_graph(cuda, v, 6000, (32, 33, 2100), 300, seed=23, isolated=7)
    xc, xo, gc, go, src, dst = _bwd_inputs(cuda, v, 128, "bfloat16", 23)
    dis = torch.rsqrt(spmm.pair_sender_degree_plain(src, dst, g) + 1.0)
    s32, d32 = src.float(), dst.float()
    ddeg = torch.randn((2, v), generator=torch.Generator(device=cuda).manual_seed(23),
                       device=cuda)
    vec = spmm.pair_sddmm_chain(xc, xo, gc, go, src, dst, dis, g)[0]
    vec1 = spmm.sigmoid_sddmm_chain(xc, gc, s32, d32, dis[0], g, True)[0]
    for head, tail in (
            (lambda: spmm.pair_sddmm_chain(xc, xo, gc, go, src, dst, dis, g),
             lambda: spmm.pair_dpre(vec, ddeg, g)),
            (lambda: spmm.sigmoid_sddmm_chain(xc, gc, s32, d32, dis[0], g, True),
             lambda: spmm.sigmoid_dpre(vec1, ddeg[0], g, True))):
        names = _device_kernels(head)
        assert len(names) == 2, names
        assert "chain_head_kernel" in names[0] and "csr_reduce_kernel" in names[1], names
        names = _device_kernels(tail)
        assert len(names) == 1 and "chain_tail_kernel" in names[0], names


def test_degree_and_pool_gather_kernel_launches(cuda):
    """K1 (its sums, and deg / dis as the aggregates take them), the plain
    conv's degree and K13 are one device kernel a call each: csr_reduce_kernel
    with the degree policy, the epilogue in its row writes, no pass over all
    V rows (row_combine) and no deg_dis_kernel; K7 and K4 are one kernel
    each."""
    from cal_tpu_torch.ops import spmm
    from cal_tpu_torch.ops.pool import segment_pool, segment_pool_bwd

    v = 3000
    g = _sparse_graph(cuda, v, 6000, (32, 33, 2100), 300, seed=25, isolated=7)
    _, _, _, _, src, dst = _bwd_inputs(cuda, v, 128, "bfloat16", 25)
    s32, d32 = src.float(), dst.float()
    for fn in (lambda: spmm.pair_sender_degree(src, dst, g),
               lambda: spmm.pair_sender_degree(src, dst, g, norm=True),
               lambda: spmm.plain_sender_degree(g),
               lambda: spmm.sigmoid_sender_degree(s32, d32, g, True)):
        names = _device_kernels(fn)
        assert len(names) == 1, names
        assert "csr_reduce_kernel" in names[0] and "DegreeSum" in names[0], names
    dpooled = torch.randn((6, 128), device=cuda)
    names = _device_kernels(lambda: segment_pool_bwd(dpooled, g.node_graph, torch.bfloat16))
    assert len(names) == 1 and "pool_bwd_kernel" in names[0], names
    x = torch.randn((v, 128), device=cuda).bfloat16()
    names = _device_kernels(lambda: segment_pool(x, g.node_graph, 6))
    assert len(names) == 1 and "pool_kernel" in names[0], names


@pytest.mark.parametrize("logits", ["float32", "bfloat16"])
def test_sender_degree_hub_sums(cuda, logits):
    """K1 and K13 (both ``negate``s) on the walk's special shapes (a hub
    sender of 2,100 edges: 33 chunks, rows of 32 and 33 edges, padded runs)
    against the twins' weights summed in f64 (``_sum_f64``); the plain
    conv's degree against its twin exactly (a count); each call leaves the
    sender CSR's arrival counters at 0 and a second call repeats its bits;
    the epilogue's (deg, dis) equal the sums + 1 and torch.rsqrt of them bit
    for bit."""
    from cal_tpu_torch.ops import spmm

    v = 3000
    g = _sparse_graph(cuda, v, 6000, (32, 33, 2100), 300, seed=26, isolated=7)
    assert int(g.send.chunk_ptr[6] - g.send.chunk_ptr[5]) == 33
    _, _, _, _, src, dst = _bwd_inputs(cuda, v, 128, logits, 26)
    s, r = g.senders.long(), g.receivers.long()
    live = g.edge_mask & (s != r)
    sig = torch.sigmoid(src.float()[s] + dst.float()[r]).double()
    idle = lambda: not g.send.arrivals.any() and not g.recv.arrivals.any()

    def repeated(fn):
        got = fn()
        torch.cuda.synchronize()
        assert idle()
        again = fn()
        torch.cuda.synchronize()
        assert idle()
        got, again = ((got,) if torch.is_tensor(got) else got,
                      (again,) if torch.is_tensor(again) else again)
        assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True))
        return got

    (sums,) = repeated(lambda: spmm.pair_sender_degree(src, dst, g))
    ref = _sum_f64(s, (torch.stack([sig, 1.0 - sig]) * live).T, v).T
    torch.testing.assert_close(sums, ref, atol=DEG_TOL[0], rtol=DEG_TOL[1])
    deg, dis = repeated(lambda: spmm.pair_sender_degree(src, dst, g, norm=True))
    assert torch.equal(deg, sums + 1.0) and torch.equal(dis, torch.rsqrt(sums + 1.0))
    s32, d32 = src.float(), dst.float()
    for negate in (False, True):
        deg, dis = repeated(lambda: spmm.sigmoid_sender_degree(s32, d32, g, negate))
        w = (1.0 - sig if negate else sig) * live
        torch.testing.assert_close(deg, _sum_f64(s, w[:, None], v)[:, 0] + 1.0,
                                   atol=DEG_TOL[0], rtol=DEG_TOL[1])
        assert torch.equal(dis, torch.rsqrt(deg))
    deg, dis = repeated(lambda: spmm.plain_sender_degree(g))
    pdeg, pdis = spmm.plain_sender_degree_plain(g)
    assert torch.equal(deg, pdeg) and torch.equal(dis, torch.rsqrt(pdeg))
    assert torch.equal(deg, 2.0 * spmm.pair_sender_degree(None, None, g)[:1] + 1.0)


@pytest.mark.parametrize("h", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_gather_exact_in_any_order(cuda, h, dtype):
    """K7 equals its twin bit for bit on a sorted node_graph of 3,800-row
    graphs (REDDIT's largest) and a run of 1-row graphs, on the same ids
    shuffled, and on a V that is no multiple of 32."""
    from cal_tpu_torch.ops.pool import segment_pool_bwd, segment_pool_bwd_plain

    rng = np.random.default_rng(h)
    sizes = np.concatenate([[3800, 3800, 17], np.ones(40, np.int64), [2500]])
    ng = np.repeat(np.arange(sizes.size), sizes)
    ng = np.concatenate([ng, np.full(1231, sizes.size)]).astype(np.int32)   # trash segment
    dpooled = torch.randn((sizes.size + 1, h), generator=torch.Generator(
        device=cuda).manual_seed(h), device=cuda)
    before = segment_pool_bwd.launches
    for order in (ng, rng.permutation(ng), ng[:-7]):
        t = torch.from_numpy(order).to(cuda)
        got = segment_pool_bwd(dpooled, t, DT[dtype])
        assert got.shape == (t.shape[0], h) and got.dtype == DT[dtype]
        assert torch.equal(got, segment_pool_bwd_plain(dpooled, t, DT[dtype]))
    torch.cuda.synchronize()
    assert segment_pool_bwd.launches == before + 3


# K4's segment layouts: (graph sizes, trash rows, extra empty segments after
# the trash one): empty segments first, between and last; one 3,800-row
# graph; the trash segment the widest; all rows in one segment; V no
# multiple of a run (32 rows)
POOL_CASES = {
    "empty_segments": ([0, 0, 5, 0, 0, 40, 1, 0, 300, 0], 17, 3),
    "reddit_graph": ([12, 3800, 7, 200], 300, 0),
    "trash_widest": ([100] * 20 + [31, 1], 1231, 0),
    "one_segment": ([], 4000, 0),
    "ragged": ([33, 1, 31, 64, 2, 95], 5, 0),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
@pytest.mark.parametrize("h", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_kernel_segments(cuda, case, h, dtype):
    """K4 against its twin within POOL_TOL on each layout of POOL_CASES; two
    calls give the same bits, each one launch, and the arrival counters are
    0 again after each."""
    from cal_tpu_torch.ops import pool

    sizes, trash, extra = POOL_CASES[case]
    ng = np.concatenate([np.repeat(np.arange(len(sizes)), sizes),
                         np.full(trash, len(sizes))]).astype(np.int32)
    g1 = len(sizes) + 1 + extra
    x = torch.randn((ng.size, h), generator=torch.Generator(device=cuda).manual_seed(h),
                    device=cuda).to(DT[dtype])
    t = torch.from_numpy(ng).to(cuda)
    before = pool.segment_pool.launches
    got = pool.segment_pool(x, t, g1)
    torch.cuda.synchronize()
    counters = pool._arrivals[(x.device, torch.cuda.current_stream(cuda).cuda_stream)]
    assert not counters.any()
    again = pool.segment_pool(x, t, g1)
    torch.cuda.synchronize()
    assert not counters.any()
    assert pool.segment_pool.launches == before + 2
    assert got.shape == (g1, h) and got.dtype == torch.float32
    assert torch.equal(got, again)
    torch.testing.assert_close(got, pool.segment_pool_plain(x, t, g1),
                               atol=POOL_TOL[0], rtol=POOL_TOL[1])


def test_pool_kernel_raises_on_misaligned_x(cuda):
    """K4 loads 16 bytes of a row at a time: x off a 16-byte boundary raises."""
    from cal_tpu_torch.ops.pool import segment_pool

    flat = torch.randn(64 * 128 + 8, device=cuda).bfloat16()
    x = flat[1:1 + 64 * 128].view(64, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        segment_pool(x, torch.zeros(64, dtype=torch.int32, device=cuda), 2)


def test_pool_kernel_on_two_streams(cuda):
    """K4 launched on two streams at once, each call's segments spanning
    runs (so each call counts arrivals): every call equals the same call
    made alone, bit for bit, and each stream's counters are its own and 0
    after."""
    from cal_tpu_torch.ops import pool

    sizes, trash, _ = POOL_CASES["trash_widest"]
    ng = torch.from_numpy(np.concatenate([np.repeat(np.arange(len(sizes)), sizes),
                                          np.full(trash, len(sizes))]).astype(np.int32)).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    xs = [torch.randn((ng.shape[0], 128), generator=gen, device=cuda).bfloat16()
          for _ in range(2)]
    alone = [pool.segment_pool(x, ng, len(sizes) + 1) for x in xs]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(pool.segment_pool(xs[i], ng, len(sizes) + 1))
    torch.cuda.synchronize()
    keys = [(ng.device, s.cuda_stream) for s in streams]
    assert pool._arrivals[keys[0]].data_ptr() != pool._arrivals[keys[1]].data_ptr()
    for i in range(2):
        assert not pool._arrivals[keys[i]].any()
        assert all(torch.equal(out, alone[i]) for out in got[i])


def test_pool_kernel_in_a_cuda_graph(cuda):
    """K4 captured in a CUDA graph on a stream it ran on before replays to
    the bits of an eager call; a capture on a stream it never ran on
    raises instead of making its counters inside the graph."""
    from cal_tpu_torch.ops import pool

    ng = torch.from_numpy(np.concatenate([np.repeat(np.arange(3), [40, 3800, 9]),
                                          np.full(300, 3)]).astype(np.int32)).to(cuda)
    x = torch.randn((ng.shape[0], 64), generator=torch.Generator(device=cuda).manual_seed(9),
                    device=cuda)
    ref = pool.segment_pool(x, ng, 4)
    s = torch.cuda.Stream(cuda)
    torch.cuda.synchronize()
    with torch.cuda.stream(s):
        pool.segment_pool(x, ng, 4)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        out = pool.segment_pool(x, ng, 4)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
    fresh = [t for t in (torch.cuda.Stream(cuda) for _ in range(64))
             if (ng.device, t.cuda_stream) not in pool._arrivals][0]
    with pytest.raises(RuntimeError, match="before capturing"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            pool.segment_pool(x, ng, 4)


def test_chain_head_raises_on_misaligned_rows(cuda):
    """K5 and K15 load 16 bytes of a row at a time: a feature row off that
    alignment raises instead of launching."""
    from cal_tpu_torch.ops import spmm

    v, h = 512, 128
    g = _sparse_graph(cuda, v, 1500, 40, 33, seed=24)
    xc, xo, gc, go, src, dst = _bwd_inputs(cuda, v, h, "bfloat16", 24)
    dis = torch.rsqrt(spmm.pair_sender_degree_plain(src, dst, g) + 1.0)
    off = torch.empty(v * h + 1, dtype=torch.bfloat16, device=cuda)[1:].view(v, h)
    off.copy_(gc)
    with pytest.raises(ValueError, match="aligned"):
        spmm.pair_sddmm_chain(xc, xo, off, go, src, dst, dis, g)
    with pytest.raises(ValueError, match="aligned"):
        spmm.sigmoid_sddmm_chain(off, gc, src.float(), dst.float(), dis[0], g)


# ---- row 12, one sigmoid-weighted branch: K13-K16 (csrc/spmm.cu) ----------
# Same rounding points in kernel and twin (csrc/spmm.cu header).  K13: f32
# sums of sigmoids in another order with expf, rsqrtf against PyTorch's
# rsqrt (2 ulp): DEG_TOL.  K14/K14T as K2 (SPARSE_TOL).  K15/K16 as K5/K6
# (CHAIN_TOL).


def _sigmoid_counters():
    from cal_tpu_torch.ops import spmm

    return (spmm.sigmoid_sender_degree, spmm.sigmoid_coef_spmm, spmm.sigmoid_coef_spmm_t,
            spmm.sigmoid_sddmm_chain, spmm.sigmoid_dpre)


@pytest.mark.parametrize("v,e,hub,pad,h,dtype,negate,logits", [
    (300, 900, 0, 0, 32, "float32", False, "float32"),
    (1000, 4000, 700, 300, 128, "bfloat16", True, "bfloat16"),
    (1000, 4000, 700, 300, 128, "float32", True, "float32"),
    (2048, 6000, 3000, 5000, 64, "bfloat16", False, "bfloat16"),
    (512, 1500, 40, 33, 256, "float32", False, "float32"),
    (1000, 4000, 700, 300, 128, "bfloat16", False, "float32"),   # the bench's config 4
    (1000, 4000, 700, 300, 128, "bfloat16", True, "float32"),
] + [(*c, i % 2 == 1, "float32") for i, c in enumerate(WALK_CASES)])
def test_sigmoid_kernels_match_plain(cuda, v, e, hub, pad, h, dtype, negate, logits):
    from cal_tpu_torch.ops import spmm

    g = _sparse_graph(cuda, v, e, hub, pad, seed=v + h + 2, isolated=7)
    x, _, gout, _, src, dst = _bwd_inputs(cuda, v, h, dtype, v * h + 2)
    src, dst = src.to(DT[logits]), dst.to(DT[logits])
    before = [k.launches for k in _sigmoid_counters()]
    ref_deg = spmm.sigmoid_sender_degree_plain(src, dst, g, negate)
    for a, b in zip(spmm.sigmoid_sender_degree(src, dst, g, negate), ref_deg):
        torch.testing.assert_close(a, b, atol=DEG_TOL[0], rtol=DEG_TOL[1])
    deg, dis = ref_deg
    atol, rtol = SPARSE_TOL[dtype]
    for fn, transpose, inp in ((spmm.sigmoid_coef_spmm, False, x),
                               (spmm.sigmoid_coef_spmm_t, True, gout)):
        got = fn(inp, src, dst, deg, dis, g, negate)
        ref = spmm.sigmoid_coef_spmm_plain(inp, src, dst, deg, dis, g, negate, transpose)
        assert got.dtype == DT[dtype] and torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    # K15 and K16 as K5 and K6: counters at 0, the same bits again, vec = 0
    # exactly on dead edges
    live = g.edge_mask & (g.senders != g.receivers)
    idle = lambda: not g.recv.arrivals.any() and not g.send.arrivals.any()
    got = spmm.sigmoid_sddmm_chain(x, gout, src, dst, dis, g, negate)
    torch.cuda.synchronize()
    assert idle() and (got[0][:, ~live] == 0).all()
    again = spmm.sigmoid_sddmm_chain(x, gout, src, dst, dis, g, negate)
    torch.cuda.synchronize()
    assert idle() and all(torch.equal(a, b) for a, b in zip(got, again))
    ref = spmm.sigmoid_sddmm_chain_plain(x, gout, src, dst, dis, g, negate)
    for a, b in zip(got, ref, strict=True):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=CHAIN_TOL[0], rtol=CHAIN_TOL[1])
    ddeg = torch.randn(v, generator=torch.Generator(device=cuda).manual_seed(v), device=cuda)
    got = spmm.sigmoid_dpre(ref[0], ddeg, g, negate)
    torch.cuda.synchronize()
    assert idle()
    for a, b in zip(got, spmm.sigmoid_dpre_plain(ref[0], ddeg, g, negate), strict=True):
        torch.testing.assert_close(a, b, atol=CHAIN_TOL[0], rtol=CHAIN_TOL[1])
    again = spmm.sigmoid_dpre(ref[0], ddeg, g, negate)
    torch.cuda.synchronize()
    assert idle() and all(torch.equal(a, b) for a, b in zip(got, again))
    assert [k.launches - b for k, b in zip(_sigmoid_counters(), before)] == [1, 1, 1, 2, 2]


def test_sigmoid_aggregate_matches_autograd_and_launches(cuda):
    """The f32 Function on the card (K13-K16) against torch.autograd of the
    plain function, both ``negate`` values, one launch of each kernel per
    forward and backward; two runs give equal results."""
    from cal_tpu_torch.ops import spmm

    g = _sparse_graph(cuda, 1000, 4000, 700, 300, seed=11, isolated=7)
    x, _, gout, _, src, dst = _bwd_inputs(cuda, 1000, 128, "float32", 11)
    for negate in (False, True):
        res = []
        for fn in (spmm.gcn_aggregate_sparse_sigmoid_plain, spmm.gcn_aggregate_sparse_sigmoid,
                   spmm.gcn_aggregate_sparse_sigmoid):
            before = [k.launches for k in _sigmoid_counters()]
            leaves = [t.clone().requires_grad_() for t in (x, src, dst)]
            out = fn(*leaves, g, negate)
            res.append([out, *torch.autograd.grad(out, leaves, gout)])
            torch.cuda.synchronize()
            want = 0 if fn is spmm.gcn_aggregate_sparse_sigmoid_plain else 1
            assert [k.launches - b for k, b in zip(_sigmoid_counters(), before)] == [want] * 5
        for a, r in zip(res[1], res[0]):
            torch.testing.assert_close(a, r, atol=CHAIN_TOL[0], rtol=CHAIN_TOL[1])
        assert all(torch.equal(a, b) for a, b in zip(res[1], res[2]))


# ---- sparse GAT: K8, K9, K9T, K10 (csrc/gat_sparse.cu) ---------------------
# Same rounding points in kernel and twin (csrc/gat_sparse.cu header): x in
# the model dtype, every plane, weight, product, sum and output f32, so the
# same tolerances hold in both dtypes.  K8: m is a max of the same f32
# values, den a sum of up to a few thousand exp terms <= 1 in another order
# with expf: (1e-5, 1e-5).  K9/K9T: f32 sums over a row's edges in another
# order with fmaf: SPARSE_TOL["float32"].  K10: dot products and row sums
# as K5: CHAIN_TOL.
GAT_STATS_TOL = (1e-5, 1e-5)
GAT_WORDS = (0x9E3779B9, 0x7F4A7C15)


def _gat_inputs(device, v, heads, h, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    xh = torch.randn((v, heads, h // heads), generator=gen, device=device).to(DT[dtype])
    att = 0.6 * torch.randn((2, heads, h // heads), generator=gen, device=device)
    xf = xh.float()
    ti = torch.einsum("vhd,hd->hv", xf, att[0]).contiguous()
    tj = torch.einsum("vhd,hd->hv", xf, att[1]).contiguous()
    w = torch.randn((v, h), generator=gen, device=device)
    dD = torch.randn((heads, v), generator=gen, device=device)
    return xh, att, ti, tj, w, dD


@pytest.mark.parametrize("v,e,hub,pad,heads,h,dtype,rate", [
    (300, 900, 0, 0, 1, 32, "float32", 0.0),
    (1000, 4000, 700, 300, 4, 128, "bfloat16", 0.0),
    (1000, 4000, 700, 300, 4, 128, "bfloat16", 0.2),
    (1000, 4000, 700, 300, 4, 128, "float32", 0.2),
    (2048, 6000, 3000, 5000, 2, 64, "bfloat16", 0.2),
    (512, 1500, 40, 33, 8, 256, "float32", 0.5),
])
def test_gat_sparse_kernels_match_plain(cuda, v, e, hub, pad, heads, h, dtype, rate):
    from cal_tpu_torch.ops import gat_sparse as gs

    g = _sparse_graph(cuda, v, e, hub, pad, seed=v + h + 2, isolated=7)
    xh, _, ti, tj, w, dD = _gat_inputs(cuda, v, heads, h, dtype, v * h + 2)
    x = xh.reshape(v, h)
    counters = (gs.gat_row_stats, gs.gat_coef_spmm, gs.gat_coef_spmm_t, gs.gat_sddmm_chain)
    before = [k.launches for k in counters]
    m, den = gs.gat_row_stats(tj, ti, g)
    rm, rden = gs.gat_row_stats_plain(tj, ti, g)
    torch.testing.assert_close(m, rm, atol=GAT_STATS_TOL[0], rtol=GAT_STATS_TOL[1])
    torch.testing.assert_close(den, rden, atol=GAT_STATS_TOL[0], rtol=GAT_STATS_TOL[1])
    atol, rtol = SPARSE_TOL["float32"]
    got = gs.gat_coef_spmm(x, tj, ti, m, GAT_WORDS, rate, g)
    ref = gs.gat_coef_spmm_plain(x, tj, ti, m, GAT_WORDS, rate, g)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    got = gs.gat_coef_spmm_t(w, tj, ti, m, GAT_WORDS, rate, g)
    ref = gs.gat_coef_spmm_plain(w, tj, ti, m, GAT_WORDS, rate, g, transpose=True)
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    got = gs.gat_sddmm_chain(x, w, tj, ti, m, dD, GAT_WORDS, rate, g)
    ref = gs.gat_sddmm_chain_plain(x, w, tj, ti, m, dD, GAT_WORDS, rate, g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=CHAIN_TOL[0], rtol=CHAIN_TOL[1])
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 1, 1, 1]


# K8, K9, K9T and K10 on the walk's special shapes: a receiver and sender hub
# of 2,100 edges (node 5: past 2,048, so a row of 33 two-group chunks in both
# CSRs), rows of 32 and 33 edges, a padded run of heavy masked chunks at node
# V-1, and receivers whose in-edges are all masked: node 4 (33 edges, two
# heavy chunks of masked edges alone), node 9 and a random leaf (light rows).
GAT_WALK_MASKED = (4, 9, 1234)


def _sum_f64(rows, msg, v):
    """The sums of the messages msg [E, H] (f64 products of f32 or bf16
    values) by rows, in f64 on the card, cast to f32: a reference whose order
    moves no f32 bit.  (A twin's f32
    index_add_ sums in an order that varies from run to run on the card, by
    up to ~2e-4 over a hub of 2,100 edges.)"""
    out = torch.zeros((v, msg.shape[1]), dtype=torch.float64, device=msg.device)
    return out.index_add_(0, rows, msg.double()).float()


def _gat_spmm_f64(x, tj, ti, m, rate, g, transpose=False):
    """K9 (K9T with ``transpose``) as ``gat_coef_spmm_plain`` forms it, its
    sums in f64 (``_sum_f64``)."""
    from cal_tpu_torch.ops import gat_sparse as gs

    s, r = g.senders.long(), g.receivers.long()
    heads, e = tj.shape[0], s.shape[0]
    _, q = gs._edge_q(tj, ti, m, s, r, g.edge_mask & (s != r))
    if rate > 0.0:
        q = q * gs._edge_keep(GAT_WORDS, rate, heads, e, q.device) / (1.0 - rate)
    row, nbr = (s, r) if transpose else (r, s)
    msg = x.double()[nbr].view(e, heads, -1) * q.T.double()[:, :, None]
    return _sum_f64(row, msg.view(e, -1), g.num_nodes)


@pytest.mark.parametrize("heads", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_gat_stats_and_chain_walk_shapes(cuda, heads, dtype, rate):
    """K8, K9, K9T and K10 against their twins (K9 and K9T against their sums
    in f64) on the walk's special shapes, at each head count, dtype and rate:
    rows without a live in-edge get m = the self score and den = 0 exactly,
    K9's rows there and K9T's rows without a live out-edge are exactly 0, a
    second call gives the same bits, and every call leaves both CSRs'
    arrival counters at 0."""
    from cal_tpu_torch.ops import gat_sparse as gs

    v, h = 3000, 32 * heads
    g = _sparse_graph(cuda, v, 6000, (32, 33, 2100), 300, seed=heads + 17, isolated=7,
                      masked_rows=GAT_WALK_MASKED)
    hub = [int(c.chunk_ptr[6] - c.chunk_ptr[5]) for c in (g.recv, g.send)]
    assert hub == [33, 33] and int(g.recv.heavy_masked.sum()) >= 2
    xh, _, ti, tj, w, dD = _gat_inputs(cuda, v, heads, h, dtype, 100 * heads + 7)
    x = xh.reshape(v, h)
    idle = lambda: not g.recv.arrivals.any() and not g.send.arrivals.any()
    kernels = (gs.gat_row_stats, gs.gat_coef_spmm, gs.gat_coef_spmm_t, gs.gat_sddmm_chain)
    before = [k.launches for k in kernels]
    m, den = gs.gat_row_stats(tj, ti, g)
    torch.cuda.synchronize()
    assert idle()
    rm, rden = gs.gat_row_stats_plain(tj, ti, g)
    torch.testing.assert_close(m, rm, atol=GAT_STATS_TOL[0], rtol=GAT_STATS_TOL[1])
    torch.testing.assert_close(den, rden, atol=GAT_STATS_TOL[0], rtol=GAT_STATS_TOL[1])
    dead = list(GAT_WALK_MASKED) + [v - 1]
    self_score = torch.nn.functional.leaky_relu(ti + tj, 0.2)
    assert torch.equal(m[:, dead], self_score[:, dead]) and (den[:, dead] == 0).all()
    assert all(torch.equal(a, b) for a, b in zip((m, den), gs.gat_row_stats(tj, ti, g)))
    atol, rtol = SPARSE_TOL["float32"]
    no_out = [v - 1] + list(range(v - 8, v - 1))     # the padded run's sender, isolated nodes
    for fn, xin, t, rows in ((gs.gat_coef_spmm, x, False, dead),
                             (gs.gat_coef_spmm_t, w, True, no_out)):
        got = fn(xin, tj, ti, rm, GAT_WORDS, rate, g)
        torch.cuda.synchronize()
        assert idle() and got.dtype == torch.float32 and torch.isfinite(got).all()
        torch.testing.assert_close(got, _gat_spmm_f64(xin, tj, ti, rm, rate, g, t),
                                   atol=atol, rtol=rtol)
        assert (got[rows] == 0).all()
        again = fn(xin, tj, ti, rm, GAT_WORDS, rate, g)
        torch.cuda.synchronize()
        assert idle() and torch.equal(got, again)
    got = gs.gat_sddmm_chain(x, w, tj, ti, rm, dD, GAT_WORDS, rate, g)
    torch.cuda.synchronize()
    assert idle()
    ref = gs.gat_sddmm_chain_plain(x, w, tj, ti, rm, dD, GAT_WORDS, rate, g)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=CHAIN_TOL[0], rtol=CHAIN_TOL[1])
    assert (got[1][:, dead] == 0).all()
    again = gs.gat_sddmm_chain(x, w, tj, ti, rm, dD, GAT_WORDS, rate, g)
    torch.cuda.synchronize()
    assert idle() and all(torch.equal(a, b) for a, b in zip(got, again))
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2, 2, 2]


def test_gat_stats_and_chain_kernel_launches(cuda):
    """K8, K9 and K9T are one kernel launch a call each (K9 and K9T the
    coefficient SpMM walk) and K10 two (its receiver pass and its sender
    sums), none of them a pass over all V rows."""
    from cal_tpu_torch.ops import gat_sparse as gs

    v = 3000
    g = _sparse_graph(cuda, v, 6000, (32, 33, 2100), 300, seed=21, isolated=7)
    xh, _, ti, tj, w, dD = _gat_inputs(cuda, v, 4, 128, "bfloat16", 21)
    names = _device_kernels(lambda: gs.gat_row_stats(tj, ti, g))
    assert len(names) == 1 and "gat_row_stats_kernel" in names[0], names
    m = gs.gat_row_stats_plain(tj, ti, g)[0]
    for fn, xin in ((gs.gat_coef_spmm, xh.reshape(v, 128)), (gs.gat_coef_spmm_t, w)):
        names = _device_kernels(lambda: fn(xin, tj, ti, m, GAT_WORDS, 0.2, g))
        assert len(names) == 1 and "csr_spmm_kernel" in names[0], names
        assert "GatSpmm" in names[0], names
    names = _device_kernels(
        lambda: gs.gat_sddmm_chain(xh.reshape(v, 128), w, tj, ti, m, dD, GAT_WORDS, 0.2, g))
    assert len(names) == 2, names
    assert "gat_chain_kernel" in names[0] and "csr_reduce_kernel" in names[1], names


def test_gat_stats_and_chain_kernel_launches_from_a_seed_buffer(cuda):
    """The same launches when the dropout seed is handed over as a train
    step hands it, a seed buffer on the card: K9 and K9T one kernel a call,
    K10 two."""
    from cal_tpu_torch.ops import gat_sparse as gs
    from cal_tpu_torch.ops.flash_gat import seed_buffer

    v = 3000
    g = _sparse_graph(cuda, v, 6000, (32, 33, 2100), 300, seed=21, isolated=7)
    xh, _, ti, tj, w, dD = _gat_inputs(cuda, v, 4, 128, "bfloat16", 21)
    seed = seed_buffer(GAT_WORDS[0] | GAT_WORDS[1] << 32, cuda)
    m = gs.gat_row_stats_plain(tj, ti, g)[0]
    for fn, xin in ((gs.gat_coef_spmm, xh.reshape(v, 128)), (gs.gat_coef_spmm_t, w)):
        names = _device_kernels(lambda: fn(xin, tj, ti, m, seed, 0.2, g))
        assert len(names) == 1 and "csr_spmm_kernel" in names[0], names
        assert "GatSpmm" in names[0], names
    names = _device_kernels(
        lambda: gs.gat_sddmm_chain(xh.reshape(v, 128), w, tj, ti, m, dD, seed, 0.2, g))
    assert len(names) == 2, names
    assert "gat_chain_kernel" in names[0] and "csr_reduce_kernel" in names[1], names


def test_gat_sparse_keep_bits_match_twin(cuda):
    """With zero logits every live weight is 1: K9 on ones counts each
    receiver's kept (edge, head) pairs and K9T each sender's, which must
    equal the twin's hash bit for bit."""
    from cal_tpu_torch.ops import gat_sparse as gs
    from cal_tpu_torch.ops.gat import head_ids, keep_mask

    g = _sparse_graph(cuda, 1000, 4000, 700, 300, seed=11, isolated=7)
    v, heads, rate = 1000, 4, 0.2
    zero = torch.zeros((heads, v), device=cuda)
    ones = torch.ones((v, 32 * heads), device=cuda)
    s, r = g.senders.long(), g.receivers.long()
    live = (g.edge_mask & (s != r)).float()
    keep = keep_mask(head_ids(torch.arange(s.shape[0], device=cuda), heads), GAT_WORDS, rate,
                     0) * live[:, None]
    for fn, rows in ((gs.gat_coef_spmm, r), (gs.gat_coef_spmm_t, s)):
        got = fn(ones, zero, zero, zero, GAT_WORDS, rate, g).view(v, heads, 32)
        kept = torch.zeros((v, heads), device=cuda).index_add_(0, rows, keep)
        torch.testing.assert_close(got * (1 - rate), kept[:, :, None].expand(-1, -1, 32),
                                   atol=1e-4, rtol=1e-6)
    assert abs(float(keep.sum() / (live.sum() * heads)) - (1 - rate)) < 0.02


def test_gat_sparse_backward_matches_autograd(cuda):
    """The f32 Function on the card (K8, K9 forward; K9T, K10 backward) at
    rate 0.2 against torch.autograd of the forward built from the twins."""
    from cal_tpu_torch.ops import gat_sparse as gs

    g = _sparse_graph(cuda, 1000, 4000, 700, 300, seed=12, isolated=7)
    xh, att, _, _, w, _ = _gat_inputs(cuda, 1000, 4, 128, "float32", 12)
    a = [t.clone().requires_grad_() for t in (xh, att[0], att[1])]
    b = [t.clone().requires_grad_() for t in (xh, att[0], att[1])]
    out = gs.gat_aggregate_sparse_fused(*a, GAT_WORDS, g, 0.2)
    ref = gs.gat_aggregate_sparse_fused_plain(*b, GAT_WORDS, g, 0.2)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    cot = w.view(out.shape)
    for u, r in zip(torch.autograd.grad(out, a, cot), torch.autograd.grad(ref, b, cot)):
        torch.testing.assert_close(u, r, atol=CHAIN_TOL[0], rtol=CHAIN_TOL[1])


def test_gat_sparse_autograd_on_card_launches_kernels(cuda):
    """One bf16 forward and backward of the aggregate launches each kernel
    once, and a second run gives the same gradients."""
    from cal_tpu_torch.ops import gat_sparse as gs

    g = _sparse_graph(cuda, 2048, 6000, 3000, 5000, seed=13)
    xh, att, _, _, w, _ = _gat_inputs(cuda, 2048, 4, 128, "bfloat16", 13)
    counters = (gs.gat_row_stats, gs.gat_coef_spmm, gs.gat_coef_spmm_t, gs.gat_sddmm_chain)

    def grads():
        leaves = [t.clone().requires_grad_() for t in (xh, att[0], att[1])]
        out = gs.gat_aggregate_sparse_fused(*leaves, GAT_WORDS, g, 0.2)
        return torch.autograd.grad(out, leaves, w.view(out.shape).to(out.dtype))

    before = [k.launches for k in counters]
    first = grads()
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 1, 1, 1]
    assert all(torch.isfinite(t.float()).all() for t in first)
    assert all(torch.equal(u, r) for u, r in zip(first, grads()))


# ---- coefficient SpMM: K11, K11T, K12 (csrc/coo_spmm.cu) -------------------
# Same rounding points in kernel and twin (csrc/coo_spmm.cu header): x and g
# read in their dtype, coefficients, products, sums and outputs f32, so one
# tolerance for both dtypes.  K11/K11T: f32 sums over a row's edges (up to
# thousands at the hub) in another order with fmaf: SPARSE_TOL["float32"].
# K12: dot products of H terms in another order: (1e-4, 1e-4) as well.
COO_TOL = (1e-4, 1e-4)


@pytest.mark.parametrize("v,e,hub,pad,h,dtype,coef_kind", [
    (300, 900, 0, 0, 32, "float32", "mask"),
    (1000, 4000, 700, 300, 128, "bfloat16", "mask"),
    (1000, 4000, 700, 300, 128, "float32", "random"),
    (2048, 6000, 3000, 5000, 64, "bfloat16", "random"),
    (512, 1500, 40, 33, 256, "bfloat16", "mask"),
] + [(*c, ("mask", "random")[i % 2]) for i, c in enumerate(WALK_CASES)])
def test_coo_kernels_match_plain(cuda, v, e, hub, pad, h, dtype, coef_kind):
    from cal_tpu_torch.ops import coo_spmm as coo

    g = _sparse_graph(cuda, v, e, hub, pad, seed=v + h + 2, isolated=7)
    gen = torch.Generator(device=cuda).manual_seed(v * h + 2)
    x = torch.randn((v, h), generator=gen, device=cuda).to(DT[dtype])
    gout = torch.randn((v, h), generator=gen, device=cuda)
    coef = (g.edge_mask.float() if coef_kind == "mask"
            else torch.randn(g.senders.shape, generator=gen, device=cuda))
    counters = (coo.coo_spmm, coo.coo_spmm_t, coo.coo_sddmm)
    before = [k.launches for k in counters]
    # K11 and K11T against their sums in f64 (a hub's f32 sum in the twin's
    # index_add_ order moves between runs on the card by about the tolerance)
    s, r = g.senders.long(), g.receivers.long()
    c = coef.double()[:, None]
    gb = gout.to(DT[dtype])
    for got, ref in ((coo.coo_spmm(x, coef, g), _sum_f64(r, c * x.double()[s], v)),
                     (coo.coo_spmm_t(gout, coef, g), _sum_f64(s, c * gout.double()[r], v)),
                     (coo.coo_spmm_t(gb, coef, g), _sum_f64(s, c * gb.double()[r], v)),
                     (coo.coo_sddmm(x, gout, g), coo.coo_sddmm_plain(x, gout, g))):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, atol=COO_TOL[0], rtol=COO_TOL[1])
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 2, 1]


def test_coo_aggregate_backward_matches_autograd_and_launches(cuda):
    """The f32 Function on the card (K11, K11T, K12) against torch.autograd
    of the forward twin; a coefficient without a gradient skips K12."""
    from cal_tpu_torch.ops import coo_spmm as coo

    g = _sparse_graph(cuda, 1000, 4000, 700, 300, seed=11, isolated=7)
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((1000, 128), generator=gen, device=cuda)
    coef = torch.randn(g.senders.shape, generator=gen, device=cuda)
    cot = torch.randn((1000, 128), generator=gen, device=cuda)
    a = [t.clone().requires_grad_() for t in (x, coef)]
    b = [t.clone().requires_grad_() for t in (x, coef)]
    got = torch.autograd.grad((coo.coo_aggregate(*a, g) * cot).sum(), a)
    ref = torch.autograd.grad((coo.coo_spmm_plain(*b, g) * cot).sum(), b)
    for u, w in zip(got, ref):
        torch.testing.assert_close(u, w, atol=COO_TOL[0], rtol=COO_TOL[1])
    before = [coo.coo_spmm.launches, coo.coo_spmm_t.launches, coo.coo_sddmm.launches]
    leaf = x.bfloat16().requires_grad_()
    (dx,) = torch.autograd.grad(coo.coo_aggregate(leaf, g.edge_mask.float(), g).sum(), leaf)
    torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16
    assert [coo.coo_spmm.launches, coo.coo_spmm_t.launches, coo.coo_sddmm.launches] == [
        before[0] + 1, before[1] + 1, before[2]]


def test_coo_kernels_are_deterministic_and_raise_on_mixed_devices(cuda):
    from cal_tpu_torch.ops import coo_spmm as coo

    g = _sparse_graph(cuda, 2048, 6000, 3000, 5000, seed=5)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((2048, 128), generator=gen, device=cuda)
    coef = torch.randn(g.senders.shape, generator=gen, device=cuda)
    assert torch.equal(coo.coo_spmm(x, coef, g), coo.coo_spmm(x, coef, g))
    assert torch.equal(coo.coo_spmm_t(x, coef, g), coo.coo_spmm_t(x, coef, g))
    assert torch.equal(coo.coo_sddmm(x, x, g), coo.coo_sddmm(x, x, g))
    with pytest.raises(ValueError):
        coo.coo_spmm(x.cpu(), coef, g)
    with pytest.raises(ValueError):
        coo.coo_spmm(x, coef.cpu(), g)
    with pytest.raises(ValueError):
        coo.coo_sddmm(x, x.cpu(), g)


def _runs(rng, n, v, longest):
    """n senders in [0, v) in runs of 1 to ``longest`` equal values."""
    out = []
    while len(out) < n:
        out += [int(rng.integers(0, v))] * int(rng.integers(1, longest + 1))
    return np.array(out[:n])


def _sddmm_graph(device, pad, seed=31):
    """A receiver-sorted GraphBatch for K12 / K20's walk (V 3,000): rows of
    0 (the last 7 before V-1), 1, 32 and 33 edges; light rows of runs of
    equal senders (one of 32 edges in runs, one of 3 equal); a 33-edge row
    whose run crosses its chunk boundary; a hub of 2,100 edges (chunks of
    64, two windows of 32 each) in runs of up to 40 that cross window and
    chunk boundaries; random rows of about 2 edges; and 2,500 padded edges
    at node V-1 (chunks of 64) whose senders are all V-1 (``pad`` "equal"),
    in runs ("runs") or all drawn apart ("random")."""
    from cal_tpu_torch.graph import sparse_batch

    rng = np.random.default_rng(seed)
    v, live_v, n_pad = 3000, 2992, 2500
    rows = {3: rng.integers(9, live_v, 1), 4: rng.integers(9, live_v, 32),
            5: np.repeat(rng.integers(9, live_v, 2), (30, 3)),
            6: np.repeat(rng.integers(9, live_v, 4), (5, 10, 1, 16)),
            7: _runs(rng, 2100, live_v, 40), 8: np.full(3, 11)}
    r_rand = np.sort(rng.integers(9, live_v, 6000))
    s = np.concatenate([*rows.values(), rng.integers(0, live_v, 6000)])
    r = np.concatenate([np.full(len(a), k) for k, a in rows.items()] + [r_rand])
    pads = {"equal": np.full(n_pad, v - 1), "runs": _runs(rng, n_pad, v, 50),
            "random": rng.permutation(v)[:n_pad]}[pad]
    s, r = np.concatenate([s, pads]), np.concatenate([r, np.full(n_pad, v - 1)])
    mask = np.arange(s.size) < s.size - n_pad
    ng = np.minimum(np.arange(v) * 5 // (v - 40), 5).astype(np.int32)
    return sparse_batch(np.zeros((v, 1), np.float32), s, r, mask, ng < 5, ng,
                        np.zeros(5, np.int32), np.ones(5, bool)).to(device)


@pytest.mark.parametrize("pad", ["equal", "runs", "random"])
@pytest.mark.parametrize("xdt,gdt", [("bfloat16", "float32"), ("float32", "float32"),
                                     ("bfloat16", "bfloat16"), ("float32", "bfloat16")])
@pytest.mark.parametrize("h", [32, 64, 128, 256])
def test_sddmm_kernels_match_plain(cuda, pad, xdt, gdt, h):
    """K12 and K20 at heads 1, 2, 4 and 8 against their twin on every case
    of the walk (the graph's rows, its hub's chunks and windows, runs of
    equal senders inside and across them, each kind of padded run), x and g
    each in its dtype: one launch a call, the same bits on a second call."""
    from cal_tpu_torch.ops import coo_spmm as coo

    g = _sddmm_graph(cuda, pad)
    gen = torch.Generator(device=cuda).manual_seed(h + len(pad))
    x = torch.randn((g.num_nodes, h), generator=gen, device=cuda).to(DT[xdt])
    gout = torch.randn((g.num_nodes, h), generator=gen, device=cuda).to(DT[gdt])
    for heads in (None, 1, 2, 4, 8):
        fn = ((lambda: coo.coo_sddmm(x, gout, g)) if heads is None
              else (lambda heads=heads: coo.coo_sddmm_mh(x, gout, g, heads)))
        counter = coo.coo_sddmm if heads is None else coo.coo_sddmm_mh
        before = counter.launches
        got = fn()
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        torch.testing.assert_close(got, coo.coo_sddmm_plain(x, gout, g, heads),
                                   atol=COO_TOL[0], rtol=COO_TOL[1])
        assert torch.equal(fn(), got)


@pytest.mark.parametrize("heads", [None, 4])
def test_sddmm_is_one_device_kernel(cuda, heads):
    """K12 and K20 launch one kernel a call, and touch no arrival counter."""
    from cal_tpu_torch.ops import coo_spmm as coo

    g = _sddmm_graph(cuda, "equal")
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((g.num_nodes, 128), generator=gen, device=cuda).bfloat16()
    gout = torch.randn((g.num_nodes, 128), generator=gen, device=cuda)
    g.recv.arrivals.fill_(7)
    names = _device_kernels(lambda: coo._sddmm("sddmm", x, gout, g, heads))
    assert len(names) == 1 and "coo_sddmm_kernel" in names[0], names
    assert (g.recv.arrivals == 7).all()


def test_sddmm_raises_on_misaligned_rows(cuda):
    """K12 / K20 load 16 bytes of a row at a time: x or g off that
    alignment raises instead of launching."""
    from cal_tpu_torch.ops import coo_spmm as coo

    g = _sddmm_graph(cuda, "equal")
    v = g.num_nodes
    x = torch.randn((v, 128), device=cuda).bfloat16()
    off = torch.empty(v * 128 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(v, 128)
    off.copy_(x)
    for a, b in ((off, x), (x, off)):
        with pytest.raises(ValueError, match="aligned"):
            coo.coo_sddmm(a, b, g)
        with pytest.raises(ValueError, match="aligned"):
            coo.coo_sddmm_mh(a, b, g, 4)


def test_sddmm_on_two_streams_and_in_a_cuda_graph(cuda):
    """K12 and K20 share nothing between launches: calls on two streams at
    once, and a CUDA graph captured on a stream they never ran on, give the
    bits of a call made alone."""
    from cal_tpu_torch.ops import coo_spmm as coo

    g = _sddmm_graph(cuda, "runs")
    gen = torch.Generator(device=cuda).manual_seed(5)
    xs = [torch.randn((g.num_nodes, 128), generator=gen, device=cuda) for _ in range(2)]
    gout = torch.randn((g.num_nodes, 128), generator=gen, device=cuda).bfloat16()
    calls = [lambda: coo.coo_sddmm(xs[0], gout, g), lambda: coo.coo_sddmm_mh(xs[1], gout, g, 4)]
    alone = [fn() for fn in calls]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(calls[i]())
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(out, alone[i]) for out in got[i])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(cuda)):
        outs = [fn() for fn in calls]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, a) for o, a in zip(outs, alone))


# Edge-formulated GAT (csrc/edge_gat.cu) against its twins: f32 results (out
# in f32, dti, dtj) are sums over a row's or a sender's slots in another
# order with expf and fmaf: 1e-4.  In bf16, out and dxh are rounded once to
# bf16, so a sum on the other side of a rounding boundary moves by one bf16
# ulp (2^-7 relative at most).
EDGE_TOL = (1e-4, 1e-4)
EDGE_T_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 8e-3)}


def _edge_inputs(device, b, n, heads, hd, per_graph, hub, dtype, seed):
    """A sorted int32 edge list with random edges per graph, a hub receiver
    (row 0 of graph 0, over 32 slots, duplicates among them), self loops,
    an empty last graph and padding; ti, tj, xh and a cotangent."""
    rng = np.random.default_rng(seed)
    ef = []
    for g in range(b - 1):
        m = min(n - 2, max(2, n // 2))
        r, s = rng.integers(0, m, per_graph), rng.integers(0, m, per_graph)
        r[:3] = s[:3]                                           # self loops
        ef.append((g * n + r) * n + s)
    ef.append(rng.integers(1, n, hub))                          # graph 0, receiver 0
    ef = np.sort(np.concatenate(ef))
    ef = np.concatenate([ef, np.full(29, b * n * n)]).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=gen, device=device)
    return (torch.from_numpy(ef).to(device), rand(b, n, heads), rand(b, n, heads),
            rand(b, n, hd).to(DT[dtype]), rand(b, n, hd).to(DT[dtype]))


@pytest.mark.parametrize("b,n,heads,hd,per_graph,hub,dtype,rate", [
    (3, 24, 4, 32, 60, 40, "float32", 0.0),
    (4, 64, 2, 64, 200, 300, "bfloat16", 0.2),
    (8, 384, 4, 128, 900, 1500, "bfloat16", 0.0),
    (8, 384, 4, 128, 900, 1500, "float32", 0.2),
    (2, 100, 8, 256, 150, 70, "bfloat16", 0.2),
    (3, 50, 1, 32, 80, 33, "float32", 0.2),
])
def test_edge_gat_kernels_match_plain(cuda, b, n, heads, hd, per_graph, hub, dtype, rate):
    from cal_tpu_torch.ops import edge_gat as eg

    ef, ti, tj, xh, g = _edge_inputs(cuda, b, n, heads, hd, per_graph, hub, dtype, seed=n)
    seed = 0x9E3779B97F4A7C15
    before = (eg.edge_gat_fwd.launches, eg.edge_gat_bwd.launches)
    out = eg.edge_gat_fwd(ti, tj, xh, ef, seed, rate)
    got = eg.edge_gat_bwd(ti, tj, xh, ef, g, seed, rate)
    torch.cuda.synchronize()
    assert (eg.edge_gat_fwd.launches, eg.edge_gat_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out.float(), eg.edge_gat_fwd_plain(ti, tj, xh, ef, seed, rate).float(),
                               atol=EDGE_T_TOL[dtype][0], rtol=EDGE_T_TOL[dtype][1])
    ref = eg.edge_gat_bwd_plain(ti, tj, xh, ef, g, seed, rate)
    for name, a, r in zip(("dti", "dtj", "dxh"), got, ref):
        tol = EDGE_T_TOL[dtype] if name == "dxh" else EDGE_TOL
        assert torch.isfinite(a.float()).all(), name
        torch.testing.assert_close(a.float(), r.float(), atol=tol[0], rtol=tol[1], msg=name)


def test_edge_gat_backward_matches_autograd_and_launches(cuda):
    """The f32 Function on the card against torch.autograd of the forward
    twin at dropout 0.2 (the backward replays the forward's keep bits);
    edge_gat_dense_flat launches one forward and one backward kernel."""
    from cal_tpu_torch.ops import edge_gat as eg

    ef, ti, tj, xh, g = _edge_inputs(cuda, 4, 400, 4, 128, 800, 700, "float32", seed=3)
    seed, rate = 12345, 0.2
    a = [t.clone().requires_grad_() for t in (ti, tj, xh)]
    b = [t.clone().requires_grad_() for t in (ti, tj, xh)]
    got = torch.autograd.grad((eg._EdgeGAT.apply(*a, ef, seed, rate) * g).sum(), a)
    ref = torch.autograd.grad((eg.edge_gat_fwd_plain(*b, ef, seed, rate) * g).sum(), b)
    for u, w in zip(got, ref):
        torch.testing.assert_close(u, w, atol=EDGE_TOL[0], rtol=EDGE_TOL[1])
    before = (eg.edge_gat_fwd.launches, eg.edge_gat_bwd.launches)
    leaf = xh.bfloat16().requires_grad_()
    att = torch.randn(4, 32, device=cuda)
    out = eg.edge_gat_dense_flat(leaf, ef, att, att, 0.2, seed)
    (dx,) = torch.autograd.grad(out.float().sum(), leaf)
    torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16 and out.dtype == torch.bfloat16
    assert (eg.edge_gat_fwd.launches, eg.edge_gat_bwd.launches) == (before[0] + 1, before[1] + 1)


def test_edge_gat_kernels_are_deterministic_and_raise(cuda):
    from cal_tpu_torch.ops import edge_gat as eg

    ef, ti, tj, xh, g = _edge_inputs(cuda, 4, 256, 4, 128, 600, 2000, "bfloat16", seed=9)
    assert torch.equal(eg.edge_gat_fwd(ti, tj, xh, ef, 7, 0.2), eg.edge_gat_fwd(ti, tj, xh, ef, 7, 0.2))
    for u, w in zip(eg.edge_gat_bwd(ti, tj, xh, ef, g, 7, 0.2),
                    eg.edge_gat_bwd(ti, tj, xh, ef, g, 7, 0.2)):
        assert torch.equal(u, w)
    with pytest.raises(ValueError):
        eg.edge_gat_fwd(ti.cpu(), tj, xh, ef)
    with pytest.raises(ValueError, match="int32"):
        eg.edge_gat_fwd(ti, tj, xh, ef.long())
    with pytest.raises(ValueError, match="heads"):
        eg.edge_gat_fwd(ti, tj, xh[..., :96].contiguous(), ef)


def _edge_case(device, case, dtype="float32", heads=4, hd=128, seed=5):
    """(edge_flat, ti, tj, xh, g) of an index case on ``device``."""
    if case == "special":
        b, n = 3, 48
        ef = torch.from_numpy(hub_edges(b, n)).to(device)
    elif case == "empty":
        b, n = 4, 64
        ef = torch.full((96,), b * n * n, dtype=torch.int32, device=device)
    else:
        return _edge_inputs(device, 8, 384, heads, hd, 900, 1500, dtype, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *sh: torch.randn(sh, generator=gen, device=device)
    return ef, rand(b, n, heads), rand(b, n, heads), rand(b, n, hd).to(DT[dtype]), \
        rand(b, n, hd).to(DT[dtype])


@pytest.mark.parametrize("case", ["special", "empty", "random_hub"])
def test_edge_index_kernels_match_plain_build(cuda, case):
    """The index the kernels build on the card equals the plain build
    (EdgeIndex.build_plain, torch ops) of the same list, up to the order
    of its node lists, and leaves every arrival counter at 0."""
    from cal_tpu_torch.ops.edge_gat import EdgeIndex

    ef, ti = _edge_case(cuda, case)[:2]
    b, n = ti.shape[:2]
    got = EdgeIndex(ef, b, n).build()
    torch.cuda.synchronize()
    assert got.as_lists() == EdgeIndex(ef, b, n).build_plain().as_lists()


def _empty_nodes(ef, b, n):
    """Mask [B*N] of the nodes without a live slot as receiver or sender."""
    total = b * n * n
    live = ef[(ef >= 0) & (ef < total)].long()
    used = torch.zeros(b * n, dtype=torch.bool, device=ef.device)
    used[live // n] = True
    used[live // (n * n) * n + live % n] = True
    return ~used


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.2, 0.9999])
def test_edge_gat_special_rows_match_plain(cuda, dtype, rate):
    """Hubs over several chunks, rows of self loops only, an empty graph and
    (rate 0.9999) rows whose slots are all dropped, against the twins at
    EDGE_TOL / EDGE_T_TOL; the nodes without a slot either way bit for bit;
    one launch of each wrapper a call."""
    from cal_tpu_torch.ops import edge_gat as eg

    ef, ti, tj, xh, g = _edge_case(cuda, "special", dtype)
    b, n, heads = ti.shape
    seed = 0x5DEECE66D
    before = (eg.edge_gat_fwd.launches, eg.edge_gat_bwd.launches)
    out = eg.edge_gat_fwd(ti, tj, xh, ef, seed, rate)
    got = eg.edge_gat_bwd(ti, tj, xh, ef, g, seed, rate)
    torch.cuda.synchronize()
    assert (eg.edge_gat_fwd.launches, eg.edge_gat_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = eg.edge_gat_fwd_plain(ti, tj, xh, ef, seed, rate)
    ref = eg.edge_gat_bwd_plain(ti, tj, xh, ef, g, seed, rate)
    torch.testing.assert_close(out.float(), want.float(), atol=EDGE_T_TOL[dtype][0],
                               rtol=EDGE_T_TOL[dtype][1])
    for name, a, r in zip(("dti", "dtj", "dxh"), got, ref):
        tol = EDGE_T_TOL[dtype] if name == "dxh" else EDGE_TOL
        torch.testing.assert_close(a.float(), r.float(), atol=tol[0], rtol=tol[1], msg=name)
    empty = _empty_nodes(ef, b, n)
    assert int(empty.sum()) > n        # graph 1 and the unused nodes
    for a, r in zip((out,) + got, (want,) + ref):
        assert torch.equal(a.reshape(b * n, -1)[empty], r.reshape(b * n, -1)[empty])


def test_edge_gat_all_empty_batch_bits(cuda):
    """A batch without a live slot: every output equals the twin's bit for
    bit (out and dxh keep_v scale times xh and g, dti = dtj = 0)."""
    from cal_tpu_torch.ops import edge_gat as eg

    for dtype in ("float32", "bfloat16"):
        ef, ti, tj, xh, g = _edge_case(cuda, "empty", dtype)
        for rate in (0.0, 0.2):
            assert torch.equal(eg.edge_gat_fwd(ti, tj, xh, ef, 3, rate),
                               eg.edge_gat_fwd_plain(ti, tj, xh, ef, 3, rate))
            for a, r in zip(eg.edge_gat_bwd(ti, tj, xh, ef, g, 3, rate),
                            eg.edge_gat_bwd_plain(ti, tj, xh, ef, g, 3, rate)):
                assert torch.equal(a, r)


def test_edge_gat_nonfinite_logit_in_empty_row(cuda):
    """A non-finite logit (inf, -inf, NaN) on nodes without slots gives NaN
    where the twin gives NaN, and the twin's values elsewhere."""
    from cal_tpu_torch.ops import edge_gat as eg

    ef, ti, tj, xh, g = _edge_case(cuda, "special", "float32")
    ti, tj = ti.clone(), tj.clone()
    ti[1, 3, 0], ti[1, 7, 2], tj[0, 45, 1] = float("inf"), float("-inf"), float("nan")
    for rate in (0.0, 0.2):
        out = eg.edge_gat_fwd(ti, tj, xh, ef, 11, rate)
        want = eg.edge_gat_fwd_plain(ti, tj, xh, ef, 11, rate)
        assert bool(torch.isnan(want).any())
        torch.testing.assert_close(out, want, atol=EDGE_TOL[0], rtol=EDGE_TOL[1], equal_nan=True)
        for a, r in zip(eg.edge_gat_bwd(ti, tj, xh, ef, g, 11, rate),
                        eg.edge_gat_bwd_plain(ti, tj, xh, ef, g, 11, rate)):
            torch.testing.assert_close(a, r, atol=EDGE_TOL[0], rtol=EDGE_TOL[1], equal_nan=True)


def test_edge_gat_index_and_stats_handed_give_the_same_bits(cuda):
    """The batch's index handed (built once, used by two layers' calls) or
    built per call, and the forward's statistics handed or formed again:
    equal bits, two calls equal bits, one launch of each wrapper a call;
    edge_gat_dense_flat on the batch's index equals it without."""
    from cal_tpu_torch.ops import edge_gat as eg

    ef, ti, tj, xh, g = _edge_case(cuda, "random_hub", "bfloat16")
    b, n, heads = ti.shape
    idx = eg.EdgeIndex(ef, b, n)
    before = (eg.edge_gat_fwd.launches, eg.edge_gat_bwd.launches)
    out, stats = eg.edge_gat_fwd(ti, tj, xh, ef, 5, 0.2, idx, with_stats=True)
    outs = [out, eg.edge_gat_fwd(ti, tj, xh, ef, 5, 0.2, idx), eg.edge_gat_fwd(ti, tj, xh, ef, 5, 0.2)]
    grads = [eg.edge_gat_bwd(ti, tj, xh, ef, g, 5, 0.2, idx, stats),
             eg.edge_gat_bwd(ti, tj, xh, ef, g, 5, 0.2, idx, stats),
             eg.edge_gat_bwd(ti, tj, xh, ef, g, 5, 0.2)]
    torch.cuda.synchronize()
    assert (eg.edge_gat_fwd.launches, eg.edge_gat_bwd.launches) == (before[0] + 3, before[1] + 3)
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    for other in grads[1:]:
        assert all(torch.equal(u, w) for u, w in zip(grads[0], other))
    assert stats.shape == (2, b * n, heads) and stats.dtype == torch.float32
    att = torch.randn(heads, xh.shape[-1] // heads, device=cuda)
    runs = []
    for index in (idx, None):
        leaf = xh.detach().clone().requires_grad_()
        o = eg.edge_gat_dense_flat(leaf, ef, att, att, 0.2, 99, index)
        (dx,) = torch.autograd.grad(o.float().sum(), leaf)
        runs.append((o, dx))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    with pytest.raises(ValueError, match="edge index"):
        eg.edge_gat_fwd(ti[:2].contiguous(), tj[:2].contiguous(), xh[:2].contiguous(), ef, 5, 0.2,
                        idx)



def test_edge_index_raises_on_another_stream(cuda):
    """The launches over a batch's index share its arrival counters, so they
    run on the stream the index was built on: a forward or backward over it
    on another stream raises; on its own stream it runs."""
    from cal_tpu_torch.ops import edge_gat as eg

    ef, ti, tj, xh, g = _edge_case(cuda, "special", "float32")
    idx = eg.EdgeIndex(ef, *ti.shape[:2]).build()
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        with pytest.raises(ValueError, match="stream"):
            eg.edge_gat_fwd(ti, tj, xh, ef, 1, 0.2, idx)
        with pytest.raises(ValueError, match="stream"):
            eg.edge_gat_bwd(ti, tj, xh, ef, g, 1, 0.2, idx)
    torch.testing.assert_close(eg.edge_gat_fwd(ti, tj, xh, ef, 1, 0.2, idx),
                               eg.edge_gat_fwd_plain(ti, tj, xh, ef, 1, 0.2),
                               atol=EDGE_TOL[0], rtol=EDGE_TOL[1])

# ---- rows 4 and 3: one dense masked conv (K17/K17T, K18/K18B) ------------
# The dual kernels' modes, at their tolerances (DUAL_TOL, DUAL_BWD_TOL): the
# same rounding points in kernel and twin.  bf16 K17/K17T take the one-launch
# cluster path up to N = 256 with H a multiple of 8 (two feature chunks at H
# = 200), the two-pass path past it (plain_cluster_size); parity's N = 232
# and 248, N = 1.
@pytest.mark.parametrize("b,n,h,dtype", [
    (2, 24, 8, "float32"),
    (3, 24, 40, "bfloat16"),
    (4, 256, 128, "float32"),
    (4, 256, 128, "bfloat16"),
    (2, 384, 200, "bfloat16"),
    (8, 232, 128, "bfloat16"),
    (8, 248, 128, "bfloat16"),
    (2, 257, 128, "bfloat16"),
    (3, 200, 200, "bfloat16"),
    (2, 513, 128, "bfloat16"),
    (2, 640, 136, "bfloat16"),
    (2, 1, 128, "bfloat16"),
    (2, 1, 8, "float32"),
    (3, 256, 100, "bfloat16"),
])
def test_single_conv_kernels_match_plain(cuda, b, n, h, dtype):
    from cal_tpu_torch.ops import fused_gcn as fg

    x, _, adj, src, dst, g, _ = _dual_bwd_inputs(cuda, b, n, h, dtype, seed=n * h + 1)
    counters = (fg.fused_gcn_dense, fg.fused_gcn_dense_t, fg.fused_gcn_dense_att,
                fg.fused_gcn_dense_att_bwd)
    before = [k.launches for k in counters]
    atol, rtol = DUAL_TOL[dtype]
    pairs = [(fg._mm_fwd(x, adj), fg.fused_gcn_dense_plain(x, adj)),
             (fg.fused_gcn_dense_t(g, adj), fg.fused_gcn_dense_plain(g, adj, True))]
    for negate in (False, True):
        pairs.append((fg._att_fwd(x, adj, src, dst, negate)[0],
                      fg.fused_gcn_dense_att_plain(x, adj, src, dst, negate)))
        pairs += list(zip(fg.fused_gcn_dense_att_bwd(x, adj, src, dst, g, negate),
                          fg.fused_gcn_dense_att_bwd_plain(x, adj, src, dst, g, negate)))
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert got.dtype == DT[dtype] and got.shape == ref.shape
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)
    assert [k.launches - v for k, v in zip(counters, before)] == [1, 1, 2, 2]


@pytest.mark.parametrize("n,h", [(256, 128), (200, 200), (513, 64)])
def test_plain_conv_kernels_are_deterministic(cuda, n, h):
    """Two calls of K17 and of K17T give the same bits on either path; the
    cluster path (N <= 512) also equals the two-pass kernels bit for bit
    (exact integer degrees, the same norm rounding and product order)."""
    from cal_tpu_torch.ops import fused_gcn as fg

    x, _, adj, _, _, g, _ = _dual_bwd_inputs(cuda, 4, n, h, "bfloat16", seed=n + h)
    for t, transpose in ((x, False), (g, True)):
        one = fg._mm("K17", t, adj, transpose)
        assert torch.equal(one, fg._mm("K17", t, adj, transpose))
        if fg.plain_cluster_size(t.dtype, n, h):
            (two,), _, _ = fg._fwd_launch("K17", "plain_t" if transpose else "plain", (t,), adj)
            assert torch.equal(one, two)


def test_single_conv_functions_match_autograd_and_launch(cuda):
    """The f32 Functions on the card against torch.autograd of their forward
    twins; one launch of each kernel per call."""
    from cal_tpu_torch.ops import fused_gcn as fg

    x, _, adj, src, dst, g, _ = _dual_bwd_inputs(cuda, 3, 256, 128, "float32", 17)
    for negate in (False, True):
        a = [t.clone().requires_grad_() for t in (x, src, dst)]
        b = [t.clone().requires_grad_() for t in (x, src, dst)]
        before = (fg.fused_gcn_dense_att.launches, fg.fused_gcn_dense_att_bwd.launches)
        got = torch.autograd.grad((fg.fused_gcn_dense_att(a[0], adj, a[1], a[2], negate)
                                   * g).sum(), a)
        ref = torch.autograd.grad((fg.fused_gcn_dense_att_plain(b[0], adj, b[1], b[2], negate)
                                   * g).sum(), b)
        for u, w in zip(got, ref):
            torch.testing.assert_close(u, w, atol=DUAL_BWD_TOL["float32"][0],
                                       rtol=DUAL_BWD_TOL["float32"][1])
        assert (fg.fused_gcn_dense_att.launches, fg.fused_gcn_dense_att_bwd.launches) == (
            before[0] + 1, before[1] + 1)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    (got,) = torch.autograd.grad((fg.fused_gcn_dense(a, adj) * g).sum(), a)
    (ref,) = torch.autograd.grad((fg.fused_gcn_dense_plain(b, adj) * g).sum(), b)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError):
        fg.fused_gcn_dense(x, adj.bfloat16())
    with pytest.raises(ValueError):
        fg.fused_gcn_dense_att(x, adj, src.cpu(), dst)


# ---- rows 2 and 3's forward on padded batches: one read of adj, live steps --
def _padded_adj(device, b, n, sizes, seed):
    """[b, n, n] f32 counts: graph i on its first sizes[i] slots (about 3
    edges a node, some doubled, every 7th node a self loop), nothing past
    them: most 64 x 32 cells of a large slot hold no edge."""
    gen = torch.Generator(device=device).manual_seed(seed)
    adj = torch.zeros((b, n, n), device=device)
    for i, k in enumerate(sizes):
        if k == 0:
            continue
        r, s = (torch.randint(0, k, (3 * k,), generator=gen, device=device) for _ in range(2))
        adj[i].index_put_((r, s), torch.ones(3 * k, device=device), accumulate=True)
        d = torch.arange(0, k, 7, device=device)
        adj[i, d, d] = 1.0
    return adj


def _ref_live(adj):
    """The live map by its definition: a byte per (64-row strip, 32-column
    group) of each graph, 1 where an edge other than a self loop lies."""
    b, n, _ = adj.shape
    a = adj.float().clone()
    idx = torch.arange(n, device=adj.device)
    a[:, idx, idx] = 0.0
    sp, cp = -(-n // 64) * 64, -(-n // 32) * 32
    a = torch.nn.functional.pad(a, (0, cp - n, 0, sp - n))
    return (a.view(b, sp // 64, 64, cp // 32, 32) != 0).any(dim=4).any(dim=2).to(torch.uint8)


def _device_kernels(fn):
    """Names of the kernels one call of ``fn`` launches, in launch order
    (torch.profiler, after a warm-up call outside it; memory copies and sets
    are not kernels).  Inside the window the call follows a device-side sleep
    and a marker kernel (a fill of an f64 tensor, a type no wrapper fills):
    the profiler can miss a window's first kernels and, late in a long run,
    drop some of a window's kernels, so a window in which it recorded no
    kernel after the marker is taken again, up to five times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    mark = torch.empty(1, dtype=torch.float64, device="cuda")
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1_000_000)    # ~0.5 ms: the card busy while recording starts
            mark.fill_(1.0)
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")
                         and not e.name.startswith(("Memcpy", "Memset"))),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        first = next((i for i, n in enumerate(names) if "FillFunctor<double>" in n), None)
        if first is not None and first + 1 < len(names):
            return names[first + 1:]
    raise AssertionError("the profiler recorded no kernel after the marker")


# padded slots past the graphs (N = 3,840 is SYNREDDIT's budget), a graph
# filling its slot, empty and one-node slots, N % 8 != 0 (the element-wise
# adjacency reads), H past one 128-column chunk
PADDED_CASES = [(3, 384, (30, 120, 0), 32), (2, 700, (650, 5), 40),
                (4, 129, (1, 64, 65, 129), 128), (2, 260, (100, 259), 200),
                (2, 3840, (400, 3800), 128)]


@pytest.mark.parametrize("b,n,sizes,h", PADDED_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_kernels_match_plain_on_padded_batches(cuda, b, n, sizes, h, dtype):
    """Every forward mode over its live steps only (the dual pair, K18 at
    both negates, the two-pass K17 and K17T, called past the cluster path)
    against its twin; each writes the live map of its definition."""
    from cal_tpu_torch.ops import fused_gcn as fg

    adj = _padded_adj(cuda, b, n, sizes, seed=n + h).to(DT[dtype])
    gen = torch.Generator(device=cuda).manual_seed(n * h)
    xc, xo = (torch.randn((b, n, h), generator=gen, device=cuda).to(DT[dtype]) for _ in range(2))
    src = torch.randn((b, n), generator=gen, device=cuda).to(DT[dtype])
    dst = (2 * torch.randn((b, n), generator=gen, device=cuda)).to(DT[dtype])
    want_live = _ref_live(adj)
    (oc, oo), stats, live = fg._dual_fwd(xc, xo, adj, src, dst)
    assert stats.shape == (4, b, n) and torch.equal(live, want_live)
    pairs = list(zip((oc, oo), fg.fused_gcn_dense_att_dual_plain(xc, xo, adj, src, dst)))
    for negate in (False, True):
        out, _, live = fg._att_fwd(xc, adj, src, dst, negate)
        assert torch.equal(live, want_live)
        pairs.append((out, fg.fused_gcn_dense_att_plain(xc, adj, src, dst, negate)))
    for mode, transpose in (("plain", False), ("plain_t", True)):
        (out,), _, live = fg._fwd_launch("K17", mode, (xc,), adj)
        assert torch.equal(live, want_live)
        pairs.append((out, fg.fused_gcn_dense_plain(xc, adj, transpose)))
    torch.cuda.synchronize()
    atol, rtol = DUAL_TOL[dtype]
    for got, ref in pairs:
        assert got.dtype == DT[dtype] and got.shape == ref.shape
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def _ref_degree(adj, src, dst, mode):
    """The degree pass's statistics in its order: column s of row group w
    sums rows w, w + 8, ... in order, then group 0 adds groups 1..7 in
    order; deg^-1/2 and 1/deg of each branch, [2 branches, B, N]."""
    b, n, _ = adj.shape
    a = adj.float().clone()
    idx = torch.arange(n, device=adj.device)
    a[:, idx, idx] = 0.0
    if mode == "plain":
        ms = [a]
    else:
        sg = 1.0 / (1.0 + torch.exp(-(src.float()[:, None, :] + dst.float()[:, :, None])))
        mc = a * sg
        ms = {"dual": [mc, a - mc], "sig": [mc], "neg": [a * (1.0 - sg)]}[mode]
    out = []
    for m in ms:
        part = torch.zeros((8, b, n), device=adj.device)
        for r in range(n):
            part[r % 8] += m[:, r, :]
        t = part[0]
        for w in range(1, 8):
            t = t + part[w]
        deg = t + 1.0
        out += [torch.rsqrt(deg), 1.0 / deg]
    return torch.stack(out)


def _wide_batch(elt, n):
    """The smallest batch on which the degree pass reads 16 bytes a lane: its
    32 lanes' columns of a graph a block must give the card's SMs four
    blocks each (else a lane walks one column)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return -(-4 * sms // -(-n // (32 * 16 // elt)))


# both paths (16 bytes a lane, or a column a lane), rows read whole (N a
# multiple of the lane's elements) or element by element
@pytest.mark.parametrize("n,dtype,wide", [(512, "bfloat16", True), (516, "bfloat16", True),
                                          (384, "bfloat16", False), (700, "bfloat16", False),
                                          (512, "float32", True), (514, "float32", True),
                                          (700, "float32", False), (701, "float32", False)])
def test_degree_pass_matches_a_reference_in_its_order(cuda, n, dtype, wide):
    """Row reads on both paths, sigmoids only where a count is not 0: the
    statistics equal a column walk in the same order bit for bit, in every
    weight mode."""
    from cal_tpu_torch.ops import fused_gcn as fg

    b = _wide_batch(2 if dtype == "bfloat16" else 4, n) if wide else 3
    sizes = [(n, n // 3, 0)[i % 3] for i in range(b)]
    adj = _padded_adj(cuda, b, n, sizes, seed=n + int(wide)).to(DT[dtype])
    gen = torch.Generator(device=cuda).manual_seed(n + 1)
    x = torch.randn((b, n, 8), generator=gen, device=cuda).to(DT[dtype])
    src = torch.randn((b, n), generator=gen, device=cuda).to(DT[dtype])
    dst = (2 * torch.randn((b, n), generator=gen, device=cuda)).to(DT[dtype])
    for mode in ("dual", "sig", "neg", "plain"):
        xs = (x, x) if mode == "dual" else (x,)
        logits = () if mode == "plain" else (src, dst)
        _, stats, _ = fg._fwd_launch("degree", mode, xs, adj, *logits)
        assert torch.equal(stats, _ref_degree(adj, src, dst, mode)), mode


@pytest.mark.parametrize("n,dtype,wide", [(512, "bfloat16", True), (384, "bfloat16", False),
                                          (512, "float32", True), (384, "float32", False)])
def test_forward_keeps_non_finite_logits_to_their_edges(cuda, n, dtype, wide):
    """A slot without an edge may carry a non-finite logit: on both degree
    paths and in the aggregate a zero count forms no sigmoid, so the outputs,
    the statistics and the live map equal those of the same batch with that
    logit set to 0, bit for bit, in every weighted mode."""
    from cal_tpu_torch.ops import fused_gcn as fg

    b = _wide_batch(2 if dtype == "bfloat16" else 4, n) if wide else 3
    sizes = [(n - 40, n // 3, 0)[i % 3] for i in range(b)]
    adj = _padded_adj(cuda, b, n, sizes, seed=n + 7).to(DT[dtype])
    gen = torch.Generator(device=cuda).manual_seed(n + 8)
    x = torch.randn((b, n, 40), generator=gen, device=cuda).to(DT[dtype])
    src = torch.randn((b, n), generator=gen, device=cuda).to(DT[dtype])
    dst = (2 * torch.randn((b, n), generator=gen, device=cuda)).to(DT[dtype])
    bare = torch.arange(n, device=cuda)[None, :] >= torch.tensor(sizes, device=cuda)[:, None]
    bad = (src.masked_fill(bare, float("nan")), dst.masked_fill(bare, float("inf")))
    zero = (src.masked_fill(bare, 0.0), dst.masked_fill(bare, 0.0))
    for mode in ("dual", "sig", "neg"):
        xs = (x, x) if mode == "dual" else (x,)
        got, ref = (fg._fwd_launch("forward", mode, xs, adj, *lg) for lg in (bad, zero))
        for a, r in zip((*got[0], got[1], got[2]), (*ref[0], ref[1], ref[2])):
            assert torch.equal(a, r), mode


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backward_takes_the_forward_live_map(cuda, dtype):
    """The Functions hand the forward's statistics and live map to the
    backward, which then runs no degree pass (so no read of adj beyond its
    live tiles): the same bits as the backward alone, which builds its own,
    for the dual pair and K18B at both negates; one launch a call."""
    from cal_tpu_torch.ops import fused_gcn as fg

    adj = _padded_adj(cuda, 3, 700, (650, 40, 0), seed=3).to(DT[dtype])
    gen = torch.Generator(device=cuda).manual_seed(4)
    xc, xo, gc, go = (torch.randn((3, 700, 72), generator=gen, device=cuda).to(DT[dtype])
                      for _ in range(4))
    src = torch.randn((3, 700), generator=gen, device=cuda).to(DT[dtype])
    dst = (2 * torch.randn((3, 700), generator=gen, device=cuda)).to(DT[dtype])
    ref = fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc, go)
    leaves = [t.clone().requires_grad_() for t in (xc, xo, src, dst)]
    before = (fused_gcn_dense_att_dual.launches, fused_gcn_dense_att_dual_bwd.launches)
    oc, oo = fused_gcn_dense_att_dual(leaves[0], leaves[1], adj, leaves[2], leaves[3])
    torch.autograd.backward((oc, oo), (gc, go))
    assert (fused_gcn_dense_att_dual.launches, fused_gcn_dense_att_dual_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for leaf, r in zip(leaves, ref):
        assert torch.equal(leaf.grad, r)
    _, stats, live = fg._dual_fwd(xc, xo, adj, src, dst)
    handed = lambda: fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc, go, stats, live)
    for a, r in zip(handed(), ref):
        assert torch.equal(a, r)
    names = _device_kernels(handed)
    assert not any("degree_" in k for k in names), names
    names = _device_kernels(lambda: fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc, go))
    assert sum("degree_" in k for k in names) == 1, names
    for negate in (False, True):
        ref = fg.fused_gcn_dense_att_bwd(xc, adj, src, dst, gc, negate)
        leaves = [t.clone().requires_grad_() for t in (xc, src, dst)]
        before = (fg.fused_gcn_dense_att.launches, fg.fused_gcn_dense_att_bwd.launches)
        out = fg.fused_gcn_dense_att(leaves[0], adj, leaves[1], leaves[2], negate)
        out.backward(gc)
        assert (fg.fused_gcn_dense_att.launches, fg.fused_gcn_dense_att_bwd.launches) == (
            before[0] + 1, before[1] + 1)
        for leaf, r in zip(leaves, ref):
            assert torch.equal(leaf.grad, r)
    with pytest.raises(ValueError, match="together"):
        fused_gcn_dense_att_dual_bwd(xc, xo, adj, src, dst, gc, go, stats)


# ---- row 9: multi-head coefficient SpMM (K19/K19T/K20), row 14 (K21) ------
@pytest.mark.parametrize("v,e,hub,pad,heads,h,dtype", [
    (300, 900, 0, 0, 2, 32, "float32"),
    (1000, 4000, 700, 300, 4, 128, "bfloat16"),
    (1000, 4000, 700, 300, 4, 128, "float32"),
    (2048, 6000, 3000, 5000, 8, 64, "bfloat16"),
    (512, 1500, 40, 33, 8, 256, "float32"),
] + [(v, e, hub, pad, heads, h, dt) for (v, e, hub, pad, h, dt), heads in
     zip(WALK_CASES, (2, 8, 4, 8, 2, 4, 8, 8))])
def test_coo_mh_kernels_match_plain(cuda, v, e, hub, pad, heads, h, dtype):
    from cal_tpu_torch.ops import coo_spmm as coo

    g = _sparse_graph(cuda, v, e, hub, pad, seed=v + h + heads, isolated=7)
    gen = torch.Generator(device=cuda).manual_seed(v * h + heads)
    x = torch.randn((v, h), generator=gen, device=cuda).to(DT[dtype])
    gout = torch.randn((v, h), generator=gen, device=cuda)
    coef = torch.rand((g.senders.shape[0], heads), generator=gen, device=cuda)
    coef = coef * (g.edge_mask & (g.senders != g.receivers))[:, None]
    counters = (coo.coo_spmm_mh, coo.coo_spmm_mh_t, coo.coo_sddmm_mh)
    before = [k.launches for k in counters]
    for got, ref in ((coo._coo_spmm_mh_fwd(x, coef, g, heads), coo.coo_spmm_plain(x, coef, g)),
                     (coo.coo_spmm_mh_t(gout, coef, g, heads),
                      coo.coo_spmm_t_plain(gout, coef, g)),
                     (coo.coo_sddmm_mh(x, gout, g, heads),
                      coo.coo_sddmm_plain(x, gout, g, heads))):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, atol=COO_TOL[0], rtol=COO_TOL[1])
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(counters, before)] == [1, 1, 1]


def test_coo_mh_function_matches_autograd_and_launches(cuda):
    from cal_tpu_torch.ops import coo_spmm as coo

    g = _sparse_graph(cuda, 1000, 4000, 700, 300, seed=12, isolated=7)
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((1000, 128), generator=gen, device=cuda)
    coef = torch.randn((g.senders.shape[0], 4), generator=gen, device=cuda)
    cot = torch.randn((1000, 128), generator=gen, device=cuda)
    a = [t.clone().requires_grad_() for t in (x, coef)]
    b = [t.clone().requires_grad_() for t in (x, coef)]
    got = torch.autograd.grad((coo.coo_spmm_mh(*a, g, 4) * cot).sum(), a)
    ref = torch.autograd.grad((coo.coo_spmm_plain(*b, g) * cot).sum(), b)
    for u, w in zip(got, ref):
        torch.testing.assert_close(u, w, atol=COO_TOL[0], rtol=COO_TOL[1])
    assert torch.equal(coo.coo_spmm_mh(x, coef, g, 4), coo.coo_spmm_mh(x, coef, g, 4))
    assert torch.equal(coo.coo_sddmm_mh(x, cot, g, 4), coo.coo_sddmm_mh(x, cot, g, 4))


# E % 4 != 0 (element-wise reads), more planes than one batch of four, the
# walk's degree classes, a padded run of many chunks with dead values left
# random (K21 reads every edge)
@pytest.mark.parametrize("v,e,hub,pad,k", [
    (300, 900, 0, 0, 1),
    (300, 901, 0, 2, 2),
    (1000, 4000, 700, 300, 3),
    (2048, 6000, 3000, 5000, 4),
    (3000, 6000, (32, 33, 2100), 2500, 6),
    (3000, 6000, (32, 33, 2100), 300, 4),
])
def test_segment_max_kernel_exact(cuda, v, e, hub, pad, k):
    """K21 bit for bit against its twin, in one kernel launch a call that
    leaves the arrival counters at 0."""
    from cal_tpu_torch.ops import coo_spmm as coo

    g = _sparse_graph(cuda, v, e, hub, pad, seed=v + k, isolated=7)
    gen = torch.Generator(device=cuda).manual_seed(v + k)
    vals = torch.randn((k, g.senders.shape[0]), generator=gen, device=cuda)
    if k != 6:
        vals = torch.where(g.edge_mask[None], vals, torch.full_like(vals, -1e30))
    before = coo.segment_max.launches
    got = coo.segment_max(vals, g)
    torch.cuda.synchronize()
    assert coo.segment_max.launches == before + 1
    assert torch.equal(got, coo.segment_max_plain(vals, g))
    # receivers without an edge (node V-1 holds the dead edges, random at k = 6)
    assert ((got[:, -7:-1] if k == 6 else got[:, -7:]) == -1e30).all()
    assert not g.recv.arrivals.any()
    names = _device_kernels(lambda: coo.segment_max(vals, g))
    assert len(names) == 1 and "csr_reduce_kernel" in names[0], names
    assert torch.equal(coo.segment_max(vals, g), got) and not g.recv.arrivals.any()
    with pytest.raises(ValueError):
        coo.segment_max(vals.double(), g)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_gat_seed_buffer_matches_int_seed(cuda, dtype):
    """The flash kernels read the dropout seed from a device buffer: a
    ``seed_buffer`` gives the int seed's bits, forward and backward, and a
    buffer rewritten between launches changes the mask."""
    from cal_tpu_torch.ops.flash_gat import seed_buffer

    ti, tj, counts, xh, g = _flash_inputs(cuda, 3, 256, 4, 32, dtype, seed=7)
    seed = 0xFEDC_BA98_7654_3210
    buf = seed_buffer(seed, cuda)
    a = flash_gat_fwd(ti, tj, counts, xh, seed, 0.2)
    b = flash_gat_fwd(ti, tj, counts, xh, buf, 0.2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ga = flash_gat_bwd(ti, tj, counts, xh, a[1], a[2], g, seed, 0.2)
    gb = flash_gat_bwd(ti, tj, counts, xh, a[1], a[2], g, buf, 0.2)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))
    buf.fill_(12345)
    c = flash_gat_fwd(ti, tj, counts, xh, buf, 0.2)
    assert all(torch.equal(x, y) for x, y in zip(c, flash_gat_fwd(ti, tj, counts, xh, 12345,
                                                                   0.2)))
    assert not torch.equal(c[0], a[0])
    with pytest.raises(ValueError):
        flash_gat_fwd(ti, tj, counts, xh, buf.cpu(), 0.2)


@pytest.mark.parametrize("model", ["CausalGCN", "CausalGAT", "GCN"])
def test_captured_epoch_matches_eager_steps(cuda, model):
    """The device-side epoch (one CUDA graph of the step after its first,
    eager, call) against the eager steps from one state, bit for bit:
    parameters, BatchNorm statistics and each epoch's sums; the counted
    launches agree."""
    from cal_tpu_torch.data.loader import Loader
    from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
    from cal_tpu_torch.train import steps as st
    from cal_tpu_torch.train.graphs import launch_counters
    from cal_tpu_torch.train.optim import cosine_lr
    from cal_tpu_torch.utils.config import Config

    cfg = Config(model=model, hidden=32, layers=2, batch_size=16, dtype="bfloat16", seed=5)
    ds = generate_synthetic_dataset(data_num=16, seed=5)
    train, _, _, _ = dataset_bias_split(ds, bias=0.7, total=64, seed=0)
    loader = Loader(train, 16, shuffle=True, seed=5)
    stacks = [st.ship(st.stack_batches_host(list(loader.host_batches())), cuda)
              for _ in range(3)]
    schedule = cosine_lr(cfg.lr, cfg.min_lr, 10, len(loader))
    out = {}
    for kind in ("eager", "captured"):
        state = st.init_state(cfg, train[0].x.shape[1], cfg.num_classes, cuda)
        if model == "GCN":
            step = st.make_baseline_train_step(state, schedule, cfg.seed)
            epoch = st.make_baseline_train_epoch(state, schedule, cfg.seed)
        else:
            args = (state, schedule, cfg.c, cfg.o, cfg.co, cfg.with_random, cfg.seed)
            step, epoch = st.make_causal_train_step(*args), st.make_causal_train_epoch(*args)
        counters = launch_counters()
        before = {f: f.launches for f in counters}
        sums = []
        for stacked in stacks:
            if kind == "eager":
                m = None
                for s in range(stacked.steps):
                    m = step.on_device(stacked.at(s), m)
            else:
                m = epoch(stacked)
            sums.append(m.tolist())
        out[kind] = (state, sums, {f.__name__: f.launches - before[f] for f in counters})
    (se, sums_e, le), (sc, sums_c, lc) = out["eager"], out["captured"]
    assert sums_e == sums_c and le == lc
    assert all(torch.equal(a, b) for a, b in zip(se.model.parameters(), sc.model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(se.model.buffers(), sc.model.buffers()))


# ---- the walk's heavy lists at a fixed capacity (captured steps) ----------
def _cut(csr):
    """The CSR with its heavy lists and arrival counters cut to the live
    count (at least one entry) and chunk_row to the live chunks: a launch's
    grid is then the size the batch needs, as before the lists had a fixed
    capacity."""
    n = max(csr.n_heavy, 1)
    return dataclasses.replace(csr, chunk_row=csr.chunk_row[:csr.num_chunks].clone(),
                               heavy_chunks=csr.heavy_chunks[:n].clone(),
                               heavy_masked=csr.heavy_masked[:n].clone(),
                               arrivals=csr.arrivals[:n].clone())


def _walk_outputs(g, x, src, dst, tj, ti, dD, w, seed, rate=0.2):
    """K1 (the pair's degrees), the plain conv's degree, K2, K3 and K5 / K6
    (the pair aggregate and its backward), K8-K10 (the GAT aggregate's
    kernels, dropout from ``seed``), K11 and K21 over g."""
    from cal_tpu_torch.ops import coo_spmm as coo
    from cal_tpu_torch.ops import gat_sparse as gs
    from cal_tpu_torch.ops import spmm

    out = list(spmm.pair_sender_degree(src, dst, g, norm=True))
    out += list(spmm.plain_sender_degree(g))
    xc = x.detach().requires_grad_()
    oc, oo = spmm.gcn_aggregate_sparse_pair(xc, x, src, dst, g)
    out += [oc, oo, spmm.gcn_aggregate_sparse_plain(x, g)]
    out += list(torch.autograd.grad((oc.float() ** 2).sum() + oo.float().sum(), xc))
    m, den = gs.gat_row_stats(tj, ti, g)
    xf = x.float()
    out += [m, den, gs.gat_coef_spmm(x, tj, ti, m, seed, rate, g),
            gs.gat_coef_spmm_t(xf, tj, ti, m, seed, rate, g),
            *gs.gat_sddmm_chain(x, w, tj, ti, m, dD, seed, rate, g)]
    out += [coo.coo_spmm(x, g.edge_mask.float(), g),
            coo.segment_max(dD[:, g.senders.long()].contiguous(), g)]
    return out


def _walk_inputs(device, v, h=128, heads=4, seed=3):
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=gen, device=device)
    return (rand(v, h).to(torch.bfloat16), rand(v).to(torch.bfloat16),
            rand(v).to(torch.bfloat16), rand(heads, v), rand(heads, v), rand(heads, v),
            rand(v, h))


def test_walk_kernels_on_a_padded_csr_equal_the_cut_launch(cuda):
    """Every walk kernel family launched over both CSRs in their padded form
    (heavy lists of heavy_capacity(E) entries, the live count read on the
    card, the grid sized for the capacity) gives the bits of the launch over
    the lists cut to their live prefixes, and leaves the arrival counters
    at 0."""
    from cal_tpu_torch.ops.flash_gat import seed_buffer

    v = 3000
    g = _sparse_graph(cuda, v, 6000, (32, 33, 2100), 2500, seed=41, isolated=7)
    assert g.recv.heavy_chunks.shape[0] > g.recv.n_heavy > 0
    cut = dataclasses.replace(g, recv=_cut(g.recv), send=_cut(g.send))
    ins = _walk_inputs(cuda, v)
    seed = seed_buffer(0x0123_4567_89AB_CDEF, cuda)
    got = _walk_outputs(g, *ins, seed)
    ref = _walk_outputs(cut, *ins, seed)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, ref, strict=True)):
        assert torch.equal(a, b), i
    for c in (g.recv, g.send, cut.recv, cut.send):
        assert not c.arrivals.any()


def _two_budget_graphs(device):
    """Two batches of one shape (V 3,000, E 10,630) whose heavy lists differ:
    hubs of 2,100 and 1,000 edges, padded runs of 300 and 2,498 edges."""
    a = _sparse_graph(device, 3000, 6000, (32, 33, 2100), 300, seed=51, isolated=7)
    b = _sparse_graph(device, 3000, 6000, (33, 33, 1000), 2498, seed=52, isolated=7)
    assert [t.shape for t in a.leaves()] == [t.shape for t in b.leaves()]
    assert (a.recv.n_heavy, a.send.n_heavy) != (b.recv.n_heavy, b.send.n_heavy)
    return a, b


def test_captured_walk_replays_on_the_batch_in_its_buffers(cuda):
    """K1 and K8-K10 captured in a CUDA graph over static buffers holding
    batch A, then replayed after batch B is copied into them: the replay
    gives the eager launches' bits on B (the heavy count and the dropout
    seed are read on the card at each replay), then A's again, and every
    arrival counter is 0 after each replay."""
    from cal_tpu_torch.ops import gat_sparse as gs
    from cal_tpu_torch.ops import spmm
    from cal_tpu_torch.ops.flash_gat import seed_buffer

    a, b = _two_budget_graphs(cuda)
    x, src, dst, tj, ti, dD, w = _walk_inputs(cuda, a.num_nodes)
    static = a.with_leaves([t.clone() for t in a.leaves()])
    seed = seed_buffer(11, cuda)

    def run(g):
        m, den = gs.gat_row_stats(tj, ti, g)
        return [*spmm.pair_sender_degree(src, dst, g, norm=True), m, den,
                gs.gat_coef_spmm(x, tj, ti, m, seed, 0.2, g),
                gs.gat_coef_spmm_t(w, tj, ti, m, seed, 0.2, g),
                *gs.gat_sddmm_chain(x, w, tj, ti, m, dD, seed, 0.2, g)]

    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        run(static)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = run(static)
    for g, s in ((b, 23), (a, 11), (b, 11)):
        for dst_t, src_t in zip(static.leaves(), g.leaves()):
            dst_t.copy_(src_t)
        seed.fill_(s)
        graph.replay()
        torch.cuda.synchronize()
        assert not static.recv.arrivals.any() and not static.send.arrivals.any()
        want = run(g)
        torch.cuda.synchronize()
        for i, (got, ref) in enumerate(zip(out, want, strict=True)):
            assert torch.equal(got, ref), (s, i)


def test_sparse_and_edge_keep_bits_from_a_seed_buffer(cuda):
    """K9, K9T and K10 draw the same keep bits from a seed buffer as from
    the seed's two words, and the edge GAT's forward and backward the same
    as from the int seed; a buffer rewritten between launches draws the new
    seed's bits."""
    from cal_tpu_torch.ops import gat_sparse as gs
    from cal_tpu_torch.ops.edge_gat import edge_gat_bwd, edge_gat_fwd
    from cal_tpu_torch.ops.flash_gat import seed_buffer
    from cal_tpu_torch.ops.gat import seed_words

    g = _sparse_graph(cuda, 1000, 4000, 700, 300, seed=61, isolated=7)
    xh, _, ti, tj, w, dD = _gat_inputs(cuda, 1000, 4, 128, "bfloat16", 61)
    x = xh.reshape(1000, 128)
    m = gs.gat_row_stats(tj, ti, g)[0]
    seed = 0xFEDC_BA98_7654_3210
    buf = seed_buffer(seed, cuda)

    def sparse(words):
        return [gs.gat_coef_spmm(x, tj, ti, m, words, 0.2, g),
                gs.gat_coef_spmm_t(w, tj, ti, m, words, 0.2, g),
                *gs.gat_sddmm_chain(x, w, tj, ti, m, dD, words, 0.2, g)]

    for a, b in zip(sparse(seed_words(seed)), sparse(buf), strict=True):
        assert torch.equal(a, b)
    ef, eti, etj, exh, eg = _edge_inputs(cuda, 4, 384, 4, 128, 900, 1500, "bfloat16", 61)

    def edge(s):
        out, stats = edge_gat_fwd(eti, etj, exh, ef, s, 0.2, with_stats=True)
        return [out, *edge_gat_bwd(eti, etj, exh, ef, eg, s, 0.2, stats=stats)]

    for a, b in zip(edge(seed), edge(buf), strict=True):
        assert torch.equal(a, b)
    buf.fill_(12345)
    for a, b in zip(sparse(seed_words(12345)), sparse(buf), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(edge(12345), edge(buf), strict=True):
        assert torch.equal(a, b)
    assert not torch.equal(edge(seed)[0], edge(buf)[0])


@pytest.mark.parametrize("model", ["CausalGCN", "CausalGAT", "GIN"])
def test_sparse_captured_epoch_matches_eager_steps(cuda, model):
    """On the sparse layout (packed batches, so pad steps in each stack, and
    batches whose heavy-chunk counts differ), the device-side epoch against
    the eager steps from one state, bit for bit: parameters, BatchNorm
    statistics and each epoch's sums; the counted launches agree."""
    from cal_tpu_torch.data.loader import Loader, compute_budgets
    from cal_tpu_torch.data.reddit_synthetic import reddit_graphs
    from cal_tpu_torch.train import steps as st
    from cal_tpu_torch.train.graphs import launch_counters
    from cal_tpu_torch.train.optim import cosine_lr
    from cal_tpu_torch.utils.config import Config

    cfg = Config(model=model, hidden=32, layers=2, batch_size=8, dtype="bfloat16", seed=5,
                 num_classes=2)
    graphs = reddit_graphs(40, seed=5, feat=4)
    loader = Loader(graphs, 8, shuffle=True, seed=5, layout="sparse",
                    budgets=compute_budgets(graphs, 8, "sparse", pack=True))
    stacks = [st.ship(st.stack_batches_host(list(loader.host_batches())), cuda)
              for _ in range(3)]
    assert all(not s.real.all() for s in stacks)
    assert all(len(set(s.batch.recv.heavy_count[:, 0].tolist())) > 1 for s in stacks)
    schedule = cosine_lr(cfg.lr, cfg.min_lr, 10, loader.schedule_steps)
    out = {}
    for kind in ("eager", "captured"):
        state = st.init_state(cfg, graphs[0].x.shape[1], cfg.num_classes, cuda)
        if model == "GIN":
            step = st.make_baseline_train_step(state, schedule, cfg.seed)
            epoch = st.make_baseline_train_epoch(state, schedule, cfg.seed)
        else:
            args = (state, schedule, cfg.c, cfg.o, cfg.co, cfg.with_random, cfg.seed)
            step, epoch = st.make_causal_train_step(*args), st.make_causal_train_epoch(*args)
        counters = launch_counters()
        before = {f: f.launches for f in counters}
        sums = []
        for stacked in stacks:
            if kind == "eager":
                m = None
                for s in range(stacked.steps):
                    if stacked.real[s]:
                        m = step.on_device(stacked.at(s), m)
            else:
                m = epoch(stacked)
            sums.append(m.tolist())
        out[kind] = (state, sums, {f.__name__: f.launches - before[f] for f in counters})
    (se, sums_e, le), (sc, sums_c, lc) = out["eager"], out["captured"]
    assert sums_e == sums_c and le == lc
    assert all(torch.equal(a, b) for a, b in zip(se.model.parameters(), sc.model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(se.model.buffers(), sc.model.buffers()))
