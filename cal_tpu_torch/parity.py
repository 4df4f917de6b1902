"""On-card parity of the port's kernels against its plain-op references.

    python -m cal_tpu_torch.parity [--device cpu]

Counterpart of benchmarks/parity_tpu.py, section for section and in the same
order: each section runs a kernel path of the port (forward and gradients)
on the card and holds it against the port's plain PyTorch reference of the
same function, at parity_tpu.py's sizes, seeds and tolerances (max-abs error
over max-abs reference, the script's ``rel-max-err``).  The CPU tests call
the sections at small sizes through their size arguments; ``--device cpu``
runs them at full size on the kernels' plain twins.  Exits non-zero listing
the failures.

  * flash-GAT (ops/flash_gat.py) vs gat_aggregate_dense, with the dropout
    statistics (mean preservation, replay determinism);
  * edge-formulated dense GAT (ops/edge_gat.py) vs gat_aggregate_dense;
  * the dense masked GCN kernels (ops/fused_gcn.py: rows 4, 3 and the dual
    pair) vs gcn_aggregate_dense with materialized weights;
  * the adjacency build (ops/adj_build.py) vs a scatter-add, exact;
  * the weighted sparse GCN over the coefficient SpMM (ops/gcn.py
    gcn_aggregate_sparse_coo, K11/K11T/K12) vs gcn_aggregate_sparse, with
    the SDDMM edge-weight gradient;
  * the sigmoid-weighted sparse aggregate (row 12), the pair aggregate
    against two singles, the unweighted sparse aggregate;
  * the multi-head SpMM (ops/gat.py gat_aggregate_sparse_mh, row 9) vs
    gat_aggregate_sparse, with dropout from one seeded generator;
  * the fused sparse GAT chain (ops/gat_sparse.py) vs gat_aggregate_sparse;
  * the sparse pool (ops/pool.py) vs a segment sum.

The f32 references run in full f32 on the card: TF32 is off for matmuls
and cuDNN.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from cal_tpu_torch.graph import GraphBatch, sparse_batch
from cal_tpu_torch.ops.adj_build import adj_build
from cal_tpu_torch.ops.edge_gat import edge_gat_dense_flat
from cal_tpu_torch.ops.flash_gat import flash_gat_dense
from cal_tpu_torch.ops.fused_gcn import (
    SigmoidEdgeWeight,
    fused_gcn_dense,
    fused_gcn_dense_att,
    fused_gcn_dense_att_dual,
)
from cal_tpu_torch.ops.gat import (
    gat_aggregate_dense,
    gat_aggregate_sparse,
    gat_aggregate_sparse_mh,
)
from cal_tpu_torch.ops.gat_sparse import gat_aggregate_sparse_fused
from cal_tpu_torch.ops.gcn import (
    gcn_aggregate_dense,
    gcn_aggregate_sparse,
    gcn_aggregate_sparse_coo,
)
from cal_tpu_torch.ops.pool import segment_pool
from cal_tpu_torch.ops.spmm import (
    gcn_aggregate_sparse_pair,
    gcn_aggregate_sparse_plain,
    gcn_aggregate_sparse_sigmoid,
)
from cal_tpu_torch.train.causal import resolve_device

class Checks:
    """The records of one parity run: every check, and the failed ones."""

    def __init__(self):
        self.records: list[dict] = []
        self.failures: list[str] = []
        self._section = ""

    def section(self, title):
        self._section = title
        print(f"{title}:")

    def _record(self, name, ok, **fields):
        if not ok:
            self.failures.append(name)
        self.records.append({"section": self._section, "name": name, **fields, "ok": ok})

    def check(self, name, got, want, tol):
        """Record max|got - want| / max|want| against ``tol``."""
        got, want = got.detach().float(), want.detach().float()
        err = float((got - want).abs().max() / (want.abs().max() + 1e-12))
        self._record(name, err <= tol, rel_max_err=err, tol=tol)
        print(f"  {name:28s} rel-max-err {err:.2e}  ({'ok' if err <= tol else 'FAIL'}, tol {tol:g})")

    def check_range(self, name, value, lo, hi):
        """Record a statistic that must lie in (lo, hi)."""
        ok = lo < value < hi
        self._record(name, ok, value=value, range=[lo, hi])
        print(f"  {name:28s} {value:.4f}  ({'ok' if ok else 'FAIL'}, want ~1)")


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)


def _grads(fn, args):
    """Gradients of sum(fn(*args) ** 2) with respect to every argument."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    return torch.autograd.grad((fn(*leaves).float() ** 2).sum(), leaves)


def _sparse_graph(senders, receivers, edge_mask, v, device) -> GraphBatch:
    """A one-graph GraphBatch over the given receiver-sorted edges."""
    return sparse_batch(np.zeros((v, 1), np.float32), senders, receivers, edge_mask,
                        np.ones(v, bool), np.zeros(v, np.int32), np.zeros(1, np.int32),
                        np.ones(1, bool)).to(device)


def _random_edges(rng, v, e):
    senders = rng.integers(0, v, size=e).astype(np.int32)
    receivers = np.sort(rng.integers(0, v, size=e)).astype(np.int32)
    edge_mask = np.arange(e) < int(e * 0.9)
    return senders, receivers, edge_mask


def gat_parity(device, checks, B=8, N=232, heads=4, d=32):
    checks.section("flash-GAT vs gat_aggregate_dense (f32)")
    rng = np.random.default_rng(0)
    xh = _t(rng.standard_normal((B, N, heads, d)), device)
    adj_np = (rng.random((B, N, N)) < 0.02).astype(np.float32)
    adj = _t(adj_np + adj_np.transpose(0, 2, 1), device)
    att_dst = _t(rng.standard_normal((heads, d)), device) * 0.1
    att_src = _t(rng.standard_normal((heads, d)), device) * 0.1

    ref = gat_aggregate_dense(xh, adj, att_dst, att_src)
    got = flash_gat_dense(xh, adj, att_dst, att_src)
    checks.check("fwd", got, ref, 2e-3)

    gr = _grads(lambda x, ad, as_: gat_aggregate_dense(x, adj, ad, as_), (xh, att_dst, att_src))
    gf = _grads(lambda x, ad, as_: flash_gat_dense(x, adj, ad, as_), (xh, att_dst, att_src))
    for nm, a, b in zip(("grad dxh", "grad datt_dst", "grad datt_src"), gr, gf):
        checks.check(nm, b, a, 2e-3)

    # dropout statistics (rate 0.2 -> keep 0.8, inverted scaling keeps mean)
    gotd = flash_gat_dense(xh, adj, att_dst, att_src, 0.2, 3)
    checks.check_range("dropout mean ratio", float(gotd.sum() / ref.sum()), 0.9, 1.1)
    ld = lambda x: flash_gat_dense(x, adj, att_dst, att_src, 0.2, 3)
    (g1,), (g2,) = _grads(ld, (xh,)), _grads(ld, (xh,))
    checks.check("dropout grad replay", g2, g1, 0.0)


def edge_gat_parity(device, checks, B=64, N=128, H=4, D=32, EG=256):
    checks.section("edge-GAT (edge-formulated dense) vs gat_aggregate_dense")
    rng = np.random.default_rng(11)
    flat = []
    for g in range(B - 1):
        e = rng.integers(8, EG - 16)
        r = rng.integers(0, N - 4, e)
        s = rng.integers(0, N - 4, e)
        flat.append((g * N + r) * N + s)
    flat = np.sort(np.concatenate(flat))
    ef = np.full(B * EG, B * N * N, np.int32)
    ef[:len(flat)] = flat
    adj = np.zeros((B * N * N,), np.float32)
    np.add.at(adj, ef[ef < B * N * N], 1.0)
    adj = _t(adj.reshape(B, N, N), device)
    ef = _t(ef, device, torch.int32)
    xh = _t(rng.standard_normal((B, N, H, D)), device)
    att_dst = _t(rng.standard_normal((H, D)) * 0.3, device)
    att_src = _t(rng.standard_normal((H, D)) * 0.3, device)

    def edge(x, ad, asr, rate=0.0, seed=None):
        flat_x = x.reshape(B, N, H * D)
        return edge_gat_dense_flat(flat_x, ef, ad, asr, rate, seed).reshape(B, N, H, D)

    ref = lambda x: gat_aggregate_dense(x, adj, att_dst, att_src)
    got = lambda x: edge(x, att_dst, att_src)
    checks.check("fwd f32", got(xh), ref(xh), 1e-2)
    (gr,), (gf,) = _grads(ref, (xh,)), _grads(got, (xh,))
    checks.check("grad dxh f32", gf, gr, 1e-2)
    got16 = edge(xh.bfloat16(), att_dst.bfloat16(), att_src.bfloat16())
    checks.check("fwd bf16", got16, ref(xh), 0.05)
    drop = lambda x: edge(x, att_dst, att_src, 0.2, 3)
    ratio = float(drop(xh).abs().mean() / got(xh).abs().mean())
    checks.check_range("dropout mean ratio", ratio, 0.8, 1.25)
    (gd1,), (gd2,) = _grads(drop, (xh,)), _grads(drop, (xh,))
    checks.check("dropout grad replay", gd1, gd2, 0.0)


def gcn_dense_parity(device, checks, B=8, N=248, H=128):
    checks.section("fused dense GCN vs gcn_aggregate_dense (f32 + bf16)")
    rng = np.random.default_rng(2)
    adj_np = (rng.random((B, N, N)) < 0.02).astype(np.float32)
    adj_np += (rng.random((B, N, N)) < 0.002)       # duplicate edges
    adj_np[B - 1] = 0.0                             # padded graph slot
    adj = _t(adj_np, device)
    x = _t(rng.standard_normal((B, N, H)), device)
    src = _t(rng.standard_normal((B, N)), device)
    dst = _t(rng.standard_normal((B, N)), device)

    checks.check("unweighted fwd", fused_gcn_dense(x, adj), gcn_aggregate_dense(x, adj), 1e-5)
    (gr,), (gf,) = (_grads(lambda a: gcn_aggregate_dense(a, adj), (x,)),
                    _grads(lambda a: fused_gcn_dense(a, adj), (x,)))
    checks.check("unweighted grad dx", gf, gr, 1e-5)

    def weighted(a, s, d, negate):
        return gcn_aggregate_dense(a, adj, SigmoidEdgeWeight(s, d, negate).materialize())

    for negate in (False, True):
        tag = "1-sig" if negate else "sig"
        checks.check(f"att({tag}) fwd", fused_gcn_dense_att(x, adj, src, dst, negate),
              weighted(x, src, dst, negate), 1e-5)
        gr = _grads(lambda a, s, d: weighted(a, s, d, negate), (x, src, dst))
        gf = _grads(lambda a, s, d: fused_gcn_dense_att(a, adj, s, d, negate), (x, src, dst))
        # parity_tpu.py's hardware tolerance (1e-2: the TPU's reduced-precision
        # f32 matmuls); here both sides run full f32, so the reading is the
        # kernel's own error
        for nm, a, b in zip((f"att({tag}) dx", f"att({tag}) dsrc", f"att({tag}) ddst"), gr, gf):
            checks.check(nm, b, a, 1e-2)

    # dual-branch kernel (both masked convs fused)
    xo = torch.tanh(x)
    oc, oo = fused_gcn_dense_att_dual(x, xo, adj, src, dst)
    checks.check("dual fwd (c)", oc, weighted(x, src, dst, False), 1e-5)
    checks.check("dual fwd (o)", oo, weighted(xo, src, dst, True), 1e-5)

    def lrd(xc, xo, s, d):
        return torch.stack([weighted(xc, s, d, False), weighted(xo, s, d, True)])

    def lfd(xc, xo, s, d):
        return torch.stack(fused_gcn_dense_att_dual(xc, xo, adj, s, d))

    grd, gfd = _grads(lrd, (x, xo, src, dst)), _grads(lfd, (x, xo, src, dst))
    for nm, a, b in zip(("dual dxc", "dual dxo", "dual dsrc", "dual ddst"), grd, gfd):
        checks.check(nm, b, a, 1e-2)

    # bf16 storage mode (production config): tolerance at bf16 resolution
    xb, ab = x.bfloat16(), adj.bfloat16()
    checks.check("unweighted fwd bf16", fused_gcn_dense(xb, ab), gcn_aggregate_dense(xb, ab), 2e-2)


def adj_build_parity(device, checks, B=128, N=256, EG=1152, slots=128 * 1024):
    """The adjacency build vs a scatter-add: integer counts must match
    EXACTLY (tol 0)."""
    checks.section("adj_build vs scatter")
    rng = np.random.default_rng(5)
    flat = []
    for g in range(B - 1):                      # last slot padded (empty)
        e = rng.integers(1, EG - 1)
        r = rng.integers(0, N, e)
        s = rng.integers(0, N, e)
        flat.append((g * N + r) * N + s)
    flat = np.sort(np.concatenate(flat))
    ef = np.full(slots, B * N * N, np.int32)
    ef[:len(flat)] = flat
    ef = _t(ef, device, torch.int32)
    real = ef < B * N * N
    want = torch.zeros(B * N * N, device=device).index_add_(
        0, ef[real].long(), torch.ones(int(real.sum()), device=device)).reshape(B, N, N)
    checks.check("counts f32 (exact)", adj_build(ef, B, N, torch.float32), want, 0.0)
    checks.check("counts bf16 (exact)", adj_build(ef, B, N, torch.bfloat16), want, 0.0)


def spmm_parity(device, checks, V=4096, E=65536, H=128):
    checks.section("coefficient SpMM vs gcn_aggregate_sparse (f32)")
    rng = np.random.default_rng(1)
    senders, receivers, edge_mask = _random_edges(rng, V, E)
    x = _t(rng.standard_normal((V, H)), device)
    w = _t(rng.random(E), device)
    g = _sparse_graph(senders, receivers, edge_mask, V, device)
    s, r, m = g.senders, g.receivers, g.edge_mask

    ref_fn = lambda x, w: gcn_aggregate_sparse(x, s, r, m, w)
    got_fn = lambda x, w: gcn_aggregate_sparse_coo(x, g, w)
    checks.check("fwd", got_fn(x, w), ref_fn(x, w), 1e-4)
    gr, gf = _grads(ref_fn, (x, w)), _grads(got_fn, (x, w))
    checks.check("grad dx", gf[0], gr[0], 1e-4)
    checks.check("grad dw (SDDMM)", gf[1], gr[1], 1e-4)


# the sparse sections' modes: parity_tpu.py's f32 and bf16 tile plans become
# f32 and bf16 features here (the port has no tile plans), with their
# (forward, gradient) tolerances
_MODES = (("f32", torch.float32, 1e-4, 1e-2), ("bf16", torch.bfloat16, 2e-2, 5e-2))


def spmm_sigmoid_fused_parity(device, checks, V=2048, E=8192, H=128):
    """The sigmoid-weighted sparse aggregate (row 12) vs the materialized-
    weight reference: fwd + grads in x/src/dst, f32 and bf16 features."""
    checks.section("fused sigmoid SpMM vs gcn_aggregate_sparse")
    rng = np.random.default_rng(7)
    senders, receivers, edge_mask = _random_edges(rng, V, E)
    x = _t(rng.standard_normal((V, H)), device)
    src = _t(rng.standard_normal(V), device)
    dst = _t(rng.standard_normal(V), device)
    g = _sparse_graph(senders, receivers, edge_mask, V, device)
    s, r = g.senders.long(), g.receivers.long()

    def ref_fn(x, src, dst):
        w = torch.sigmoid(src[s] + dst[r])
        return gcn_aggregate_sparse(x, g.senders, g.receivers, g.edge_mask, w)

    for prec, dt, ftol, gtol in _MODES:
        got_fn = lambda x, src, dst: gcn_aggregate_sparse_sigmoid(x.to(dt), src, dst, g)
        checks.check(f"fwd [{prec}]", got_fn(x, src, dst), ref_fn(x, src, dst), ftol)
        gr, gg = _grads(ref_fn, (x, src, dst)), _grads(got_fn, (x, src, dst))
        for name, a, b in zip(("dx", "dsrc", "ddst"), gg, gr):
            checks.check(f"grad {name} [{prec}]", a, b, gtol)


def spmm_sigmoid_pair_parity(device, checks, V=2048, E=8192, H=128):
    """The pair aggregate vs two single sigmoid aggregates: fwd + grads in
    xc/xo/src/dst, f32 and bf16 (features and logits)."""
    checks.section("pair sigmoid SpMM vs two singles")
    rng = np.random.default_rng(23)
    senders, receivers, edge_mask = _random_edges(rng, V, E)
    xc = _t(rng.standard_normal((V, H)), device)
    xo = _t(rng.standard_normal((V, H)), device)
    src = _t(rng.standard_normal(V), device)
    dst = _t(rng.standard_normal(V), device)
    g = _sparse_graph(senders, receivers, edge_mask, V, device)
    for prec, dt, ftol, gtol in _MODES:
        args = tuple(a.to(dt) for a in (xc, xo, src, dst))

        def singles(xc_, xo_, s_, d_):
            return (gcn_aggregate_sparse_sigmoid(xc_, s_, d_, g, False),
                    gcn_aggregate_sparse_sigmoid(xo_, s_, d_, g, True))

        # loss sum(oc^2) + 3 sum(oo^2), as parity_tpu.py's
        loss = lambda f: lambda *a: torch.stack([f(*a)[0].float(), 3.0 ** 0.5 * f(*a)[1].float()])
        pair = lambda *a: gcn_aggregate_sparse_pair(*a, g)
        got, ref = pair(*args), singles(*args)
        checks.check(f"fwd c [{prec}]", got[0], ref[0], ftol)
        checks.check(f"fwd o [{prec}]", got[1], ref[1], ftol)
        gg, gr = _grads(loss(pair), args), _grads(loss(singles), args)
        for name, a, b in zip(("dxc", "dxo", "dsrc", "ddst"), gg, gr):
            checks.check(f"grad {name} [{prec}]", a, b, gtol)


def plain_fused_parity(device, checks, V=2048, E=8192, H=128):
    """The unweighted sparse aggregate (the backbone convs) vs the segment
    reference: fwd + grad, f32 and bf16 features."""
    checks.section("fused plain SpMM vs gcn_aggregate_sparse")
    rng = np.random.default_rng(13)
    senders, receivers, edge_mask = _random_edges(rng, V, E)
    x = _t(rng.standard_normal((V, H)), device)
    g = _sparse_graph(senders, receivers, edge_mask, V, device)
    ref_fn = lambda x: gcn_aggregate_sparse(x, g.senders, g.receivers, g.edge_mask, None)
    for prec, dt, ftol, gtol in _MODES:
        got_fn = lambda x: gcn_aggregate_sparse_plain(x.to(dt), g)
        checks.check(f"fwd [{prec}]", got_fn(x), ref_fn(x), ftol)
        (gr,), (gg,) = _grads(ref_fn, (x,)), _grads(got_fn, (x,))
        checks.check(f"grad dx [{prec}]", gg, gr, gtol)


def gat_sparse_parity(device, checks, V=4096, E=65536, heads=4, d=32):
    checks.section("multi-head SpMM (sparse GAT) vs gat_aggregate_sparse (f32)")
    rng = np.random.default_rng(4)
    senders, receivers, edge_mask = _random_edges(rng, V, E)
    xh = _t(rng.standard_normal((V, heads, d)), device)
    att_dst = _t(rng.standard_normal((heads, d)), device) * 0.1
    att_src = _t(rng.standard_normal((heads, d)), device) * 0.1
    g = _sparse_graph(senders, receivers, edge_mask, V, device)
    gen = lambda: torch.Generator(device=device).manual_seed(9)

    ref_fn = lambda xh, rate=0.0, gn=None: gat_aggregate_sparse(
        xh, g.senders, g.receivers, g.edge_mask, att_dst, att_src, rate, gn)
    got_fn = lambda xh, rate=0.0, gn=None: gat_aggregate_sparse_mh(
        xh, g, att_dst, att_src, rate, gn)
    checks.check("fwd", got_fn(xh), ref_fn(xh), 1e-4)
    (gr,), (gf,) = _grads(ref_fn, (xh,)), _grads(got_fn, (xh,))
    # the gradient flows through the per-head SDDMM dcoef, the softmax and
    # the scores; parity_tpu.py's hardware tolerance
    checks.check("grad dxh", gf, gr, 1e-2)
    # the same generator seed: both draw the edges' keep bits, then the self
    # terms', in the same order
    checks.check("dropout fwd (same key)", got_fn(xh, 0.2, gen()), ref_fn(xh, 0.2, gen()), 1e-4)


def gat_fused_chain_parity(device, checks, V=4096, E=65536, heads=4, d=32):
    """The fused sparse GAT chain vs the plain sparse reference: fwd + grads
    (xh, att halves), f32 and bf16 features, plus hash dropout statistics
    and replay determinism."""
    checks.section("fused GAT chain vs gat_aggregate_sparse")
    rng = np.random.default_rng(17)
    senders, receivers, edge_mask = _random_edges(rng, V, E)
    xh = _t(rng.standard_normal((V, heads, d)), device)
    att_dst = _t(rng.standard_normal((heads, d)), device) * 0.1
    att_src = _t(rng.standard_normal((heads, d)), device) * 0.1
    g = _sparse_graph(senders, receivers, edge_mask, V, device)
    words = (111, 222)
    ref_fn = lambda xh, ad, asr: gat_aggregate_sparse(
        xh, g.senders, g.receivers, g.edge_mask, ad, asr)
    for prec, dt, ftol, gtol in _MODES:
        got_fn = lambda xh, ad, asr: gat_aggregate_sparse_fused(xh.to(dt), ad, asr, words, g)
        checks.check(f"fwd [{prec}]", got_fn(xh, att_dst, att_src), ref_fn(xh, att_dst, att_src), ftol)
        gr = _grads(ref_fn, (xh, att_dst, att_src))
        gg = _grads(got_fn, (xh, att_dst, att_src))
        for name, a, b in zip(("dxh", "datt_dst", "datt_src"), gg, gr):
            checks.check(f"grad {name} [{prec}]", a, b, gtol)
        if prec == "f32":
            dfn = lambda xh: gat_aggregate_sparse_fused(xh, att_dst, att_src, words, g, 0.2)
            checks.check_range("dropout mean ratio",
                        float(dfn(xh).sum() / got_fn(xh, att_dst, att_src).sum()), 0.9, 1.1)
            (g1,), (g2,) = _grads(dfn, (xh,)), _grads(dfn, (xh,))
            checks.check("dropout grad replay", g2, g1, 0.0)


def mxu_pool_parity(device, checks, blocks=16, H=128, G=129, block=512):
    """The sparse pool vs a segment sum: fwd + grad, f32/bf16."""
    checks.section("pool vs segment_sum")
    v = blocks * block
    rng = np.random.default_rng(19)
    ng_np = np.sort(rng.integers(0, G, size=v)).astype(np.int32)
    ng_np[-block:] = G                         # padded nodes -> trash row
    ng = _t(ng_np, device, torch.int32)
    for dtype, tag, ftol, gtol in ((torch.float32, "f32", 1e-6, 1e-5),
                                   (torch.bfloat16, "bf16", 1e-2, 5e-2)):
        x = _t(rng.standard_normal((v, H)), device).to(dtype)
        ref_fn = lambda x: torch.zeros((G + 1, H), device=device).index_add_(
            0, ng.long(), x.float())[:G]
        got_fn = lambda x: segment_pool(x, ng, G + 1)[:G]
        checks.check(f"fwd [{tag}]", got_fn(x), ref_fn(x), ftol)
        (gr,), (gg,) = _grads(ref_fn, (x,)), _grads(got_fn, (x,))
        checks.check(f"grad dx [{tag}]", gg, gr, gtol)


SECTIONS = (gat_parity, edge_gat_parity, gcn_dense_parity, adj_build_parity, spmm_parity,
            spmm_sigmoid_fused_parity, spmm_sigmoid_pair_parity, plain_fused_parity,
            gat_sparse_parity, gat_fused_chain_parity, mxu_pool_parity)


def main(argv: list[str] | None = None) -> list[dict]:
    """Runs every section at its default size; returns the checks' records
    and raises SystemExit listing the failures."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    device = resolve_device(p.parse_args(argv).device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}")
    checks = Checks()
    for section in SECTIONS:
        section(device, checks)
    if checks.failures:
        raise SystemExit(f"PARITY FAILURES: {checks.failures}")
    print("all on-card kernel parities OK")
    return checks.records


if __name__ == "__main__":
    main()
