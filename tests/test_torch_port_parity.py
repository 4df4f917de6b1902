"""The port's parity entry point (``python -m cal_tpu_torch.parity``) on the
CPU, where every kernel wrapper runs its plain twin.

Each of the eleven sections of benchmarks/parity_tpu.py runs at a small size
through its size arguments and must pass with no failure recorded; ``main``
runs all of them at their full (parity_tpu.py) sizes with ``--device cpu``;
a recorded failure ends ``main`` with SystemExit naming it; and without a
card the default device refuses to fall back to the CPU.  The sparse GAT
dropout of the plain reference and of the multi-head SpMM path draw the
same bits from one seeded generator."""
import numpy as np
import pytest
import torch

from cal_tpu_torch import parity

# Sizes of the CPU runs.  The flash-GAT section and the fused GAT chain keep
# parity_tpu.py's sizes (about a second each here): their dropout statistic
# is a ratio of signed sums over every cell, which a few hundred cells do not
# pin to within 0.1 of 1, and the chain's bf16 datt gradient is a sum over
# every node whose cancellation needs its V to stay within the bf16 bound.
SMALL = {
    "gat_parity": dict(),
    "edge_gat_parity": dict(B=6, N=24, H=2, D=16, EG=40),
    "gcn_dense_parity": dict(B=3, N=40, H=32),
    "adj_build_parity": dict(B=4, N=16, EG=20, slots=128),
    "spmm_parity": dict(V=256, E=1024, H=32),
    "spmm_sigmoid_fused_parity": dict(V=256, E=1024, H=32),
    "spmm_sigmoid_pair_parity": dict(V=256, E=1024, H=32),
    "plain_fused_parity": dict(V=256, E=1024, H=32),
    "gat_sparse_parity": dict(V=256, E=1024, heads=2, d=16),
    "gat_fused_chain_parity": dict(),
    "mxu_pool_parity": dict(blocks=2, H=32, G=9, block=64),
}


def test_sections_follow_parity_tpu():
    """The eleven sections of parity_tpu.py's ``main``, in its order."""
    assert [s.__name__ for s in parity.SECTIONS] == list(SMALL)


@pytest.mark.parametrize("name", list(SMALL))
def test_section_passes_on_cpu(name):
    checks = parity.Checks()
    getattr(parity, name)(torch.device("cpu"), checks, **SMALL[name])
    assert checks.records and not checks.failures, checks.failures
    assert all(r["ok"] for r in checks.records)


def test_main_runs_every_section_on_cpu(capsys):
    results = parity.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "all on-card kernel parities OK" in out
    assert {r["section"] for r in results} == {
        ln[:-1] for ln in out.splitlines() if ln and not ln.startswith((" ", "device", "all"))}
    assert len({r["section"] for r in results}) == 11


def test_main_exits_nonzero_on_failure(monkeypatch):
    def bad(device, checks):
        checks.check("forced", torch.ones(3), torch.zeros(3) + 2.0, 1e-5)

    monkeypatch.setattr(parity, "SECTIONS", (bad,))
    with pytest.raises(SystemExit, match=r"PARITY FAILURES: \['forced'\]"):
        parity.main(["--device", "cpu"])


def test_main_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity.main([])


def test_sparse_dropout_draws_match():
    """gat_aggregate_sparse and gat_aggregate_sparse_mh with generators of
    one seed keep the same (edge, head) and (node, head) terms: equal
    outputs; another seed moves them; the keep fraction is 1 - rate."""
    from cal_tpu_torch.ops.gat import _alpha_dropout, gat_aggregate_sparse, gat_aggregate_sparse_mh

    rng = np.random.default_rng(0)
    v, e, heads, d = 128, 900, 4, 8
    s, r, m = parity._random_edges(rng, v, e)
    g = parity._sparse_graph(s, r, m, v, "cpu")
    xh = torch.from_numpy(rng.standard_normal((v, heads, d)).astype(np.float32))
    ad, asr = (torch.from_numpy(rng.standard_normal((heads, d)).astype(np.float32))
               for _ in range(2))
    gen = lambda seed: torch.Generator().manual_seed(seed)
    ref = gat_aggregate_sparse(xh, g.senders, g.receivers, g.edge_mask, ad, asr, 0.2, gen(9))
    got = gat_aggregate_sparse_mh(xh, g, ad, asr, 0.2, gen(9))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    other = gat_aggregate_sparse_mh(xh, g, ad, asr, 0.2, gen(10))
    assert (other - ref).abs().max() > 1e-3
    kept = _alpha_dropout(torch.ones(200_000), 0.2, gen(1))
    assert abs(float((kept > 0).float().mean()) - 0.8) < 5e-3
    assert float(kept.max()) == pytest.approx(1.25)
