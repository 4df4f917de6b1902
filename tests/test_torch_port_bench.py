"""The port's benchmark entry point (``cal_tpu_torch.bench``) on the CPU at
tiny sizes: its roofline helper against cal_tpu's formula under the same
peaks, config 3's REDDIT-shaped graphs against the root bench's leaf for
leaf, and configs 1 and 4 returning finite, positive numbers under their
keys (the plain twins run here; the card runs the kernels)."""
import numpy as np
import pytest
import torch

import bench as root_bench
import cal_tpu.utils.profiling as jax_profiling
from cal_tpu_torch import bench
from cal_tpu_torch.data.loader import Loader
from cal_tpu_torch.data.synthetic import dataset_bias_split, generate_synthetic_dataset
from cal_tpu_torch.utils import profiling
from cal_tpu_torch.utils.profiling import spmm_roofline


@pytest.mark.parametrize("edges,hidden,seconds", [(117964.0 * 3, 128, 1.2e-3), (300, 16, 2.0)])
def test_spmm_roofline_matches_jax(edges, hidden, seconds, monkeypatch):
    ref = jax_profiling.spmm_roofline(edges, hidden, seconds, gen="v5e")
    monkeypatch.setattr(profiling, "H100_SXM_HBM_GBPS",
                        jax_profiling.HW_PEAKS["v5e"]["hbm_gbps"])
    got = spmm_roofline(edges, hidden, seconds)
    assert set(got) == {"edges_per_s", "hbm_gbps_floor", "pct_hbm_floor"}
    for k, v in got.items():
        assert v == pytest.approx(ref[k], rel=1e-12), k


def test_sparse_pack_workload_matches_root_bench():
    ref = root_bench._sparse_pack_workload(8)
    got = bench._sparse_pack_workload(8)
    assert len(got) == len(ref) == 8
    for a, b in zip(got, ref):
        for k in ("x", "senders", "receivers"):
            assert getattr(a, k).dtype == getattr(b, k).dtype, k
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
        assert a.y == b.y


def test_bench_spmm_tiled_on_cpu():
    r = bench.bench_spmm_tiled(v=512, e=4096, h=32, iters=3, device="cpu",
                               dtype=torch.float32)
    for k in ("edges_per_s", "speedup_vs_plain", "ms", "plain_ms"):
        assert np.isfinite(r[k]) and r[k] > 0, k
    assert r["kernel_iterations"] == 6 and r["pct_hbm_roofline"] >= 0


def test_bench_causal_train_on_cpu():
    cfg = bench.Config(model="CausalGCN", hidden=16, layers=1, batch_size=8, device="cpu")
    ds = generate_synthetic_dataset(data_num=8, node_num=4, max_degree=6, seed=5)
    train, _, _, _ = dataset_bias_split(ds, bias=0.7, total=32, seed=0)
    batches = list(Loader(train, 8, shuffle=True, drop_remainder=True).host_batches())
    assert len(batches) == len(train) // 8
    r = bench.bench_causal_train("CausalGCN", cfg, batches, 100.0, target_steps=5)
    assert r["epochs_per_call"] == max(1, 30 // len(batches))
    assert r["steps_per_call"] == r["epochs_per_call"] * len(batches)
    assert r["steps"] == -(-5 // r["steps_per_call"]) * r["steps_per_call"]
    for k in ("edges_per_s", "seconds", "loss"):
        assert np.isfinite(r[k]) and r[k] > 0, k
