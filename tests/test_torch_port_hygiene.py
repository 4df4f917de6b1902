"""The port stands alone: no JAX, no cal_tpu, no silent CPU fallback, and its
kernel modules import on machines without nvcc."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cal_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "cal_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_no_module_imports_jax_or_cal_tpu():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            bad += [(path, m) for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_leaves_jax_out():
    code = ("import sys, cal_tpu_torch.main_syn, cal_tpu_torch.main_real, "
            "cal_tpu_torch.ops.adj_build, cal_tpu_torch.ops.edge_gat, "
            "cal_tpu_torch.data.tu, cal_tpu_torch.data.kfold, cal_tpu_torch.data.datasets, "
            "cal_tpu_torch.data.feature_expansion, "
            "cal_tpu_torch.ops.fused_gcn, cal_tpu_torch.ops.flash_gat, "
            "cal_tpu_torch.ops.gat, cal_tpu_torch.ops.gat_sparse, cal_tpu_torch.ops.spmm, "
            "cal_tpu_torch.ops.pool, cal_tpu_torch.ops.coo_spmm, cal_tpu_torch.ops.gin, "
            "cal_tpu_torch.ops.segment, cal_tpu_torch.kernels.build, cal_tpu_torch.seed_sweep, "
            "cal_tpu_torch.models.baselines, cal_tpu_torch.models.factory, "
            "cal_tpu_torch.parity, "
            "cal_tpu_torch.train.optim, cal_tpu_torch.train.steps, "
            "cal_tpu_torch.train.causal, cal_tpu_torch.train.baseline, "
            "cal_tpu_torch.train.losses, cal_tpu_torch.bench, cal_tpu_torch.utils.profiling, "
            "cal_tpu_torch.data.loader, cal_tpu_torch.data.reddit_synthetic, "
            "cal_tpu_torch.utils.logging, cal_tpu_torch.native, cal_tpu_torch.train.graphs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}]\n"
            "assert not bad, bad")
    res = _run(code)
    assert res.returncode == 0, res.stderr


def test_main_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is available")
    from cal_tpu_torch.main_real import main as main_real
    from cal_tpu_torch.main_syn import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--model", "CausalGCN", "--inference", "true", "--data_num", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_real(["--model", "CausalGAT", "--dataset", "SYNREDDIT"])


def test_kernel_modules_import_without_nvcc():
    code = ("import os, shutil\n"
            "os.environ['PATH'] = ''\n"
            "import cal_tpu_torch.ops.adj_build as a, cal_tpu_torch.ops.fused_gcn as f\n"
            "import cal_tpu_torch.ops.flash_gat as fg, cal_tpu_torch.nn.layers\n"
            "import cal_tpu_torch.train.causal, cal_tpu_torch.train.steps, "
            "cal_tpu_torch.train.optim, cal_tpu_torch.utils.logging, "
            "cal_tpu_torch.train.graphs, cal_tpu_torch.native\n"
            "assert a.adj_build.launches == 0 and f.fused_gcn_dense_att_dual.launches == 0\n"
            "assert f.fused_gcn_dense_att_dual_bwd.launches == 0\n"
            "assert fg.flash_gat_fwd.launches == 0 and fg.flash_gat_bwd.launches == 0\n"
            "from cal_tpu_torch.kernels import build\n"
            "import cal_tpu_torch.ops.spmm as sp, cal_tpu_torch.ops.pool as po\n"
            "assert sp.pair_sender_degree.launches == sp.pair_coef_spmm.launches == 0\n"
            "assert sp.plain_coef_spmm.launches == po.segment_pool.launches == 0\n"
            "assert sp.pair_coef_spmm_t.launches == sp.plain_coef_spmm_t.launches == 0\n"
            "assert sp.pair_sddmm_chain.launches == sp.pair_dpre.launches == 0\n"
            "assert po.segment_pool_bwd.launches == 0\n"
            "assert sp.sigmoid_sender_degree.launches == sp.sigmoid_coef_spmm.launches == 0\n"
            "assert sp.sigmoid_coef_spmm_t.launches == sp.sigmoid_sddmm_chain.launches == 0\n"
            "assert sp.sigmoid_dpre.launches == 0\n"
            "import cal_tpu_torch.bench\n"
            "import cal_tpu_torch.ops.gat_sparse as gs\n"
            "assert gs.gat_row_stats.launches == gs.gat_coef_spmm.launches == 0\n"
            "assert gs.gat_coef_spmm_t.launches == gs.gat_sddmm_chain.launches == 0\n"
            "import cal_tpu_torch.ops.coo_spmm as co\n"
            "assert co.coo_spmm.launches == co.coo_spmm_t.launches == co.coo_sddmm.launches == 0\n"
            "import cal_tpu_torch.ops.edge_gat as eg\n"
            "assert eg.edge_gat_fwd.launches == eg.edge_gat_bwd.launches == 0\n"
            "assert sorted(build.sources()) == ['adj_build', 'coo_spmm', 'edge_gat', "
            "'edge_gat_bwd', 'flash_gat', 'fused_gcn', 'gat_sparse', 'pool', 'spmm']")
    res = _run(code)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """chip_smoke.py copied into a directory without the package exits
    non-zero and prints no result line."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
