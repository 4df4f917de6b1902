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
    code = ("import sys, cal_tpu_torch.main_syn, cal_tpu_torch.ops.adj_build, "
            "cal_tpu_torch.ops.fused_gcn, cal_tpu_torch.kernels.build\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}]\n"
            "assert not bad, bad")
    res = _run(code)
    assert res.returncode == 0, res.stderr


def test_main_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is available")
    from cal_tpu_torch.main_syn import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--model", "CausalGCN", "--inference", "true", "--data_num", "1"])


def test_kernel_modules_import_without_nvcc():
    code = ("import os, shutil\n"
            "os.environ['PATH'] = ''\n"
            "import cal_tpu_torch.ops.adj_build as a, cal_tpu_torch.ops.fused_gcn as f\n"
            "assert a.adj_build.launches == 0 and f.fused_gcn_dense_att_dual.launches == 0\n"
            "from cal_tpu_torch.kernels import build\n"
            "assert sorted(build.sources()) == ['adj_build', 'fused_gcn']")
    res = _run(code)
    assert res.returncode == 0, res.stderr
