"""The seed sweep runs main_syn once per seed and summarizes each run's
metrics log (tiny CausalGCN runs on the CPU)."""
import json

from cal_tpu_torch.seed_sweep import main


def test_seed_sweep_summarizes_each_seed(tmp_path):
    out = tmp_path / "sweep"
    summary = main(["--seeds", "3,4", "--parallel", "2", "--out", str(out), "--late", "2-3",
                    "--", "--model", "CausalGCN", "--data_num", "10", "--epochs", "3",
                    "--device", "cpu", "--hidden", "16", "--layers", "2", "--batch_size", "8"])
    assert sorted(summary["seeds"]) == ["3", "4"]
    for s, r in summary["seeds"].items():
        final = json.loads((out / f"seed_{s}.jsonl").read_text().splitlines()[-1])
        assert final["event"] == "final"
        assert r["co"] == 100 * final["test_acc_co"] and r["epoch"] == final["epoch"]
        assert r["late_val_sd"] is not None and r["late_val_sd"] >= 0
    assert json.loads((out / "summary.json").read_text())["median"] == summary["median"]
