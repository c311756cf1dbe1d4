"""The last line a run prints carries the contract's keys, with the checks
last; a run without a card prints nothing and fails."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import harness

ROOT = Path(__file__).resolve().parents[2]
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace, capsys):
    result, checks = harness.run_cell(ROOT, "wdm16.fig14-vtrs-ssm", 2 ** 31 + 3, 0.05, trace,
                                      0.0, device="cpu", n_laser=3, n_ring=3)
    assert harness.print_result(result, checks) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert [k for k in line if k in REQUIRED + ["breakdown"]] == \
        REQUIRED + (["breakdown"] if trace else [])
    assert list(line)[-1] == "checks"
    assert set(line["device"]) == DEVICE | ({"busy_s", "window_s"} if trace else set())
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"trials_per_s", "grid_ms_p95", "setup_s"}
    assert err.strip().splitlines()[-2:] == [f"check {n} {v} limit {lim}" for n, v, lim in checks]


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "wdm8.fig14-ltc-schemes",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_checkout_without_the_port_fails(tmp_path):
    """A directory holding only BENCHMARK.json and bench/ gives no result."""
    import shutil

    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "wdm8.fig14-ltc-schemes",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
def test_a_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "wdm16.fig14-vtrs-ssm",
                        "--seed", "5", "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
