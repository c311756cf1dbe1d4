"""The harness finds every configuration, traffic mix and per-layer metric by
its name, and a cell, a mix or a metric added as files and entries runs with
no edit to the harness."""
import json
import shutil
from pathlib import Path

import pytest

import generator
import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.resolve_cell(ROOT, cell)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["requests"] and c.traffic["axes"]
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "trials_per_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    traffic = generator.build(c.traffic, c.config, seed=2 ** 33 + 1, n_laser=3, n_ring=2)
    assert traffic.trials == 6 and len(traffic.unit_sets) == c.traffic["unit_sets"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.load_reader(metric))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_programs_configuration(config):
    """Each file's numbers are those of the port's own named configuration."""
    from repro_torch.configs.wdm import WDM_CONFIGS

    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    named = WDM_CONFIGS[config]
    built = harness.program_config(data)
    assert built.grid == named.grid.__class__(**{**named.grid.__dict__,
                                                 "fsr_mean": named.grid.fsr})
    assert built.var == named.var and built.max_fsr_alias == named.max_fsr_alias
    assert entry["reduced"] == []


def test_units_from_large_seeds_differ_and_repeat():
    a = generator.build(json.loads((ROOT / "bench/traffic/fig14-vtrs-ssm.json").read_text()),
                        json.loads((ROOT / "bench/configs/wdm16-g200.json").read_text()),
                        seed=2 ** 32 + 5, n_laser=4, n_ring=4)
    b = generator.build(json.loads((ROOT / "bench/traffic/fig14-vtrs-ssm.json").read_text()),
                        json.loads((ROOT / "bench/configs/wdm16-g200.json").read_text()),
                        seed=5, n_laser=4, n_ring=4)
    assert not all((x == y).all() for x, y in zip(a.unit_sets[0], b.unit_sets[0]))
    again = generator.build(json.loads((ROOT / "bench/traffic/fig14-vtrs-ssm.json").read_text()),
                            json.loads((ROOT / "bench/configs/wdm16-g200.json").read_text()),
                            seed=2 ** 32 + 5, n_laser=4, n_ring=4)
    assert all((x == y).all() for x, y in zip(a.unit_sets[0], again.unit_sets[0]))


def test_a_cell_mix_and_metric_added_as_files_run(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and a cell as new files and entries only; the copied
    harness runs the new cell on the CPU and reports the new metric."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench/configs/wdm8-g200.json").read_text())
    cfg["name"] = "wdm8-g400"
    cfg.update(ghz=400, grid_spacing_nm=2.24, ring_bias_nm=8.96, fsr_mean_nm=17.92)
    (tmp_path / "bench/configs/wdm8-g400.json").write_text(json.dumps(cfg))
    (tmp_path / "bench/traffic/fig14-seq-permuted.json").write_text(json.dumps({
        "unit_sets": 1, "requests": [{"scheme": "seq", "order": "permuted"}],
        "axes": {"tr_mean": {"linspace_times_spacing": [0.25, "n_ch", 3]}},
        "check": {"grids_per_request": 1, "points_per_grid": 3}}))
    (tmp_path / "bench/metrics/device.events_per_grid.py").write_text(
        "def read(data):\n    return data.device_events / max(data.grids, 1)\n")
    bench["configs"].append({"name": "wdm8-g400", "source": "https://arxiv.org/abs/2411.14810",
                             "file": "bench/configs/wdm8-g400.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "wdm8g400.seq", "config": "wdm8-g400",
                               "traffic": "fig14-seq-permuted", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "device.events_per_grid", "unit": "count",
                               "better": "lower", "source": "device_trace", "layer": "device",
                               "moves": "trials_per_s", "workloads": ["wdm8g400.seq"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    orig = harness.HERE
    harness.HERE = tmp_path / "bench"
    try:
        cell = harness.resolve_cell(tmp_path, "wdm8g400.seq")
        assert [m["name"] for m in cell.per_layer] == ["device.events_per_grid"]
        result, checks = harness.run_cell(tmp_path, "wdm8g400.seq", 9, 0.05, True, 0.0,
                                          device="cpu", n_laser=3, n_ring=3)
    finally:
        harness.HERE = orig
    assert result["correct"] and result["attempted"] >= 1
    assert result["metrics"]["device.events_per_grid"]["unit"] == "count"


def _trace(**kw):
    import tracing

    base = dict(grids=4, window_s=1.0, busy_s=0.5, device_ops=[], idle_gaps=[],
                device_events=0, kernel_launches=0, notes=[], launches={}, counters={})
    return tracing.TraceData(**{**base, **kw})


def test_a_listed_metric_that_reads_nothing_ends_a_run_on_the_card():
    """On the card a per-layer metric listed for the cell that reads nothing
    (its kernel renamed, its counter gone) gives no result; on the CPU, where
    the plain versions launch no kernel, it is left out."""
    cell = harness.resolve_cell(ROOT, "wdm8.fig14-ltc-schemes")
    data = _trace(notes=[{"name": "sweep.plan", "n_chunks": 1}] * 4)
    got = harness.per_layer_values(cell, data, strict=False)
    assert set(got) == {"sweep.chunks_per_grid", "device.idle_pct", "device.launches_per_grid"}
    with pytest.raises(SystemExit, match="table_build_roofline"):
        harness.per_layer_values(cell, data, strict=True)
    ops = [("table_build_kernel<24>", 0.004, 2), ("feasibility_kernel", 0.002, 2)]
    launches = {"table_build": [(1, 2, 3, 4, None, 0, 0, 10_000, 8, 8, 24, 5, 6, 7, 0)] * 2,
                "feasibility": [(1, 2, 3, 4, 5, 10_000, 8, 6, 7, 0)] * 2}
    full = harness.per_layer_values(cell, _trace(notes=data.notes, device_ops=ops,
                                                 launches=launches), strict=True)
    assert full["table_build_roofline"]["value"] == pytest.approx(100 * 0.00506268656716418 / 2)
    assert set(full) == {m["name"] for m in cell.per_layer}
