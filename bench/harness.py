"""One run of a cell: set-up, the measured window, the traced window's
reduction, and the check of the window's answers against the plain
reference.  ``run.py`` is the command line around ``run_cell``.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs[].file``) under a traffic mix (``bench/traffic/<traffic>.json``).
The window is a closed loop with one caller: each grid is one
``repro_torch.core.sweep.sweep(SweepRequest(...))`` call, timed from the call
until its result arrays are on the host, and the next is sent when it is
back.  The requests turn in the mix's order over the seed's unit sets.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

import generator
import tracing
from reference import model as ref

HERE = Path(__file__).resolve().parent

#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

RESULT_FIELDS = ("afp", "cafp", "lock_err", "order_err")


class Cell(NamedTuple):
    name: str
    entry: dict        # the workloads entry
    config: dict       # the configuration file
    traffic: dict      # the traffic file
    end_to_end: list   # BENCHMARK.json metric entries reported by this cell
    per_layer: list


def load_benchmark(root: Path) -> dict:
    return generator.load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(root: Path, name: str) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = generator.load_json(root / configs[entry["config"]]["file"])
    traffic = generator.load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    return Cell(name, entry, config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def program_config(config: dict):
    """The port's ``ArbitrationConfig`` holding the file's numbers."""
    from repro_torch.core.grid import ArbitrationConfig, DWDMGrid, VariationModel
    from repro_torch.core.search_table import max_entries_for

    grid = DWDMGrid(n_ch=int(config["n_ch"]), grid_spacing=float(config["grid_spacing_nm"]),
                    ring_bias=float(config["ring_bias_nm"]),
                    fsr_mean=float(config["fsr_mean_nm"]), tr_mean=float(config["tr_mean_nm"]))
    var = VariationModel(sigma_go=float(config["sigma_go_nm"]),
                         sigma_llv_frac=float(config["sigma_llv_frac"]),
                         sigma_rlv=float(config["sigma_rlv_nm"]),
                         sigma_fsr_frac=float(config["sigma_fsr_frac"]),
                         sigma_tr_frac=float(config["sigma_tr_frac"]))
    if max_entries_for(grid.n_ch) != int(config["max_entries"]):
        raise SystemExit(f"the port's tables hold {max_entries_for(grid.n_ch)} entries, "
                         f"the configuration states {config['max_entries']}")
    return ArbitrationConfig(grid=grid, var=var, max_fsr_alias=int(config["max_fsr_alias"]))


def sweep_request(cfg, units, req: generator.Request):
    from repro_torch.core.sweep import SweepRequest

    return SweepRequest(cfg=cfg.with_orders(req.order), units=units, axes=req.axes,
                        **{req.kind: req.target})


def to_host(data) -> dict:
    """A grid's result arrays on the host: a policy grid's AFP, or a scheme
    grid's rates and per-trial outcomes."""
    if isinstance(data, torch.Tensor):
        return {"afp": data.cpu().numpy()}
    return {k: getattr(data, k).cpu().numpy() for k in RESULT_FIELDS + ("alg_success", "ideal_ok")}


# --- the check --------------------------------------------------------------

def _point_axes(req: generator.Request, flat: int) -> dict:
    idx = np.unravel_index(flat, req.shape)
    return {name: values[i] for (name, values), i in zip(req.axes.items(), idx)}


def check_units(req: generator.Request) -> tuple[int, ...]:
    """What one checked answer covers: a scheme grid's point, or a policy
    grid's row along its TR axis (one per-trial min-TR solve gives all)."""
    if req.kind == "scheme" or "tr_mean" not in req.axes:
        return req.shape
    return tuple(len(v) for n, v in req.axes.items() if n != "tr_mean")


def expected(dep, config: dict, req: generator.Request, units, picks: list, *, dtype,
             device) -> list:
    """The plain reference's answers at the picked answers of a grid."""
    n = dep.n_ch
    s = ref.order(req.order, n)
    sigma_default = np.float32(config["sigma_rlv_nm"])
    tr_default = np.float32(config["tr_mean_nm"])
    if req.kind == "scheme":
        systems, trs = [], []
        for flat in picks:
            pt = _point_axes(req, flat)
            systems.append(ref.instantiate(dep, units, s, pt.get("sigma_rlv", sigma_default),
                                           dtype=dtype, device=device))
            trs.append(np.float32(pt.get("tr_mean", tr_default)))
        sys_ = ref.concat(systems)
        t = systems[0].laser.shape[0]
        tr = torch.as_tensor(np.repeat(np.array(trs, np.float32), t)).to(device, dtype)
        out = ref.scheme_trials(dep, sys_, s, req.target, tr)
        alg, ok = (x.reshape(len(picks), t) for x in (out.alg_success, out.ideal_ok))
        rates = {"afp": ref.trial_mean(~ok), "cafp": ref.trial_mean(~alg & ok),
                 "lock_err": ref.trial_mean(out.lock_err.reshape(len(picks), t)),
                 "order_err": ref.trial_mean(out.order_err.reshape(len(picks), t))}
        return [{**{k: v[i].cpu().numpy() for k, v in rates.items()},
                 "alg_success": alg[i].cpu().numpy(), "ideal_ok": ok[i].cpu().numpy()}
                for i in range(len(picks))]
    rest = {k: v for k, v in req.axes.items() if k != "tr_mean"}
    systems = []
    for flat in picks:
        idx = np.unravel_index(flat, tuple(len(v) for v in rest.values())) if rest else ()
        pt = {name: values[i] for (name, values), i in zip(rest.items(), idx)}
        systems.append(ref.instantiate(dep, units, s, pt.get("sigma_rlv", sigma_default),
                                       dtype=dtype, device=device))
    sys_ = ref.concat(systems)
    min_tr = ref.lta_min_tr(sys_) if req.target == "lta" else ref.ltc_min_tr(sys_, s)
    min_tr = min_tr.reshape(len(picks), -1)
    trs = req.axes.get("tr_mean", np.array([tr_default], np.float32))
    tr = torch.as_tensor(trs).to(device, min_tr.dtype)
    afp = ref.trial_mean(~(min_tr[:, None, :] <= tr[None, :, None])).cpu().numpy()
    return [{"afp": row} for row in afp]


def program_answers(req: generator.Request, host: dict, picks: list) -> list:
    """The program's answers at the picked points of a grid on the host."""
    if req.kind == "scheme":
        out = []
        for flat in picks:
            idx = np.unravel_index(flat, req.shape)
            out.append({k: v[idx] for k, v in host.items()})
        return out
    if "tr_mean" not in req.axes:
        return [{"afp": np.atleast_1d(host["afp"][np.unravel_index(f, req.shape)])}
                for f in picks]
    grid = np.moveaxis(host["afp"], list(req.axes).index("tr_mean"), -1)
    rows = grid.reshape(-1, grid.shape[-1])
    return [{"afp": rows[f]} for f in picks]


def mismatches(want: list, got: list) -> tuple[int, int]:
    """(trials whose outcome differs, grid values that differ); float32
    values are compared exactly."""
    trials = values = 0
    for w, g in zip(want, got):
        for k, v in w.items():
            differ = int(np.count_nonzero(np.asarray(v) != np.asarray(g[k])))
            if k in ("alg_success", "ideal_ok"):
                trials += differ
            else:
                values += differ
    return trials, values


def _mixed(req: generator.Request, host: dict) -> np.ndarray:
    """Per checked answer: do the program's outcomes there differ among
    trials (a scheme point) or lie strictly between 0 and 1 (a policy row)?"""
    if req.kind == "scheme":
        n = int(np.prod(req.shape))
        return np.array([(v.reshape(n, -1).min(1) != v.reshape(n, -1).max(1))
                         for v in (host["alg_success"], host["ideal_ok"])]).any(0)
    rows = np.stack([a["afp"] for a in program_answers(
        req, host, list(range(int(np.prod(check_units(req))))))])
    return ((rows > 0) & (rows < 1)).any(1)


def pick(rng, req: generator.Request, host: dict, k: int) -> list:
    """``k`` answers of a grid, drawn from the seed: half uniformly, half
    among those where the program's outcomes are not all alike (where a
    reduction over part of the trials would show), topped up uniformly."""
    n_items = int(np.prod(check_units(req)))
    k = min(k, n_items)
    first = rng.choice(n_items, size=(k + 1) // 2, replace=False).tolist()
    mixed = [i for i in np.flatnonzero(_mixed(req, host)).tolist() if i not in first]
    more = rng.choice(mixed, size=min(k - len(first), len(mixed)), replace=False).tolist() \
        if mixed else []
    rest = [i for i in range(n_items) if i not in first + more]
    fill = rng.choice(rest, size=k - len(first) - len(more), replace=False).tolist()
    return sorted(int(i) for i in first + more + fill)


# --- the run ----------------------------------------------------------------

class Window(NamedTuple):
    grids: int
    seconds: float
    trials: int
    latencies_ms: list
    kept: dict         # request index -> [(unit set, host result)]


def run_window(requests: list, traffic: generator.Traffic, seconds: float, rng, *,
               traced: bool) -> Window:
    """Closed loop, one caller, for ``seconds``; keeps a seeded reservoir of
    ``grids_per_request`` answers of each request for the check.  A grid's
    latency runs on the host's clock from the call to ``sweep`` until its
    result arrays are on the host (``to_host`` waits for the card)."""
    from repro_torch.core.sweep import sweep

    k = int(traffic.check["grids_per_request"])
    kept: dict = {r: [] for r in range(len(traffic.requests))}
    seen = dict.fromkeys(kept, 0)
    latencies_ms = []
    span = torch.profiler.record_function if traced else (lambda _: contextlib.nullcontext())
    i = trials = 0
    with span(tracing.WINDOW):
        t0 = time.perf_counter()
        while True:
            r, u = generator.schedule(traffic, i)
            req = traffic.requests[r]
            h0 = time.perf_counter()
            with span(tracing.GRID):
                res = sweep(requests[r][u])
            with span(tracing.TO_HOST):
                host = to_host(res.data)
            h1 = time.perf_counter()
            latencies_ms.append((h1 - h0) * 1e3)
            del res
            seen[r] += 1
            if len(kept[r]) < k:
                kept[r].append((u, host))
            else:
                j = int(rng.integers(seen[r]))
                if j < k:
                    kept[r][j] = (u, host)
            trials += req.points * traffic.trials
            i += 1
            if h1 - t0 >= seconds:
                break
        t1 = time.perf_counter()
    return Window(i, t1 - t0, trials, latencies_ms, kept)


def check_window(cell: Cell, traffic: generator.Traffic, window: Window, rng, *,
                 device) -> tuple[int, int, int]:
    """Compare a seeded sample of the window's answers with the reference:
    -> (trials that differ, grid values that differ, answers compared)."""
    dep = ref.Deployment.from_config(cell.config)
    m = int(traffic.check["points_per_grid"])
    trial_mm = value_mm = compared = 0
    for r, grids in window.kept.items():
        req = traffic.requests[r]
        for u, host in grids:
            picks = pick(rng, req, host, m)
            want = expected(dep, cell.config, req, traffic.unit_sets[u], picks,
                            dtype=torch.float32, device=device)
            t, v = mismatches(want, program_answers(req, host, picks))
            trial_mm, value_mm, compared = trial_mm + t, value_mm + v, compared + len(picks)
    return trial_mm, value_mm, compared


def e2e_value(name: str, window: Window, setup_s: float) -> float | None:
    if name == "setup_s":
        return setup_s
    if name == "trials_per_s":
        return window.trials / window.seconds
    if name == "grid_ms_p95":
        return float(np.percentile(window.latencies_ms, 95)) if window.latencies_ms else None
    raise SystemExit(f"no measurement for end-to-end metric {name!r}")


def load_reader(name: str):
    """``bench/metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer_values(cell: Cell, data: tracing.TraceData, *, strict: bool) -> dict:
    """The cell's per-layer metrics from a traced window.  On the card every
    metric that ``BENCHMARK.json`` lists for the cell has to read: one that
    reads nothing (a kernel, span or counter renamed or gone out of the
    reader's sight) ends the run with no result.  Elsewhere (the plain
    versions on the CPU launch no kernel) such a metric is left out."""
    metrics, missing = {}, []
    for m in cell.per_layer:
        value = load_reader(m["name"])(data)
        if value is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if strict and missing:
        raise SystemExit(f"bench: per-layer metrics listed for {cell.name} read nothing in the "
                         f"traced window: {missing}")
    return metrics


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, t_start: float, *,
             device: str = "cuda", n_laser: int | None = None, n_ring: int | None = None):
    """One run of a cell -> (result line dict, [(check name, value, limit)])."""
    from repro_torch.core.sampling import UnitSamples

    dev = torch.device(device)
    cell = resolve_cell(root, name)
    traffic = generator.build(cell.traffic, cell.config, seed, n_laser=n_laser, n_ring=n_ring)
    cfg = program_config(cell.config)
    units = [UnitSamples(*(torch.from_numpy(u).to(dev) for u in us)) for us in traffic.unit_sets]
    requests = [[sweep_request(cfg, us, req) for us in units] for req in traffic.requests]
    from repro_torch.core.sweep import sweep

    for row in requests:                       # every shape of the mix, once
        to_host(sweep(row[0]).data)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng(int(seed) % 2 ** 64)
    if trace:
        with tracing.traced_window(dev.type == "cuda") as state:
            window = run_window(requests, traffic, min(seconds, tracing.TRACE_SECONDS), rng,
                                traced=True)
    else:
        window = run_window(requests, traffic, seconds, rng, traced=False)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    metrics, extra = {}, {}
    if trace:
        data = tracing.reduce(state, window.grids)
        del state
        device_info.update(busy_s=data.busy_s, window_s=data.window_s)
        metrics = per_layer_values(cell, data, strict=dev.type == "cuda")
        extra["breakdown"] = tracing.breakdown(data)
        del data
    else:
        for m in cell.end_to_end:
            value = e2e_value(m["name"], window, setup_s)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    del requests, units
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if len(window.latencies_ms) >= 3:
        q = np.percentile(window.latencies_ms, [5, 25, 50, 75, 95, 99])
        thirds = [float(np.mean(part)) for part in np.array_split(window.latencies_ms, 3)]
        print("bench: grid ms p5/p25/p50/p75/p95/p99 " + " ".join(f"{v:.3f}" for v in q)
              + "; mean by third of the window " + " ".join(f"{v:.3f}" for v in thirds),
              file=sys.stderr)
    t_check = time.perf_counter()
    trial_mm, value_mm, compared = check_window(cell, traffic, window, rng, device=dev)
    print(f"bench: {window.grids} grids in {window.seconds:.3f} s; {compared} answers checked "
          f"in {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    checks = [("trial_mismatches", trial_mm, 0), ("value_mismatches", value_mm, 0)]
    correct = window.grids > 0 and compared > 0 and all(v <= lim for _, v, lim in checks)
    result = {"correct": bool(correct), "attempted": window.grids, "failed": 0,
              "metrics": metrics, "device": device_info, **extra,
              "card": card_line() if dev.type == "cuda" else "cpu",
              "answers_compared": compared,
              "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}
    return result, checks


def print_result(result: dict, checks: list) -> int:
    """The checks as the last lines of standard error, the result as the last
    line of standard output; refuses if a forbidden module was loaded."""
    found = forbidden_modules()
    if found:
        print(f"bench: modules that may not be loaded in a run were loaded: {found}",
              file=sys.stderr, flush=True)
        return 3
    sys.stdout.flush()
    for name, value, limit in checks:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

