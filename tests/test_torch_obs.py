"""The port's observability layer (``repro_torch.obs`` and its call sites)
against the JAX reference (``repro.obs``) on identical inputs, on the CPU.

* the reference's own checks (``tests/test_obs.py``) run on the port:
  trace-on changes no outcome, wrap-immune counts and chronological decode,
  taxonomy closure on WDM16 ``seq_retry`` residuals, classifier corners,
  recorder transparency around ``sweep`` and ``bringup``, span nesting,
  health-matrix consistency, traced timelines, the manifest/report round
  trip and ``python -m repro_torch.obs.smoke --device cpu``;
* carried inputs: on the reference's own search tables (carried with
  ``tables_from_numpy``) the port's ``run_protocol(trace=)`` equals the
  reference's ``TraceBuffer`` bit for bit, over WDM8 and a tie-heavy
  grid-quantized system, the three controller orders, depths 0, 1 and None,
  a transactional warm start with a patience cap, and capacities 4 (the
  ring wraps) and 256;
* ``run_timeline(trace=)`` on a 3-step ``wdm16-hotswap`` slice, the chaos
  health matrix on FABRIC_TINY, ``classify_trials`` on the same inputs and
  ``explain_residuals`` on a WDM8 case: equal to the reference.

Tolerances: exact.  Every buffer field, code and health matrix is an equal
int32 or int8 array; every other output is bit-identical with the
instrument on and off.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import fabric as jfab  # noqa: E402
from repro.configs.fabric import FABRIC_TINY as J_TINY  # noqa: E402
from repro.configs.wdm import drift_timeline as j_drift  # noqa: E402
from repro.core import ArbitrationConfig, DWDMGrid  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import protocol as jproto  # noqa: E402
from repro.core import temporal as jtemp  # noqa: E402
from repro.core.relation import chain_spec as jchain  # noqa: E402
from repro.core.sampling import SystemBatch as JSystem  # noqa: E402
from repro.core.sampling import instantiate as jinst  # noqa: E402
from repro.core.search_table import build_search_tables as jbuild  # noqa: E402
from repro.obs import taxonomy as jtax  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch import fabric as tfab  # noqa: E402
from repro_torch.configs.fabric import FABRIC_TINY  # noqa: E402
from repro_torch.configs.wdm import WDM8_G200, WDM16_G200, drift_timeline  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    state_from_numpy,
    tables_from_numpy,
    timeline_from_numpy,
    trace_from_numpy,
    units_from_numpy,
)
from repro_torch.core import protocol as tproto  # noqa: E402
from repro_torch.core import temporal as ttemp  # noqa: E402
from repro_torch.core.api import make_units  # noqa: E402
from repro_torch.core.grid import ArbitrationConfig as TConfig  # noqa: E402
from repro_torch.core.grid import DWDMGrid as TGrid  # noqa: E402
from repro_torch.core.relation import chain_spec as tchain  # noqa: E402
from repro_torch.core.sampling import instantiate  # noqa: E402
from repro_torch.core.search_table import build_search_tables  # noqa: E402
from repro_torch.core.sweep import SweepRequest, sweep  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    EVENT_KINDS,
    HEALTH_CODES,
    PhaseRecorder,
    current_recorder,
    format_events,
    health_matrix_summary,
    measured_call,
    note,
    span,
    trace_append,
    trace_buffer,
    trace_events,
    trace_summary,
    use_recorder,
)
from repro_torch.obs.manifest import RunManifest, latest_manifest, read_manifest  # noqa: E402
from repro_torch.obs.report import main as report_main  # noqa: E402
from repro_torch.obs.report import render_report  # noqa: E402
from repro_torch.obs.taxonomy import TAXONOMY, classify_trials, explain_residuals  # noqa: E402

CFG = TConfig(grid=TGrid(n_ch=8))
_STATIC = ("order", "depth", "n_rounds", "with_stats", "with_state", "transactional",
           "patience", "trace")
_jrun = jax.jit(jproto.run_protocol, static_argnames=_STATIC)


def _arrays(tree):
    """The tensors of a (nested) tuple as numpy arrays, None leaves dropped."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [a for leaf in tree for a in _arrays(leaf)]
    return [tree.numpy()]


def _same(a, b):
    """Two port tuples of tensors, equal field by field."""
    a, b = _arrays(a), _arrays(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _equal(got, want, what):
    """Port tuple of tensors vs reference tuple of arrays, exactly."""
    got, want = _arrays(got), [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i, g.dtype, w.dtype)
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")


@pytest.fixture(scope="module")
def tables():
    units = make_units(CFG, 3, 3, 4, device="cpu")
    return build_search_tables(instantiate(CFG, units), 3.0, max_alias=CFG.max_fsr_alias)


def _shared_tables(kind):
    """(reference tables, port tables, reference cfg): the reference's WDM8
    tables at TR 3.0, or a tie-heavy grid-quantized WDM8 batch at TR 3.0."""
    cfg = ArbitrationConfig(grid=DWDMGrid(n_ch=8))
    if kind == "wdm8":
        sys = jinst(cfg, japi.make_units(cfg, 3, 3, 4))
    else:
        rng = np.random.default_rng(5)
        sys = JSystem(
            laser=jnp.asarray(rng.integers(0, 8, (9, 8)).astype(np.float32) * 0.25),
            ring=jnp.asarray(rng.integers(-4, 4, (9, 8)).astype(np.float32) * 0.25),
            fsr=jnp.asarray(rng.integers(1, 4, (9, 8)).astype(np.float32) * 0.25),
            tr_unit=jnp.ones((9, 8), jnp.float32),
        )
    jt = jbuild(sys, 3.0, max_alias=cfg.max_fsr_alias)
    return jt, tables_from_numpy(*(np.asarray(a) for a in jt), device="cpu"), cfg


# ------------------------------------------------- carried reference inputs --

@pytest.mark.parametrize("kind,order,depth,cap", [
    ("wdm8", "constrained", None, 256),
    ("wdm8", "physical", 1, 4),
    ("wdm8", "chain", 0, 256),
    ("quantized", "constrained", 1, 256),
    ("quantized", "physical", None, 4),
    ("quantized", "chain", 0, 4),
])
def test_trace_matches_reference_buffer(kind, order, depth, cap):
    jt, tt, cfg = _shared_tables(kind)
    want = _jrun(jt, jchain(cfg.s), order=order, depth=depth, with_stats=True,
                 with_state=True, trace=cap)
    got = tproto.run_protocol(tt, tchain(cfg.s), order=order, depth=depth,
                              with_stats=True, with_state=True, trace=cap)
    _equal(got, want, f"{kind} order={order} depth={depth} cap={cap}")
    # decoded on the host, and carried back across, the buffers agree too
    carried = trace_from_numpy(*(np.asarray(a) for a in want[3]), device="cpu")
    for a, b in zip(carried, got[3]):
        assert torch.equal(a, b)
    for g, w in zip(trace_events(got[3]), jtrace.trace_events(want[3])):
        np.testing.assert_array_equal(g, w)
    assert trace_summary(got[3]) == jtrace.trace_summary(want[3])


@pytest.mark.parametrize("kind,cap", [("wdm8", 4), ("quantized", 256)])
def test_trace_transactional_warm_start_matches_reference(kind, cap):
    """A mid-run state resumed transactionally with a patience cap:
    rolled-back trials keep their events, halted ones stop recording."""
    jt, tt, cfg = _shared_tables(kind)
    js, ts = jchain(cfg.s), tchain(cfg.s)
    _, _, mid = _jrun(jt, js, n_rounds=1, with_stats=True, with_state=True)
    jstart = mid._replace(probes=jnp.zeros_like(mid.probes))
    tstart = state_from_numpy(*(np.asarray(a) for a in jstart), device="cpu")
    want = _jrun(jt, js, with_stats=True, with_state=True, init_state=jstart,
                 transactional=True, patience=2, trace=cap)
    got = tproto.run_protocol(tt, ts, with_stats=True, with_state=True, init_state=tstart,
                              transactional=True, patience=2, trace=cap)
    _equal(got, want, f"{kind} warm transactional cap={cap}")


def test_trace_batch_independent(tables):
    """A trial subset's trace equals the same rows of the whole batch."""
    spec = tchain(CFG.s)
    full = tproto.run_protocol(tables, spec, trace=16)[-1]
    idx = torch.tensor([0, 3, 4, 9, 11])
    sub_tables = type(tables)(*(x[idx] for x in tables))
    sub = tproto.run_protocol(sub_tables, spec, trace=16)[-1]
    for a, b in zip(sub, full):
        assert torch.equal(a, b[idx])


# ------------------------------------------------------- reference checks --

def test_trace_on_changes_no_outcome(tables):
    spec = tchain(CFG.s)
    kw = dict(with_stats=True, with_state=True)
    off = tproto.run_protocol(tables, spec, **kw)
    *on, buf = tproto.run_protocol(tables, spec, trace=32, **kw)
    _same(off, tuple(on))
    assert int(buf.n.sum()) > 0


def test_trace_counts_are_wrap_immune(tables):
    spec = tchain(CFG.s)
    buf_s = tproto.run_protocol(tables, spec, trace=4)[-1]
    buf_l = tproto.run_protocol(tables, spec, trace=256)[-1]
    assert torch.equal(buf_s.n, buf_l.n) and torch.equal(buf_s.counts, buf_l.counts)
    assert torch.equal(buf_l.counts.sum(dim=1, dtype=torch.int32), buf_l.n)
    summ = trace_summary(buf_s)
    assert summ["events_total"] == int(buf_l.n.sum())
    assert summ["overflowed_trials"] == int((buf_s.n > 4).sum())
    for ev in trace_events(buf_l):
        if not len(ev):
            continue
        assert ev.shape[1] == 4
        assert np.all((ev[:, 2] >= 0) & (ev[:, 2] < len(EVENT_KINDS)))
        assert np.all(np.diff(ev[:, 0]) >= 0)
        assert isinstance(format_events(ev, limit=5), str)
    trial = int(buf_l.n.argmax())
    assert int(buf_l.n[trial]) > 4
    np.testing.assert_array_equal(trace_events(buf_s, trial), trace_events(buf_l, trial)[-4:])
    with pytest.raises(ValueError, match="capacity"):
        trace_buffer(2, 0, device="cpu")


def test_taxonomy_closed_on_fig19_residuals():
    cfg = WDM16_G200
    units = make_units(cfg, 21, 5, 5, device="cpu")
    trs = np.linspace(0.25 * cfg.grid.grid_spacing, cfg.grid.n_ch * cfg.grid.grid_spacing, 12,
                      dtype=np.float32)[::4]
    tax = explain_residuals(cfg, units, trs, scheme="seq_retry", depth=1, trace_cap=64)
    assert tax["unknown"] == 0 and "unknown" not in tax["histogram"]
    assert tax["residual_total"] > 0
    assert tax["residual_total"] == sum(tax["histogram"].values())
    for p in tax["points"]:
        assert all(0 <= c < len(TAXONOMY) for c in p["codes"])
        assert len(p["codes"]) == p["residual_trials"]


def test_classify_trials_locked_and_hopeless(tables):
    spec = tchain(CFG.s)
    _, stats, state, buf = tproto.run_protocol(tables, spec, with_stats=True,
                                               with_state=True, trace=64)
    t = state.lock.shape[0]
    rounds = tproto.default_rounds(CFG.grid.n_ch)
    complete = (state.lock >= 0).all(dim=1)
    codes = classify_trials(state.lock, tables.n_valid, buf.counts, stats.worked, rounds=rounds)
    assert codes.shape == (t,) and codes.dtype == torch.int8
    assert torch.equal(codes == TAXONOMY.index("locked"), complete)
    codes_h = classify_trials(state.lock, tables.n_valid, buf.counts, stats.worked,
                              rounds=rounds, feasible=torch.zeros((t,), dtype=torch.bool))
    assert bool((codes_h[~complete] == TAXONOMY.index("hopeless")).all())


@pytest.mark.parametrize("with_feasible", [False, True])
def test_classify_trials_matches_reference(with_feasible):
    """Both classifiers fed the same inputs, with every class present."""
    rng = np.random.default_rng(11)
    t, n = 64, 8
    lock = rng.integers(-1, 8, (t, n)).astype(np.int32)
    lock[::3] = np.abs(lock[::3])
    n_valid = rng.integers(0, 3, (t, n)).astype(np.int32)
    counts = rng.integers(0, 12, (t, len(EVENT_KINDS))).astype(np.int32)
    counts[::4, 2:4] = 0
    worked = rng.integers(1, 40, t).astype(np.int32)
    feasible = rng.random(t) < 0.7 if with_feasible else None
    want = jtax.classify_trials(lock, n_valid, counts, worked, rounds=32, feasible=feasible)
    got = classify_trials(lock, n_valid, counts, worked, rounds=32, feasible=feasible)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.tolist())) >= 4


def test_explain_residuals_matches_reference():
    jcfg = ArbitrationConfig(grid=DWDMGrid(n_ch=8))
    ju = japi.make_units(jcfg, 21, 4, 4)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    trs = np.array([3.0], np.float32)
    want = jtax.explain_residuals(jcfg, ju, trs, scheme="seq_retry", depth=1, trace_cap=32)
    got = explain_residuals(WDM8_G200, tu, trs, scheme="seq_retry", depth=1, trace_cap=32)
    assert got == want and got["residual_total"] > 0


def test_recorder_leaves_sweep_grid_bit_identical():
    units = make_units(CFG, 5, 3, 4, device="cpu")
    req = SweepRequest(cfg=CFG, units=units, scheme="seq_retry",
                       axes={"tr_mean": np.linspace(1.5, 5.5, 3, dtype=np.float32)})
    bare = sweep(req)
    rec = PhaseRecorder(measure_memory=True)
    with use_recorder(rec):
        recd = sweep(req)
    assert current_recorder() is None
    _same(bare.data, recd.data)
    fields = rec.phase_fields()
    assert fields["sweep"]["kind"] == "execute" and fields["sweep"]["count"] == 1
    names = [n["name"] for n in rec.notes]
    assert "sweep.plan" in names and "chunked_map.sweep_points" in names
    # the CPU allocator keeps no peak statistics: no watermark on the CPU
    assert rec.memory_fields() == []


def test_recorder_leaves_bringup_bit_identical():
    bare = tfab.bringup(CFG, FABRIC_TINY, tr_mean=4.6, device="cpu")
    rec = PhaseRecorder(measure_memory=True)
    with use_recorder(rec):
        recd = tfab.bringup(CFG, FABRIC_TINY, tr_mean=4.6, device="cpu")
    _same((bare.ev, bare.stats, bare.state), (recd.ev, recd.stats, recd.state))
    plan = next(n for n in rec.notes if n["name"] == "bringup.plan")
    assert plan["links"] == FABRIC_TINY.n_links and plan["n_chunks"] == 1
    assert "chunked_map.bringup_links" in [n["name"] for n in rec.notes]
    # one root, the bring-up's execute span, closed last; every span below it
    roots = [s for s in rec.spans if s.parent_id == -1]
    assert [s.name for s in roots] == ["bringup"] and rec.spans[-1] is roots[0]
    assert roots[0].kind == "execute" and len(rec.spans) > 1
    assert all(s.root_id == roots[0].span_id for s in rec.spans)
    assert rec.memory_fields() == []


def test_phase_helpers_are_noops_without_recorder(tables):
    assert current_recorder() is None
    with span("never-recorded", kind="host"):
        note("never.recorded", x=1)
    spec = tchain(CFG.s)
    plain = tproto.run_protocol(tables, spec)
    via = measured_call("p", tproto.run_protocol, (tables, spec), {})
    for a, b in zip(plain, via):
        assert torch.equal(a, b)


def test_recorder_span_nesting_and_current_path():
    rec = PhaseRecorder()
    with use_recorder(rec):
        with rec.span("outer") as outer:
            with rec.span("inner", kind="execute") as inner:
                assert inner.parent_id == outer.span_id and inner.end_ns == -1
            with span("module-level") as mod:
                pass
        out = measured_call("call", lambda x: x + 1, (torch.ones(2),), {})
    call = rec.spans[-1]
    assert [s.name for s in rec.spans] == ["inner", "module-level", "outer", "call"]
    assert outer.parent_id == -1 and outer.root_id == outer.span_id
    assert inner.root_id == mod.root_id == outer.span_id and mod.parent_id == outer.span_id
    assert call.parent_id == -1 and call.root_id == call.span_id != outer.span_id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= mod.start_ns <= outer.end_ns
    by = rec.phase_fields()
    assert by["outer"]["count"] == 1 and by["inner"]["kind"] == "execute"
    assert by["module-level"]["kind"] == "host" and by["call"]["kind"] == "execute"
    assert torch.equal(out, torch.full((2,), 2.0)) and rec.memory_fields() == []


#: The port's layer spans of one grid, span -> the span it opens under.
_SCHEME_TREE = {"sweep.request": None, "sweep": "sweep.request",
                "sampling.scheme_trials": "sweep", "sampling.instantiate":
                "sampling.scheme_trials", "arbiters.ideal": "sampling.scheme_trials",
                "arbiters.tables": "sampling.scheme_trials",
                "arbiters.scheme": "sampling.scheme_trials",
                "arbiters.classify": "sampling.scheme_trials"}
_PROTOCOL_TREE = {**_SCHEME_TREE, "protocol.run": "arbiters.scheme",
                  "protocol.round": "protocol.run", "protocol.sync": "protocol.round",
                  "protocol.probe": "protocol.round", "protocol.augment": "protocol.round",
                  "protocol.release": "protocol.round"}
_LTA_TREE = {"sweep.request": None, "sweep": "sweep.request",
             "sampling.policy_trial_min_tr": "sweep",
             "sampling.instantiate": "sampling.policy_trial_min_tr",
             "arbiters.ideal": "sampling.policy_trial_min_tr"}


_SIGMA_TR = {"sigma_rlv": np.array([1.12, 2.24], np.float32),
             "tr_mean": np.linspace(1.5, 5.5, 3, dtype=np.float32)}


@pytest.mark.parametrize("target,axes,tree", [
    ({"scheme": "vtrs_ssm"}, _SIGMA_TR, _SCHEME_TREE),
    ({"policy": "lta"}, _SIGMA_TR, _LTA_TREE),            # the TR fast path
    # seed 9's 2 x 2 units run 3 rounds here: a few, not the 32 of a grid
    # with a trial that never completes (each round ~40 ms on the CPU)
    ({"scheme": "protocol_lta"}, {"tr_mean": np.array([3.0, 3.25, 3.5], np.float32)},
     _PROTOCOL_TREE),
], ids=["scheme", "lta-tr-fast", "protocol"])
def test_recorder_layer_spans_nest_under_one_request(monkeypatch, target, axes, tree):
    units = make_units(CFG, 9, 2, 2, device="cpu")
    req = SweepRequest(cfg=CFG, units=units, **target, axes=axes)
    bare = sweep(req)
    probes = []
    probe_phase = tproto._probe_phase
    monkeypatch.setattr(tproto, "_probe_phase", lambda *a: probes.append(1) or probe_phase(*a))
    rec = PhaseRecorder()
    with use_recorder(rec):
        recd = sweep(req)
    _same(bare.data, recd.data)
    by_id = {s.span_id: s for s in rec.spans}
    root = rec.spans[-1]
    assert root.name == "sweep.request" and [s.parent_id for s in rec.spans].count(-1) == 1
    assert {s.name for s in rec.spans} == set(tree)
    for s in rec.spans:
        parent = by_id.get(s.parent_id)
        assert (parent.name if parent else None) == tree[s.name], s
        assert s.root_id == root.span_id
        if parent is not None:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    names = [s.name for s in rec.spans]
    # one request runs one chunk: each layer span once, the protocol's once a round
    assert all(names.count(n) == 1 for n in tree if not n.startswith("protocol."))
    assert rec.counters.get("protocol.rounds", 0) == len(probes) == names.count("protocol.probe")
    if "protocol.run" in tree:
        assert len(probes) > 1 and names.count("protocol.sync") == names.count("protocol.round")
        assert names.count("protocol.round") in (len(probes), len(probes) + 1)


def test_no_span_or_counter_without_recorder(monkeypatch):
    from repro_torch.obs import phase

    assert current_recorder() is None
    assert span("a") is span("b", kind="execute", x=1)        # the one shared nullcontext

    def refuse(*a, **k):
        raise AssertionError("a span or counter was made with no recorder installed")
    monkeypatch.setattr(phase, "_Opened", refuse)
    monkeypatch.setattr(phase.PhaseRecorder, "count", refuse)
    units = make_units(CFG, 9, 2, 2, device="cpu")
    sweep(SweepRequest(cfg=CFG, units=units, scheme="protocol_lta",
                       axes={"tr_mean": np.array([3.0, 3.25, 3.5], np.float32)}))
    phase.count("protocol.rounds")


def test_span_stamps_on_the_profilers_clock():
    """A recorder span and a ``record_function`` range around the same 20 ms
    sleep start and end within 2 ms of each other."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    rec = PhaseRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof, use_recorder(rec):
        with span("clock.sleep") as s, record_function("clock.sleep.range"):
            time.sleep(0.02)
    ev = next(e for e in prof.profiler.kineto_results.events() if e.name() == "clock.sleep.range")
    assert abs(ev.start_ns() - s.start_ns) < 2_000_000, (ev.start_ns(), s.start_ns)
    assert abs(ev.end_ns() - s.end_ns) < 2_000_000, (ev.end_ns(), s.end_ns)
    assert s.ms >= 20.0


def test_fabric_health_matrix_parity_and_consistency():
    """health=True changes no chaos stat, agrees with the reference's
    matrix, and reads ``down`` exactly where the link is dead."""
    n = CFG.grid.n_ch
    ju = jfab.make_fabric_units(ArbitrationConfig(grid=DWDMGrid(n_ch=8)), J_TINY, 0)
    jtl = jfab.make_fabric_timeline(J_TINY, 3, n, thermal=0.15, events=[(1, "link_kill", 0)])
    _, want = jfab.run_fabric_timeline(ArbitrationConfig(grid=DWDMGrid(n_ch=8)), ju, J_TINY,
                                       jtl, health=True)
    units = tfab.make_fabric_units(CFG, FABRIC_TINY, 0, device="cpu")
    tl = tfab.make_fabric_timeline(FABRIC_TINY, 3, n, thermal=0.15,
                                   events=[(1, "link_kill", 0)], device="cpu")
    _, plain = tfab.run_fabric_timeline(CFG, units, FABRIC_TINY, tl)
    _, obs = tfab.run_fabric_timeline(CFG, units, FABRIC_TINY, tl, health=True)
    assert plain.health is None
    _same(plain, obs._replace(health=None))
    health = obs.health.numpy()
    np.testing.assert_array_equal(health, np.asarray(want.health))
    assert health.shape == (3, FABRIC_TINY.n_links) and health.dtype == np.int8
    assert np.all((health >= 0) & (health < len(HEALTH_CODES)))
    alive = tl.link_alive.numpy()
    np.testing.assert_array_equal(health == 0, ~alive)
    summ = health_matrix_summary(obs.health)
    assert summ["steps"] == 3 and summ["by_code"]["down"] == int((~alive).sum())
    assert 0.0 <= summ["healthy_frac"] <= 1.0


def test_run_timeline_trace_parity_and_stacking():
    jcfg, jtl = j_drift("wdm16-hotswap")
    jtl = jtemp.slice_timeline(jtl, 0, 3)
    ju = japi.make_units(jcfg, 1, 4, 4)
    var = {"tr_mean": 4.0 * jcfg.grid.grid_spacing}
    want = jtemp.run_timeline(jcfg, ju, jtl, var, trace=16)
    tcfg, _ = drift_timeline("wdm16-hotswap", device="cpu")
    tl = timeline_from_numpy(*(np.asarray(a) for a in jtl), device="cpu")
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    off = ttemp.run_timeline(tcfg, tu, tl, var)
    got = ttemp.run_timeline(tcfg, tu, tl, var, trace=16)
    _equal(got, want, "traced timeline")
    _same(off, got[:2])
    bufs = got[2]
    assert bufs.ev.shape == (3, 16, 16, 4)
    assert torch.equal(bufs.counts.sum(dim=-1, dtype=torch.int32), bufs.n)
    # a zero-step timeline stacks zero buffers
    _, _, empty = ttemp.run_timeline(tcfg, tu, ttemp.slice_timeline(tl, 0, 0), var, trace=16)
    assert empty.ev.shape == (0, 16, 16, 4) and empty.counts.shape == (0, 16, 6)


def test_run_timeline_trace_rejects_one_shot_schemes():
    tcfg, tl = drift_timeline("wdm16-hotswap", device="cpu")
    units = make_units(tcfg, 1, 3, 3, device="cpu")
    with pytest.raises(ValueError, match="one-shot"):
        ttemp.run_timeline(tcfg, units, ttemp.slice_timeline(tl, 0, 2), {"tr_mean": 5.0},
                           scheme="vtrs_ssm", warm=False, trace=8)


def test_manifest_report_roundtrip(tmp_path, capsys):
    buf = trace_buffer(2, 4, device="cpu")
    fire = torch.tensor([True, False])
    trace_append(buf, fire, 0, 1, 0, 3)
    trace_append(buf, ~fire, 1, 2, 1, 5)
    assert buf.n.tolist() == [1, 1] and buf.ev[1, 0].tolist() == [1, 2, 1, 5]
    rec = PhaseRecorder()
    with rec.span("demo", kind="execute"):
        pass
    rec.memory("demo.temp", 64 << 20, 256 << 20)
    health = torch.tensor([[4, 0], [2, 3]], dtype=torch.int8)

    man = RunManifest.create(str(tmp_path), label="t", answer=42)
    with man:
        man.record_phases(rec, scope="ph")
        man.record_trace(buf, scope="tr", taxonomy={"histogram": {"starvation": 1},
                                                    "unknown": 0})
        man.record_health(health, scope="he")
        man.record_bench({"figure": "f", "name": "f/x", "module_wall_ms": 1.0,
                          "derived": {"v": 1}})
        man.write("tensors", t=torch.arange(3), s=np.int64(7), x=np.float32(0.5))

    assert latest_manifest(str(tmp_path)) == man.path
    lines = list(read_manifest(man.path))
    kinds = [line["kind"] for line in lines]
    for k in ("meta", "phases", "trace", "health", "bench_record", "tensors"):
        assert k in kinds
    assert lines[0]["answer"] == 42
    assert lines[-1]["t"] == [0, 1, 2] and lines[-1]["s"] == 7 and lines[-1]["x"] == 0.5
    assert lines[kinds.index("health")]["codes"] == [[4, 0], [2, 3]]
    for line in lines:
        json.dumps(line)

    report = render_report(man.path)
    for section in ("phases [ph]", "trace [tr]", "health [he]", "bench trajectory"):
        assert section in report
    assert "starvation" in report and "25.0%" in report
    with open(man.path, "a") as fh:
        fh.write("{not json\n")
    assert len(list(read_manifest(man.path))) == len(lines)
    assert report_main([str(tmp_path)]) == 0
    assert "health [he]" in capsys.readouterr().out


def test_obs_smoke_runs_on_the_cpu(capsys):
    from repro_torch.obs import smoke

    assert smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "obs smoke OK on cpu" in out and "0 memory notes" in out
