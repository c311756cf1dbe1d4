"""The port's protocol engine (``repro_torch.core.protocol``) against the JAX
reference on identical inputs, on the CPU, plus the reference's invariant
checks run on the port.

The engine is held on **the reference's own search tables** (carried across
with ``tables_from_numpy``): the reference's streaming table builder and the
port's builder can differ by an ulp in ``delta``, which could move an entry
across the tuning-range edge.  The whole path, tables included, is held in
``test_torch_protocol_schemes.py`` and ``test_torch_temporal.py``.

Tolerances: everything exact.  ``Assignment`` entries and line ids,
``ProtocolState`` and ``ProtocolStats`` fields are equal integers, ``kept``
masks equal booleans, and ``Assignment.delta`` equal bit for bit (it is a
gather of the shared tables).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ArbitrationConfig, DWDMGrid, make_units  # noqa: E402
from repro.core import protocol as jproto  # noqa: E402
from repro.core.relation import chain_spec as jchain  # noqa: E402
from repro.core.sampling import SystemBatch as JSystem  # noqa: E402
from repro.core.sampling import instantiate as jinst  # noqa: E402
from repro.core.search_table import build_search_tables as jbuild  # noqa: E402
from repro_torch.convert import state_from_numpy, tables_from_numpy  # noqa: E402
from repro_torch.core import ideal as tideal  # noqa: E402
from repro_torch.core import protocol as tproto  # noqa: E402
from repro_torch.core.outcomes import classify as tclassify  # noqa: E402
from repro_torch.core.relation import chain_spec as tchain  # noqa: E402
from repro_torch.core.sampling import SystemBatch as TSystem  # noqa: E402
from repro_torch.core.search_table import build_search_tables as tbuild  # noqa: E402

#: (n_ch, seed, tr_mean, quantized), the reference's always-on grid
#: (tests/test_protocol.py), including tie-heavy grid-quantized systems.
CASES = [
    (4, 0, 2.5, False),
    (4, 3, 6.0, True),
    (8, 1, 1.0, False),
    (8, 2, 4.5, False),
    (8, 5, 3.0, True),
    (8, 7, 9.0, True),
]
ORDERS = ("constrained", "physical", "chain")
_STATIC = ("order", "depth", "n_rounds", "n_seekers", "k_donors", "with_stats",
           "with_state", "transactional", "patience")
# Jitted once per (shape, statics): the engine is integer logic plus a delta
# gather, so the jitted and eager reference agree exactly.
_jrun = jax.jit(jproto.run_protocol, static_argnames=_STATIC)


def _random_system(n_ch, seed, quantized):
    """The reference test's systems: sampled, or tie-heavy grid-quantized."""
    cfg = ArbitrationConfig(grid=DWDMGrid(n_ch=n_ch))
    if not quantized:
        return cfg, jinst(cfg, make_units(cfg, seed, 3, 3))
    rng = np.random.default_rng(seed)
    t = 9
    sys = JSystem(
        laser=jnp.asarray(rng.integers(0, n_ch, (t, n_ch)).astype(np.float32) * 0.25),
        ring=jnp.asarray(rng.integers(-4, 4, (t, n_ch)).astype(np.float32) * 0.25),
        fsr=jnp.asarray(rng.integers(1, 4, (t, n_ch)).astype(np.float32) * 0.25),
        tr_unit=jnp.ones((t, n_ch), jnp.float32),
    )
    return cfg, sys


def _shared_tables(n_ch, seed, tr_mean, quantized):
    """(reference tables, port tables, reference spec, port spec, cfg)."""
    cfg, sys = _random_system(n_ch, seed, quantized)
    jt = jbuild(sys, tr_mean, max_alias=cfg.max_fsr_alias)
    tt = tables_from_numpy(*(np.asarray(a) for a in jt), device="cpu")
    return jt, tt, jchain(cfg.s), tchain(cfg.s), cfg


def _port_state(jstate):
    return state_from_numpy(*(np.asarray(a) for a in jstate), device="cpu")


def _assert_equal(got, want, what):
    """Exact equality of a (possibly nested) tuple of tensors vs arrays."""
    if isinstance(got, tuple):
        assert isinstance(want, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{what}[{i}]")
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype, g.shape, w.shape)
    if g.dtype == np.float32:
        g, w = g.view(np.int32), w.view(np.int32)
    np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("depth", [None, 0, 1, 2])
@pytest.mark.parametrize("n_ch,seed,tr_mean,quantized", CASES)
def test_run_protocol_matches_reference(n_ch, seed, tr_mean, quantized, depth, order):
    jt, tt, js, ts, _ = _shared_tables(n_ch, seed, tr_mean, quantized)
    want = _jrun(jt, js, order=order, depth=depth, with_stats=True, with_state=True)
    got = tproto.run_protocol(tt, ts, order=order, depth=depth, with_stats=True,
                              with_state=True)
    _assert_equal(got, want, f"run_protocol depth={depth} order={order}")


@pytest.mark.parametrize("n_ch,seed,tr_mean,quantized", CASES)
def test_return_forms_and_cold_state(n_ch, seed, tr_mean, quantized):
    """The four return forms, and init_state=None == an explicit cold_state."""
    jt, tt, js, ts, _ = _shared_tables(n_ch, seed, tr_mean, quantized)
    t = tt.wl.shape[0]
    full = tproto.run_protocol(tt, ts, with_stats=True, with_state=True)
    _assert_equal(full, _jrun(jt, js, with_stats=True, with_state=True), "full")
    _assert_equal(tproto.run_protocol(tt, ts), full[0], "assign")
    _assert_equal(tproto.run_protocol(tt, ts, with_stats=True), full[:2], "stats")
    _assert_equal(tproto.run_protocol(tt, ts, with_state=True), (full[0], full[2]),
                  "state")
    cold = tproto.cold_state(t, n_ch, device="cpu")
    _assert_equal(tproto.run_protocol(tt, ts, with_stats=True, with_state=True,
                                      init_state=cold), full, "cold_state")


@pytest.mark.parametrize("hysteresis", [None, 0.0, 0.3])
@pytest.mark.parametrize("n_ch,seed,tr_mean,quantized", CASES[:4])
def test_warm_start_through_revalidate_matches_reference(n_ch, seed, tr_mean,
                                                         quantized, hysteresis):
    """A mid-run state, revalidated against tables at a lower TR (locks
    break), then resumed warm: transactional with a patience cap, and plain."""
    jt, tt, js, ts, cfg = _shared_tables(n_ch, seed, tr_mean, quantized)
    _, _, mid = _jrun(jt, js, n_rounds=1, with_stats=True, with_state=True)
    _, sys = _random_system(n_ch, seed, quantized)
    tr2 = 0.8 * tr_mean
    jt2 = jbuild(sys, tr2, max_alias=cfg.max_fsr_alias)
    tt2 = tables_from_numpy(*(np.asarray(a) for a in jt2), device="cpu")
    if hysteresis is None:
        jrev, jkept = jproto.revalidate_state(jt2, mid)
        trev, tkept = tproto.revalidate_state(tt2, _port_state(mid))
    else:
        jtr = tr2 * sys.tr_unit
        jrev, jkept = jproto.revalidate_state(jt2, mid, tr=jtr, hysteresis=hysteresis)
        trev, tkept = tproto.revalidate_state(
            tt2, _port_state(mid), tr=torch.tensor(np.asarray(jtr)),
            hysteresis=hysteresis)
    _assert_equal(tuple(trev), tuple(jrev), "revalidated state")
    _assert_equal(tkept, jkept, "kept")
    jstart = jrev._replace(probes=jnp.zeros_like(jrev.probes))
    tstart = trev._replace(probes=torch.zeros_like(trev.probes))
    for kw in ({"transactional": True, "patience": 3}, {}):
        want = _jrun(jt2, js, with_stats=True, with_state=True, init_state=jstart, **kw)
        got = tproto.run_protocol(tt2, ts, with_stats=True, with_state=True,
                                  init_state=tstart, **kw)
        _assert_equal(got, want, f"warm run {kw}")


@pytest.mark.parametrize("patience", [1, 2, 4])
@pytest.mark.parametrize("n_ch,seed,tr_mean,quantized", CASES)
def test_transactional_and_patience_cold(n_ch, seed, tr_mean, quantized, patience):
    jt, tt, js, ts, _ = _shared_tables(n_ch, seed, tr_mean, quantized)
    kw = dict(transactional=True, patience=patience, with_stats=True, with_state=True)
    _assert_equal(tproto.run_protocol(tt, ts, **kw), _jrun(jt, js, **kw),
                  f"patience={patience}")


def test_revalidate_hysteresis_breaks_marginal_locks():
    """The reference's hysteresis case on a dense system: lines at 0.8 k,
    rings at 0, TR 2.0; margins 0.0 and 0.5, on both engines."""
    n_ch, t, tr = 8, 2, 2.0
    cfg = ArbitrationConfig(grid=DWDMGrid(n_ch=n_ch))
    laser = jnp.broadcast_to(jnp.arange(n_ch, dtype=jnp.float32)[None, :] * 0.8, (t, n_ch))
    sys = JSystem(laser=laser, ring=jnp.zeros((t, n_ch), jnp.float32),
                  fsr=jnp.full((t, n_ch), 100.0, jnp.float32),
                  tr_unit=jnp.ones((t, n_ch), jnp.float32))
    jt = jbuild(sys, tr, max_alias=cfg.max_fsr_alias)
    tt = tables_from_numpy(*(np.asarray(a) for a in jt), device="cpu")
    _, _, state = _jrun(jt, jchain(cfg.s), with_stats=True, with_state=True)
    jtr = tr * sys.tr_unit
    for h in (0.0, 0.5):
        jrev, jkept = jproto.revalidate_state(jt, state, tr=jtr, hysteresis=h)
        trev, tkept = tproto.revalidate_state(
            tt, _port_state(state), tr=torch.tensor(np.asarray(jtr)), hysteresis=h)
        _assert_equal(tuple(trev), tuple(jrev), f"h={h}")
        _assert_equal(tkept, jkept, f"kept h={h}")
    assert not bool(tkept.all())                       # the margin bit something


def test_probe_counts_batch_independent():
    """A trial's stats do not depend on which other trials share the host
    round loop (the reference's test, on the port; shared tables)."""
    cfg = ArbitrationConfig()
    sys = jinst(cfg, make_units(cfg, 11, 4, 4))
    for tr in (1.5, 3.0, 6.0):
        jt = jbuild(sys, tr, max_alias=cfg.max_fsr_alias)
        tt = tables_from_numpy(*(np.asarray(a) for a in jt), device="cpu")
        spec = tchain(cfg.s)
        asg, full = tproto.run_protocol(tt, spec, with_stats=True)
        _assert_equal((asg, full), _jrun(jt, jchain(cfg.s), with_stats=True), f"tr={tr}")
        for t in range(0, tt.wl.shape[0], 5):
            sub = type(tt)(*(a[t:t + 1] for a in tt))
            _, solo = tproto.run_protocol(sub, spec, with_stats=True)
            for f in ("probes", "rounds", "locked", "worked"):
                assert int(getattr(solo, f)[0]) == int(getattr(full, f)[t]), (tr, t, f)


def test_round_two_sees_round_one_state_unaliased():
    """Round 2 must compare against the state round 2 started from.  If the
    phases updated the round's start state in place, ``changed`` would read
    False, every live trial would halt after round 1, and the 2-round result
    would equal the 1-round one.  This case changes state in round 2."""
    jt, tt, js, ts, _ = _shared_tables(8, 1, 1.0, False)
    one = tproto.run_protocol(tt, ts, n_rounds=1, with_stats=True, with_state=True)
    two = tproto.run_protocol(tt, ts, n_rounds=2, with_stats=True, with_state=True)
    _assert_equal(two, _jrun(jt, js, n_rounds=2, with_stats=True, with_state=True),
                  "2 rounds")
    assert not torch.equal(one[2].lock, two[2].lock) or not torch.equal(
        one[2].cursor, two[2].cursor)
    assert int(two[1].worked.max()) == 2
    # The phases leave their input state untouched.
    order = tproto._controller_order(tt, ts, "constrained")
    start = one[2]
    kept = tuple(x.clone() for x in start)
    tproto._probe_phase(tt, order, start)
    tproto._augment_phase(tt, start, 8, 4, 4)
    tproto._release_phase(start)
    for a, b in zip(start, kept):
        assert torch.equal(a, b)


# ------------------------------------------- the reference's invariants --
# The checkers of tests/test_protocol.py, run on the port alone: the port's
# own systems, tables, engine, outcomes and ideal arbiter.

def _port_system(n_ch, seed, quantized, tr_mean):
    cfg, jsys = _random_system(n_ch, seed, quantized)
    sys = TSystem(*(torch.tensor(np.asarray(a)) for a in jsys))
    tables = tbuild(sys, tr_mean, max_alias=cfg.max_fsr_alias)
    return cfg, sys, tables, tchain(cfg.s)


@pytest.mark.parametrize("n_ch,seed,tr_mean,quantized", CASES)
def test_invariant_no_dup_lock_and_locks_in_table(n_ch, seed, tr_mean, quantized):
    _, _, tables, spec = _port_system(n_ch, seed, quantized, tr_mean)
    cfg = ArbitrationConfig(grid=DWDMGrid(n_ch=n_ch))
    for depth in (0, 1, None):
        asg = tproto.run_protocol(tables, spec, depth=depth)
        out = tclassify(asg, cfg.s, policy="lta")
        assert not bool(out.dup_lock.any())
        wl, entry = asg.wl.numpy(), asg.entry.numpy()
        locked = wl >= 0
        assert np.all(wl[locked] < n_ch)
        rows, rings = np.nonzero(locked)
        assert np.all(tables.wl.numpy()[rows, rings, entry[locked]] == wl[locked])


@pytest.mark.parametrize("n_ch,seed,tr_mean,quantized", CASES)
def test_invariant_redward_monotone_within_round(n_ch, seed, tr_mean, quantized):
    _, _, tables, spec = _port_system(n_ch, seed, quantized, tr_mean)
    _, snaps = tproto.run_protocol_trace(tables, spec, n_rounds=5)
    by_round = {}
    for rnd, phase, state in snaps:
        by_round.setdefault(rnd, {})[phase] = tproto.ProtocolState(*(x.numpy() for x in state))
    prev_release = None
    for rnd in sorted(by_round):
        probe, augment, release = (by_round[rnd][p] for p in ("probe", "augment", "release"))
        if prev_release is not None:
            assert np.all(probe.cursor >= prev_release.cursor)
        assert np.all(augment.cursor >= probe.cursor)
        both = (probe.entry >= 0) & (augment.entry >= 0)
        assert np.all(augment.entry[both] >= probe.entry[both])
        rewound = release.cursor < augment.cursor
        assert np.all(release.lock[rewound] < 0)
        assert np.all(release.cursor[rewound] == 0)
        prev_release = release


@pytest.mark.parametrize("n_ch,seed,tr_mean,quantized", CASES)
def test_invariant_complete_trials_are_fixed_points(n_ch, seed, tr_mean, quantized):
    _, _, tables, spec = _port_system(n_ch, seed, quantized, tr_mean)
    _, snaps = tproto.run_protocol_trace(tables, spec, n_rounds=4)
    states = [s.lock.numpy() for _, _, s in snaps]
    for i, lock in enumerate(states[:-1]):
        complete = np.all(lock >= 0, axis=1)
        for later in states[i + 1:]:
            assert np.array_equal(later[complete], lock[complete])


@pytest.mark.parametrize("n_ch,seed,tr_mean,quantized", CASES)
def test_invariant_protocol_success_implies_ideal_lta(n_ch, seed, tr_mean, quantized):
    cfg, sys, tables, spec = _port_system(n_ch, seed, quantized, tr_mean)
    out = tclassify(tproto.run_protocol(tables, spec), cfg.s, policy="lta")
    ideal_ok = tideal.success(sys, "lta", cfg.s, tr_mean)
    assert not bool((out.success & ~ideal_ok).any())


def test_trace_snapshots_match_reference_trace():
    """run_protocol_trace: every phase snapshot equals the reference's,
    including a transactional commit from a warm start."""
    jt, tt, js, ts, _ = _shared_tables(8, 5, 3.0, True)
    _, _, mid = _jrun(jt, js, n_rounds=1, with_stats=True, with_state=True)
    for kw in ({}, {"init_state": mid, "transactional": True}):
        tkw = dict(kw)
        if "init_state" in kw:
            tkw["init_state"] = _port_state(mid)
        jasg, jsnaps = jproto.run_protocol_trace(jt, js, n_rounds=3, **kw)
        tasg, tsnaps = tproto.run_protocol_trace(tt, ts, n_rounds=3, **tkw)
        _assert_equal(tuple(tasg), tuple(jasg), "trace assignment")
        assert [(r, p) for r, p, _ in tsnaps] == [(r, p) for r, p, _ in jsnaps]
        for (r, p, ts_), (_, _, js_) in zip(tsnaps, jsnaps):
            _assert_equal(tuple(ts_), tuple(js_), f"snapshot {r} {p}")
