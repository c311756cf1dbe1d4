"""The port's temporal re-arbitration (``repro_torch.core.temporal``) and drift
scenarios against the JAX reference on identical inputs, on the CPU.

* ``make_timeline`` / ``drift_timeline``: every array equal (float32 drifts
  bit for bit, liveness exact), for every registered scenario and for each
  drift-spec form;
* ``run_timeline`` warm and cold, with lane and ring events, at WDM4 and
  WDM8 (3 x 3 units), one WDM16 drift scenario (3 x 3 units), a hysteresis
  margin and a one-shot scheme: the whole path, the port's own tables
  included, against the reference's jitted ``run_timeline``;
* ``slice_timeline``: a run resumed from a carried state equals the
  uninterrupted run.

Tolerances: exact.  Every ``TemporalStats`` field (S, T) and the final
``ProtocolState`` are equal integers and booleans.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import wdm as jwdm  # noqa: E402
from repro.core import ArbitrationConfig, DWDMGrid  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import temporal as jtemp  # noqa: E402
from repro_torch.configs import wdm as twdm  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_fields,
    timeline_from_numpy,
    units_from_numpy,
)
from repro_torch.core import temporal as ttemp  # noqa: E402

EVENTS = ((1, "ring_kill", 2), (2, "lane_kill", 1), (3, "lane_swap", 1),
          (3, "ring_swap", 2))
#: (n_ch, seed, tr_mean): the reference's temporal grid (tests/test_temporal.py).
CASES = [(4, 0, 3.0), (8, 1, 4.0), (8, 5, 6.0)]


def _tl_equal(got, want):
    for f in ttemp.Timeline._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _run_equal(got, want):
    """(final ProtocolState, TemporalStats) equal field by field."""
    for part, g_t, w_t in zip(("state", "stats"), got, want):
        for f, g, w in zip(g_t._fields, g_t, w_t):
            g, w = g.numpy(), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (part, f, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{part}.{f}")


def _shared(jcfg, seed, n):
    ju = japi.make_units(jcfg, seed, n, n)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    return ju, config_from_fields(**dataclasses.asdict(jcfg)), tu


@pytest.mark.parametrize("name", list(jwdm.DRIFT_SCENARIOS))
def test_drift_timeline_arrays_equal(name):
    assert twdm.DRIFT_SCENARIOS[name] == jwdm.DRIFT_SCENARIOS[name]
    jcfg, jtl = jwdm.drift_timeline(name)
    tcfg, ttl = twdm.drift_timeline(name, device="cpu")
    assert tcfg.grid.n_ch == jcfg.grid.n_ch and tcfg.grid.grid_spacing == jcfg.grid.grid_spacing
    _tl_equal(ttl, jtl)
    assert ttl.n_steps == jtl.n_steps and ttl.n_ch == jtl.n_ch


@pytest.mark.parametrize("kw", [
    {},
    {"thermal": 0.37},
    {"aging": 0.5, "thermal": [[0, 0.0], [3, 0.6], [6, 0.1]]},
    {"comb": (0.41, 5.0)},
    {"comb": np.linspace(-0.2, 0.3, 7)},
    {"thermal": 0.2, "events": EVENTS},
], ids=["none", "ramp", "aging-breakpoints", "comb-sine", "comb-array", "events"])
def test_make_timeline_arrays_equal(kw):
    _tl_equal(ttemp.make_timeline(7, 5, device="cpu", **kw), jtemp.make_timeline(7, 5, **kw))


def test_make_timeline_rejects_bad_specs():
    with pytest.raises(ValueError, match="event kind"):
        ttemp.make_timeline(3, 4, events=((1, "lane_melt", 0),), device="cpu")
    with pytest.raises(ValueError, match="drift spec"):
        ttemp.make_timeline(3, 4, thermal=np.zeros(5), device="cpu")


def test_slice_timeline_equals_reference():
    kw = dict(thermal=0.3, events=EVENTS)
    jtl, ttl = jtemp.make_timeline(5, 4, **kw), ttemp.make_timeline(5, 4, device="cpu", **kw)
    for start, stop in ((0, 2), (2, None), (1, 4)):
        _tl_equal(ttemp.slice_timeline(ttl, start, stop), jtemp.slice_timeline(jtl, start, stop))


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("n_ch,seed,tr_mean", CASES)
def test_run_timeline_matches_reference(n_ch, seed, tr_mean, warm):
    jcfg = ArbitrationConfig(grid=DWDMGrid(n_ch=n_ch))
    ju, tcfg, tu = _shared(jcfg, seed, 3)
    jtl = jtemp.make_timeline(4, n_ch, thermal=0.3, events=EVENTS)
    ttl = timeline_from_numpy(*(np.asarray(a) for a in jtl), device="cpu")
    var = {"tr_mean": tr_mean}
    _run_equal(ttemp.run_timeline(tcfg, tu, ttl, var, warm=warm),
               jtemp.run_timeline(jcfg, ju, jtl, var, warm=warm))


def test_run_timeline_wdm16_drift_scenario():
    """fig20's operating point (TR = 4 x grid spacing) on the hot-swap
    scenario at WDM16, warm, 3 x 3 units."""
    jcfg, jtl = jwdm.drift_timeline("wdm16-hotswap")
    _, ttl = twdm.drift_timeline("wdm16-hotswap", device="cpu")
    ju, tcfg, tu = _shared(jcfg, 33, 3)
    var = {"tr_mean": 4.0 * jcfg.grid.grid_spacing}
    _run_equal(ttemp.run_timeline(tcfg, tu, ttl, var),
               jtemp.run_timeline(jcfg, ju, jtl, var))


def test_run_timeline_hysteresis_and_one_shot_scheme():
    """A hysteresis margin on the warm path, and a one-shot arbiter
    (``seq_retry``) re-run cold every step."""
    jcfg = ArbitrationConfig(grid=DWDMGrid(n_ch=4))
    ju, tcfg, tu = _shared(jcfg, 2, 3)
    jtl = jtemp.make_timeline(3, 4, thermal=0.5, events=EVENTS[:2])
    ttl = timeline_from_numpy(*(np.asarray(a) for a in jtl), device="cpu")
    var = {"tr_mean": 3.0}
    _run_equal(ttemp.run_timeline(tcfg, tu, ttl, var, hysteresis=0.2),
               jtemp.run_timeline(jcfg, ju, jtl, var, hysteresis=0.2))
    _run_equal(ttemp.run_timeline(tcfg, tu, ttl, var, scheme="seq_retry", warm=False),
               jtemp.run_timeline(jcfg, ju, jtl, var, scheme="seq_retry", warm=False))
    with pytest.raises(ValueError, match="one-shot"):
        ttemp.run_timeline(tcfg, tu, ttl, var, scheme="seq_retry", warm=True)
    with pytest.raises(ValueError, match="one-shot"):
        ttemp.run_timeline(tcfg, tu, ttl, var, scheme="seq_retry", warm=False, trace=8)


@pytest.mark.parametrize("split", [1, 2, 3])
def test_slice_timeline_resume_equals_uninterrupted_run(split):
    _, tcfg, tu = _shared(ArbitrationConfig(grid=DWDMGrid(n_ch=8)), 1, 3)
    tl = ttemp.make_timeline(4, 8, thermal=0.3, events=EVENTS, device="cpu")
    var = {"tr_mean": 4.0}
    final, stats = ttemp.run_timeline(tcfg, tu, tl, var)
    head_state, head = ttemp.run_timeline(tcfg, tu, ttemp.slice_timeline(tl, 0, split), var)
    tail_state, tail = ttemp.run_timeline(tcfg, tu, ttemp.slice_timeline(tl, split), var,
                                          init_state=head_state)
    for a, b in zip(final, tail_state):
        assert torch.equal(a, b)
    for a, h, t in zip(stats, head, tail):
        assert torch.equal(a, torch.cat([h, t]))
