"""The port's interconnect runtime (``repro_torch.optics.interconnect``)
against the JAX reference on the CPU.

* parity: ``bringup``, then ``rearbitrate``, ``inject_link_failure([2])``,
  ``rearbitrate``, ``inject_link_failure([4])``, ``rearbitrate`` and the
  handle-less ``_cold_rearbitrate``, each step held against the same step
  of the reference: the reference tests' WDM8 fabric at TR 4.6 under
  ``vtrs_ssm``, a 3-pod WDM16 fabric at TR 0.25 FSR (zero- and dup-lock
  failures) and the WDM8 fabric under ``protocol_lta``;
* the same steps from the reference's bring-up handle carried across with
  ``convert.fabric_state_from_fields``: the warm repair on identical
  optics (the port's own bring-up draws each link's optics un-jitted,
  which can differ from the reference's jitted draw by an ulp);
* the reference's own properties (``tests/test_fabric.py``) on the port:
  warm repair is monotone and leaves healthy links untouched, killed links
  stay down with their lock rows broken, injection is idempotent and
  composes, and its two ``ValueError``s;
* ``expected_failure_rates`` against the reference's.

Tolerances: exact for every ``LinkHealth`` field, the rounds, the
handle's lock state and ``link_alive``.  ``expected_failure_rates`` as
counts of n x n trials exactly and within 1e-7 as floats: the reference's
jitted ``1 - mean`` can round an exact 0 to 6e-8.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import wdm as jwdm  # noqa: E402
from repro.optics import interconnect as jic  # noqa: E402
from repro_torch.configs import wdm as twdm  # noqa: E402
from repro_torch.convert import fabric_state_from_fields  # noqa: E402
from repro_torch.optics import interconnect as tic  # noqa: E402

#: name -> (pods, links_per_pod_pair, WDM config key, tr_mean, scheme, seed)
CASES = {
    "wdm8-vtrs_ssm": (2, 8, "wdm8-g200", 4.6, "vtrs_ssm", 0),
    "wdm16-3pod": (3, 2, "wdm16-g200", 0.25 * twdm.WDM16_G200.grid.fsr, "vtrs_ssm", 0),
    "wdm8-protocol_lta": (2, 8, "wdm8-g200", 4.6, "protocol_lta", 0),
}
STATE_FIELDS = ("lock", "entry", "cursor", "probes")


def _steps(mod, fab, cfg, **kw):
    """The runtime sequence after bring-up: [(label, state, rounds)]."""
    out = []
    cur, r = mod.rearbitrate(fab, cfg, **kw)
    out.append(("rearbitrate", cur, r))
    for link in (2, 4):
        cur = mod.inject_link_failure(cur, [link])
        out.append((f"inject {link}", cur, None))
        cur, r = mod.rearbitrate(cur, cfg, **kw)
        out.append((f"rearbitrate after {link}", cur, r))
    cold, r = mod._cold_rearbitrate(dataclasses.replace(fab, handle=None), cfg, seed=0,
                                    max_rounds=3, **kw)
    out.append(("cold", cold, r))
    return out


@functools.lru_cache(maxsize=None)
def _reference(name):
    pods, lpp, key, tr, scheme, seed = CASES[name]
    cfg = jwdm.WDM_CONFIGS[key]
    fab = jic.bringup(pods, lpp, cfg, tr_mean=tr, scheme=scheme, seed=seed)
    return fab, _steps(jic, fab, cfg)


def _hold(label, got, want):
    """Every ``LinkHealth`` and the handle's live state equal exactly."""
    assert [dataclasses.asdict(l) for l in got.links] == \
        [dataclasses.asdict(l) for l in want.links], label
    for l in got.links:
        assert all(type(v) in (int, str, type(None)) for v in dataclasses.asdict(l).values())
    assert (got.scheme, got.tr_mean) == (want.scheme, want.tr_mean)
    assert got.bandwidth_fraction == want.bandwidth_fraction, label
    assert got.min_link_bandwidth == want.min_link_bandwidth, label
    assert (got.handle is None) == (want.handle is None), label
    if want.handle is None:
        return
    for f in STATE_FIELDS:
        g, w = getattr(got.handle.state, f).numpy(), np.asarray(getattr(want.handle.state, f))
        assert g.dtype == w.dtype and g.shape == w.shape, (label, f)
        np.testing.assert_array_equal(g, w, err_msg=f"{label}: {f}")
    if want.handle.link_alive is None:
        assert got.handle.link_alive is None, label
    else:
        assert isinstance(got.handle.link_alive, np.ndarray), label
        np.testing.assert_array_equal(got.handle.link_alive, want.handle.link_alive)


def _hold_steps(got, want):
    for (label, g, g_r), (_, w, w_r) in zip(got, want, strict=True):
        assert g_r == w_r, (label, g_r, w_r)
        _hold(label, g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_runtime_sequence_matches_reference(name):
    pods, lpp, key, tr, scheme, seed = CASES[name]
    cfg = twdm.WDM_CONFIGS[key]
    ref_fab, ref_steps = _reference(name)
    fab = tic.bringup(pods, lpp, cfg, tr_mean=tr, scheme=scheme, seed=seed, device="cpu")
    _hold("bringup", fab, ref_fab)
    assert fab.degraded_links(), "the case must leave links for rearbitrate to repair"
    _hold_steps(_steps(tic, fab, cfg, device="cpu"), ref_steps)


@pytest.mark.parametrize("name", list(CASES))
def test_runtime_sequence_from_carried_handle(name):
    """The warm repair on the reference's own optics and lock state."""
    cfg = twdm.WDM_CONFIGS[CASES[name][2]]
    ref_fab, ref_steps = _reference(name)
    h = ref_fab.handle
    assert h.system.laser.shape == (2 * len(ref_fab.links), cfg.grid.n_ch)
    fab = fabric_state_from_fields(
        [dataclasses.asdict(l) for l in ref_fab.links], ref_fab.scheme, ref_fab.tr_mean,
        dataclasses.asdict(h.spec), [np.asarray(a) for a in h.system],
        [np.asarray(a) for a in h.state], h.link_alive, device="cpu")
    _hold("carried", fab, ref_fab)
    np.testing.assert_array_equal(fab.handle.system.laser.numpy(), np.asarray(h.system.laser))
    _hold_steps(_steps(tic, fab, cfg, device="cpu"), ref_steps)


def _fab(links_per_pair=8):
    cfg = twdm.WDM8_G200
    return cfg, tic.bringup(2, links_per_pair, cfg, tr_mean=4.6, scheme="vtrs_ssm",
                            seed=0, device="cpu")


def test_warm_rearbitrate_monotone_and_heals():
    cfg, fab = _fab()
    assert fab.handle is not None and len(fab.links) == 8
    assert fab.handle.system.laser.device.type == "cpu"
    healthy = {i: (l.lanes_up, l.spectral_shift)
               for i, l in enumerate(fab.links) if not l.degraded}
    fab2, rounds = tic.rearbitrate(fab, cfg, seed=1)
    assert fab2.bandwidth_fraction >= fab.bandwidth_fraction
    assert rounds <= 3
    for i, (lanes, shift) in healthy.items():
        assert (fab2.links[i].lanes_up, fab2.links[i].spectral_shift) == (lanes, shift)
    # record-level degradation heals from the carried live state
    l = fab2.links[0]
    fab2.links[0] = dataclasses.replace(l, lanes_up=max(0, l.lanes_up - 2),
                                        failure="zero_lock")
    fab3, _ = tic.rearbitrate(fab2, cfg, seed=2)
    assert fab3.links[0].lanes_up >= l.lanes_up
    # handle-less states take the cold path and stay monotone
    cold = dataclasses.replace(fab, handle=None)
    cold2, _ = tic.rearbitrate(cold, cfg, seed=5, device="cpu")
    assert cold2.bandwidth_fraction >= cold.bandwidth_fraction
    assert cold2.handle is None


def test_rearbitrate_under_link_death():
    cfg, fab = _fab(6)
    with pytest.raises(ValueError, match="outside"):
        tic.inject_link_failure(fab, [6])
    with pytest.raises(ValueError, match="handle"):
        tic.inject_link_failure(dataclasses.replace(fab, handle=None), [0])

    hurt = tic.inject_link_failure(fab, [2])
    assert hurt.links[2].lanes_up == 0 and hurt.links[2].failure == "link_down"
    assert not hurt.handle.link_alive[2] and hurt.handle.link_alive[[0, 1]].all()
    assert fab.handle.link_alive is None  # the input state is untouched
    before = {i: l.lanes_up for i, l in enumerate(fab.links)}

    fab2, _ = tic.rearbitrate(hurt, cfg, seed=1)
    assert fab2.links[2].lanes_up == 0 and fab2.links[2].failure == "link_down"
    lock = fab2.handle.state.lock.reshape(-1, 2, cfg.grid.n_ch)
    assert bool((lock[2] < 0).all())
    for i, l in enumerate(fab2.links):
        if i != 2:
            assert l.lanes_up >= before[i]

    hurt2 = tic.inject_link_failure(fab2, [4])
    assert not hurt2.handle.link_alive[2]
    fab3, _ = tic.rearbitrate(hurt2, cfg, seed=2)
    assert fab3.links[4].lanes_up == 0 and fab3.links[2].lanes_up == 0
    for i, l in enumerate(fab3.links):
        if i not in (2, 4):
            assert l.lanes_up >= fab2.links[i].lanes_up
    again = tic.inject_link_failure(fab3, [2])
    assert again.links[2].lanes_up == 0
    np.testing.assert_array_equal(again.handle.link_alive, fab3.handle.link_alive)


def test_link_health_properties():
    l = tic.LinkHealth(0, 1, 3, lanes_total=8, lanes_up=6, spectral_shift=2,
                       failure="zero_lock")
    assert l.bandwidth_gbps == 6 * tic.LINK_GBPS_PER_LANE and l.degraded
    st = tic.FabricState(links=[l, dataclasses.replace(l, lanes_up=8, failure=None)],
                         scheme="vtrs_ssm", tr_mean=4.6)
    assert st.min_link_bandwidth == l.bandwidth_gbps
    assert st.bandwidth_fraction == 0.75 and st.degraded_links() == [l]
    empty = tic.FabricState(links=[], scheme="vtrs_ssm", tr_mean=4.6)
    assert empty.bandwidth_fraction == 1.0 and empty.min_link_bandwidth == 0.0


@pytest.mark.parametrize("tr", [4.6, 8.96])
def test_expected_failure_rates_match_reference(tr):
    n = 16
    got = tic.expected_failure_rates(twdm.WDM8_G200, tr, n=n, device="cpu")
    want = jic.expected_failure_rates(jwdm.WDM8_G200, tr, n=n)
    assert set(got) == set(want) == {"afp", "cafp", "total_failure"}
    for k in got:
        assert round(got[k] * n * n) == round(want[k] * n * n), k
        assert abs(got[k] - want[k]) <= 1e-7, k
