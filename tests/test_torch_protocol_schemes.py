"""The port's protocol-engine schemes through ``evaluate_scheme`` against the
JAX reference's on identical unit samples, on the CPU: the whole path, the
port's own search tables included.

Cases: ``protocol_lta``, ``_h1``, ``_h2``, ``_h4`` and ``protocol_ltd`` at
WDM4 and WDM8, natural and permuted, 8 x 8 units, TR 3.5 and 8.96; and the
fig19 miniature (WDM8, 10 x 10 units, seed 21, six TRs from 0.28 to 9.0),
where ``seq_retry`` leaves residual CAFP that full multi-hop augmenting
closes.

Tolerances: per-trial ``ideal_ok`` and ``alg_success`` exact; AFP and CAFP as
exact integer failure counts; the float metrics within 1e-7 (the reference's
jitted ``1 - mean`` rounds to a nonzero AFP on an all-success batch).  Each
(config, scheme) pair is one compilation of the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro.core.grid import wdm_config  # noqa: E402
from repro_torch.convert import config_from_fields, units_from_numpy  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402

CFGS = {
    "wdm4-natural": wdm_config(n_ch=4),
    "wdm4-permuted": wdm_config(n_ch=4).with_orders("permuted"),
    "wdm8-natural": wdm_config(n_ch=8),
    "wdm8-permuted": wdm_config(n_ch=8).with_orders("permuted"),
}
SCHEMES = {"protocol_lta": "lta", "protocol_lta_h1": "lta", "protocol_lta_h2": "lta",
           "protocol_lta_h4": "lta", "protocol_ltd": "ltd"}


def _shared(jcfg, seed, n_laser, n_ring):
    ju = japi.make_units(jcfg, seed, n_laser, n_ring)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    return ju, config_from_fields(**dataclasses.asdict(jcfg)), tu


def _compare(r, jr):
    """Per-trial flags exact, AFP/CAFP as exact counts, floats within 1e-7."""
    np.testing.assert_array_equal(r.ideal_ok.numpy(), np.asarray(jr.ideal_ok))
    np.testing.assert_array_equal(r.alg_success.numpy(), np.asarray(jr.alg_success))
    t = r.ideal_ok.shape[0]
    ideal_fail = int((~r.ideal_ok).sum())
    cond_fail = int((~r.alg_success & r.ideal_ok).sum())
    for res in (r, jr):
        assert round(float(res.afp) * t) == ideal_fail
        assert round(float(res.cafp) * t) == cond_fail
    for field in ("afp", "cafp", "lock_err", "order_err"):
        assert abs(float(getattr(r, field)) - float(getattr(jr, field))) <= 1e-7, field
    return cond_fail


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("name", list(CFGS))
def test_evaluate_protocol_scheme_matches_reference(name, scheme):
    jcfg = CFGS[name]
    ju, tcfg, tu = _shared(jcfg, 3, 8, 8)
    assert tapi.scheme_spec(scheme).policy == SCHEMES[scheme]
    for tr in (3.5, 8.96):
        _compare(tapi.evaluate_scheme(tcfg, tu, scheme, tr),
                 japi.evaluate_scheme(jcfg, ju, scheme, tr))


def test_fig19_miniature_protocol_closes_seq_retry_residual():
    """The reference's fig19 acceptance in miniature, point by point through
    ``evaluate_scheme`` (the port has no sweep engine yet): both schemes'
    per-trial outcomes equal the reference's, ``seq_retry`` leaves residual
    CAFP, and ``protocol_lta`` closes it."""
    jcfg = wdm_config(n_ch=8)
    ju, tcfg, tu = _shared(jcfg, 21, 10, 10)
    trs = np.linspace(0.28, 9.0, 6).astype(np.float32)
    cafp = {}
    for scheme in ("seq_retry", "protocol_lta"):
        cafp[scheme] = np.array([
            _compare(tapi.evaluate_scheme(tcfg, tu, scheme, float(tr)),
                     japi.evaluate_scheme(jcfg, ju, scheme, float(tr)))
            for tr in trs
        ]) / 100.0
    residual = cafp["seq_retry"] > 0.0
    assert residual.any(), "expected seq_retry residual on this grid"
    assert float(cafp["protocol_lta"][residual].max()) <= 1e-3
