"""The port's ``seq_retry`` schemes through ``evaluate_scheme`` against the
JAX reference's on identical inputs, on the CPU, at WDM4 and WDM8 natural
and permuted, 8 x 8 units.

Tolerances: per-trial ``ideal_ok`` and ``alg_success`` exact; AFP and CAFP as
exact integer failure counts; the float metrics within 1e-7 (the
reference's jitted ``1 - mean`` rounds to a nonzero AFP on an all-success
batch).  Each (config, scheme) pair is one compilation of the reference.
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
SCHEMES = ("seq_retry", "seq_retry_r1", "seq_retry_r2", "seq_retry_r4",
           "seq_retry_phys")


def _counts(x):
    return int(np.asarray(x).sum())


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", list(CFGS))
def test_evaluate_seq_retry_matches_reference(name, scheme):
    jcfg = CFGS[name]
    ju = japi.make_units(jcfg, 3, 8, 8)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    assert tapi.scheme_spec(scheme).policy == "lta"
    for tr in (3.5, 8.96):
        jr = japi.evaluate_scheme(jcfg, ju, scheme, tr)
        r = tapi.evaluate_scheme(tcfg, tu, scheme, tr)
        np.testing.assert_array_equal(r.ideal_ok.numpy(), np.asarray(jr.ideal_ok))
        np.testing.assert_array_equal(r.alg_success.numpy(), np.asarray(jr.alg_success))
        t = r.ideal_ok.shape[0]
        ideal_fail = _counts(~r.ideal_ok.numpy())
        cond_fail = _counts(~r.alg_success.numpy() & r.ideal_ok.numpy())
        for res in (r, jr):
            assert round(float(res.afp) * t) == ideal_fail
            assert round(float(res.cafp) * t) == cond_fail
        for field in ("afp", "cafp", "lock_err", "order_err"):
            assert abs(float(getattr(r, field)) - float(getattr(jr, field))) <= 1e-7, field
