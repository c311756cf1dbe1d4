"""The port's main path against the JAX reference on identical inputs, on
the CPU: sampling and variations, relation search, single-step matching,
sequential tuning, outcome classification and the evaluation entry points.

Tolerances: every integer and boolean output is held exactly, float32 system
fields and tuning distances bit for bit.  AFP and CAFP are compared as
integer failure counts, exactly; the float metrics are compared within 1e-7,
because the reference's jitted ``1 - mean`` rounds to a nonzero AFP on an
all-success batch (about -7.5e-9 at 64 trials).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core.grid import wdm_config  # noqa: E402
from repro.core.outcomes import classify as jclassify  # noqa: E402
from repro.core.relation import chain_spec as jchain  # noqa: E402
from repro.core.relation import relation_search as jrelation  # noqa: E402
from repro.core.sampling import instantiate as jinst  # noqa: E402
from repro.core.search_table import build_search_tables_dense as jbuild  # noqa: E402
from repro.core.sequential import sequential_tuning as jseq  # noqa: E402
from repro.core.ssm import single_step_matching as jssm  # noqa: E402
from repro.core.variations import Variations as JVar  # noqa: E402
from repro_torch.convert import config_from_fields, units_from_numpy  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core.outcomes import classify as tclassify  # noqa: E402
from repro_torch.core.relation import RI_PHI  # noqa: E402
from repro_torch.core.relation import chain_spec as tchain  # noqa: E402
from repro_torch.core.relation import relation_search as trelation  # noqa: E402
from repro_torch.core.sampling import instantiate as tinst  # noqa: E402
from repro_torch.core.search_table import build_search_tables as tbuild  # noqa: E402
from repro_torch.core.sequential import sequential_tuning as tseq  # noqa: E402
from repro_torch.core.ssm import single_step_matching as tssm  # noqa: E402
from repro_torch.core.variations import Variations as TVar  # noqa: E402

CFGS = {
    "wdm4-natural": wdm_config(n_ch=4),
    "wdm4-permuted": wdm_config(n_ch=4).with_orders("permuted"),
    "wdm8-natural": wdm_config(n_ch=8),
    "wdm8-permuted": wdm_config(n_ch=8).with_orders("permuted"),
}
SCHEMES = ("seq", "rs_ssm", "vtrs_ssm")
WIDE = {"wdm16-natural": wdm_config(n_ch=16), "wdm32-natural": wdm_config(n_ch=32)}


def _pair(name, seed=3, n_laser=8, n_ring=8):
    """The reference's unit samples and config, and the port's copies."""
    jcfg = {**CFGS, **WIDE}[name]
    ju = japi.make_units(jcfg, seed, n_laser, n_ring)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    return jcfg, ju, config_from_fields(**dataclasses.asdict(jcfg)), tu


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


OVERRIDES = [
    {},
    {"sigma_rlv": 3.5, "sigma_go": 7.0},
    {"fsr_mean": 9.5, "sigma_fsr_frac": 0.03, "sigma_tr_frac": 0.2},
    {"sigma_llv_frac": 0.4},
    {"thermal_drift": 0.7},
    {"comb_wander": -0.4, "ring_aging": 1.3},
]


@pytest.mark.parametrize("over", OVERRIDES, ids=lambda o: "-".join(o) or "default")
@pytest.mark.parametrize("name", list(CFGS))
def test_system_batch_bit_for_bit(name, over):
    jcfg, ju, tcfg, tu = _pair(name)
    js = jinst(jcfg, ju, JVar(**over))
    ts = tinst(tcfg, tu, TVar(**over))
    for field in js._fields:
        assert getattr(ts, field).dtype == torch.float32
        np.testing.assert_array_equal(_bits(getattr(ts, field).numpy()),
                                      _bits(getattr(js, field)), err_msg=field)


@pytest.mark.parametrize("n_laser,n_ring", [(1, 5), (5, 1), (1, 1)])
def test_system_batch_single_sample_axes_dense(n_laser, n_ring):
    """One laser or ring sample still gives dense (T, N) rows, as the
    kernels require, equal to the reference."""
    jcfg, ju, tcfg, tu = _pair("wdm8-natural", n_laser=n_laser, n_ring=n_ring)
    js, ts = jinst(jcfg, ju), tinst(tcfg, tu)
    for field in js._fields:
        assert getattr(ts, field).is_contiguous(), field
        np.testing.assert_array_equal(_bits(getattr(ts, field).numpy()),
                                      _bits(getattr(js, field)), err_msg=field)


def test_config_round_trip_and_variations_rules():
    jcfg = CFGS["wdm8-permuted"]
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(tcfg.chain, jcfg.chain)
    assert TVar(sigma_rlv=None).names == () and len(TVar(tr_mean=5.0)) == 1
    with pytest.raises(ValueError, match="unknown variation axis"):
        TVar(sigma_bogus=1.0)
    with pytest.raises(ValueError, match=">= 0"):
        TVar(sigma_rlv=-1.0)
    with pytest.raises(ValueError, match="twice"):
        TVar(sigma_rlv=1.0).merge({"sigma_rlv": 2.0})
    with pytest.raises(AttributeError):
        TVar().x = 1
    assert TVar(tr_mean=5.0).replace(tr_mean=None).names == ()
    assert TVar().resolve("tr_mean", tcfg) == jcfg.grid.tr_mean


@pytest.mark.parametrize("tr", [5.0, 8.96, 20.0])
@pytest.mark.parametrize("name", list(CFGS))
def test_arbiters_match_reference(name, tr):
    """relation_search (RS and VT-RS), single-step matching, sequential
    tuning and every Outcome field, exactly, under each ideal policy.  The
    reference arbiters read the dense oracle's tables, whose delta the
    port's tables equal bit for bit (wl and n_valid equal the streaming
    builder's too; see test_torch_kernels.py)."""
    jcfg, ju, tcfg, tu = _pair(name)
    jt = jbuild(jinst(jcfg, ju), tr)
    tt = tbuild(tinst(tcfg, tu), tr)
    jspec, tspec = jchain(jcfg.s), tchain(tcfg.s)
    for field in jspec._fields:
        _eq(getattr(tspec, field), getattr(jspec, field))
    assigns = []
    for vt in (False, True):
        ri_j = jrelation(jt, jspec, variation_tolerant=vt)
        ri_t = trelation(tt, tspec, variation_tolerant=vt)
        assert ri_t.dtype == torch.int32
        _eq(ri_t.numpy(), ri_j)
        assigns.append((tssm(tt, ri_t, tspec), jssm(jt, ri_j, jspec)))
    assigns.append((tseq(tt, tspec), jseq(jt, jspec)))
    for a_t, a_j in assigns:
        assert a_t.entry.dtype == torch.int32 and a_t.wl.dtype == torch.int32
        _eq(a_t.entry.numpy(), a_j.entry)
        _eq(a_t.wl.numpy(), a_j.wl)
        _eq(_bits(a_t.delta.numpy()), _bits(a_j.delta))
        for policy in ("ltd", "ltc", "lta"):
            o_t = tclassify(a_t, tcfg.s, policy=policy)
            o_j = jclassify(a_j, jnp.asarray(jcfg.s), policy=policy)
            for field in o_j._fields:
                _eq(getattr(o_t, field).numpy(), getattr(o_j, field))


def test_relation_search_phi_cuts_present():
    """The comparison above covers RI = phi cuts and wrapped sub-chains."""
    jcfg, ju, tcfg, tu = _pair("wdm8-permuted", n_laser=16, n_ring=16)
    ri = trelation(tbuild(tinst(tcfg, tu), 5.0), tchain(tcfg.s))
    cut = (ri == int(RI_PHI)).numpy()
    assert cut.any() and (~cut).all(axis=1).any()


def _counts(x):
    return int(np.asarray(x).sum())


@pytest.mark.parametrize("tr", [5.0, 8.96])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", ["wdm4-permuted", "wdm8-natural", "wdm8-permuted"])
def test_evaluate_scheme_matches_reference(name, scheme, tr):
    jcfg, ju, tcfg, tu = _pair(name)
    _hold_eval(tapi.evaluate_scheme(tcfg, tu, scheme, tr),
               japi.evaluate_scheme(jcfg, ju, scheme, tr))


@pytest.mark.parametrize("tr", [4.48, 8.96])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", list(WIDE))
def test_evaluate_scheme_wide_matches_reference_impl(name, scheme, tr):
    """WDM16 and WDM32 on 30 trials, against the reference's un-jitted body
    (its jitted ``instantiate`` fuses a multiply-add that the port does not
    take; see test_torch_lta.py).  TR 4.48 is the temporal path's operating
    point, where the ideal arbiter fails on some trials."""
    jcfg, ju, tcfg, tu = _pair(name, n_laser=5, n_ring=6)
    _hold_eval(tapi.evaluate_scheme(tcfg, tu, scheme, tr),
               japi.evaluate_scheme_impl(jcfg, ju, scheme, tr))


def _hold_eval(r, jr):
    """Per-trial outcomes exactly, AFP and CAFP as failure counts exactly,
    the float metrics within 1e-7."""
    _eq(r.ideal_ok.numpy(), jr.ideal_ok)
    _eq(r.alg_success.numpy(), jr.alg_success)
    t = r.ideal_ok.shape[0]
    ideal_fail = _counts(~r.ideal_ok.numpy())
    cond_fail = _counts(~r.alg_success.numpy() & r.ideal_ok.numpy())
    assert ideal_fail == _counts(~np.asarray(jr.ideal_ok))
    assert cond_fail == _counts(~np.asarray(jr.alg_success) & np.asarray(jr.ideal_ok))
    for res in (r, jr):
        assert round(float(res.afp) * t) == ideal_fail
        assert round(float(res.cafp) * t) == cond_fail
    for field in ("afp", "cafp", "lock_err", "order_err"):
        assert abs(float(getattr(r, field)) - float(getattr(jr, field))) <= 1e-7, field
    total = float(tmetrics.total_failure(r.alg_success, r.ideal_ok))
    assert abs(total - float(jmetrics.total_failure(jr.alg_success, jr.ideal_ok))) <= 1e-7


@pytest.mark.parametrize("policy", ["ltc", "ltd"])
@pytest.mark.parametrize("name", ["wdm4-natural", "wdm8-natural", "wdm8-permuted"])
def test_policy_entry_points_match_reference(name, policy):
    jcfg, ju, tcfg, tu = _pair(name)
    for tr in (5.0, 8.96, 12.0):
        a_j = float(japi.evaluate_policy(jcfg, ju, policy, tr))
        a_t = float(tapi.evaluate_policy(tcfg, tu, policy, tr))
        assert round(a_t * 64) == round(a_j * 64) and abs(a_t - a_j) <= 1e-7
    over = {"sigma_rlv": 3.0}
    m_j = japi.policy_min_tr(jcfg, ju, policy, JVar(**over))
    m_t = tapi.policy_min_tr(tcfg, tu, policy, TVar(**over))
    _eq(_bits(m_t.numpy()), _bits(m_j))
    with pytest.raises(ValueError, match="tr_mean"):
        tapi.policy_min_tr(tcfg, tu, policy, TVar(tr_mean=5.0))


def test_evaluate_scheme_variations_and_tr_conflict():
    jcfg, ju, tcfg, tu = _pair("wdm8-permuted")
    over = {"tr_mean": 6.0, "sigma_rlv": 3.0, "thermal_drift": 0.5}
    jr = japi.evaluate_scheme(jcfg, ju, "vtrs_ssm", variations=JVar(**over))
    r = tapi.evaluate_scheme(tcfg, tu, "vtrs_ssm", variations=TVar(**over))
    _eq(r.ideal_ok.numpy(), jr.ideal_ok)
    _eq(r.alg_success.numpy(), jr.alg_success)
    with pytest.raises(ValueError, match="both"):
        tapi.evaluate_scheme(tcfg, tu, "seq", 5.0, TVar(tr_mean=6.0))


@pytest.mark.parametrize("vis_kind", ["2d", "3d"])
def test_oblivious_arbitrate_masked_research(vis_kind):
    jcfg, ju, tcfg, tu = _pair("wdm8-natural")
    rng = np.random.default_rng(9)
    vis = rng.random((64, 8) if vis_kind == "2d" else (64, 8, 8)) < 0.8
    for scheme in SCHEMES:
        a_j = japi.oblivious_arbitrate(jcfg, jinst(jcfg, ju), 8.96, scheme,
                                       visible=jnp.asarray(vis))
        a_t = tapi.oblivious_arbitrate(tcfg, tinst(tcfg, tu), 8.96, scheme,
                                       visible=torch.from_numpy(vis))
        _eq(a_t.entry.numpy(), a_j.entry)
        _eq(a_t.wl.numpy(), a_j.wl)
