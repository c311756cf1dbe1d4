"""The port's sweep engine (``repro_torch.core.sweep``) against the JAX
reference's unsharded ``sweep`` on identical inputs, on the CPU.

Units are the reference's draws (6 x 6 at WDM8 natural and permuted, one
WDM16 case) handed to the port as numpy arrays; grids are the reference's
3 x 3 test grids (tests/test_sweep.py).  The port flattens a chunk of grid
points into one batch of trials, so each grid is also held against the
port's own per-point loop (``sweep_reference``), across chunk sizes, and the
TR fast path against the direct path.  A record check holds the port's
``seq_retry`` sweep at the fig17 setting against ``BENCH_sweep.json``.

Tolerances: integer and boolean outputs exactly; AFP, CAFP and the error
shares as integer counts (share x trials), exactly; the float shares within
1e-7 (the reference computes ``1 - mean`` in float32, the port the failure
count over T; ROADMAP queue 3); ``min_tr`` bit for bit; timeline statistics
(trial means) as integer sums, exactly.
"""
import dataclasses
import importlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import wdm as jwdm  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import temporal as jtemp  # noqa: E402
from repro.core import variations as jvar  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_fields,
    timeline_from_numpy,
    units_from_numpy,
)
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import variations as tvar  # noqa: E402
from repro_torch.core.sampling import instantiate as tinst  # noqa: E402
from repro_torch.core.temporal import make_timeline  # noqa: E402
from repro_torch.kernels.bitmask_match import perfect_matching  # noqa: E402
from repro_torch.kernels.table_build import build_tables  # noqa: E402

# The modules: both packages export the function ``sweep`` over the name.
jsw = importlib.import_module("repro.core.sweep")
tsw = importlib.import_module("repro_torch.core.sweep")

ROOT = Path(__file__).resolve().parents[1]
RLVS = np.array([0.28, 1.12, 2.24], np.float32)
TRS = np.array([2.0, 5.0, 9.5], np.float32)
AXES = {"sigma_rlv": RLVS, "tr_mean": TRS}
CFGS = {"wdm8-natural": jwdm.WDM8_G200, "wdm8-permuted": jwdm.WDM8_G200.with_orders("permuted"),
        "wdm16-natural": jwdm.WDM16_G200}
FLOAT_FIELDS = ("afp", "cafp", "lock_err", "order_err")


def _pair(name, seed=4, n=6):
    jcfg = CFGS[name]
    ju = japi.make_units(jcfg, seed, n, n)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    return jcfg, ju, config_from_fields(**dataclasses.asdict(jcfg)), tu


def _counts(share, t):
    return np.rint(np.asarray(share, np.float64) * t).astype(np.int64)


def _hold_shares(got, want, t):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_counts(got, t), _counts(want, t))
    assert np.abs(got - want).max() <= 1e-7


def _hold_eval(got, want, t):
    """EvalResult grids: per-trial outcomes exactly, shares as counts."""
    for f in ("alg_success", "ideal_ok"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype == bool and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in FLOAT_FIELDS:
        _hold_shares(getattr(got, f).numpy(), getattr(want, f), t)


def _equal_tree(a, b):
    for x, y in zip(a, b) if isinstance(a, tuple) else ((a, b),):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("policy", ["ltc", "ltd", "lta"])
@pytest.mark.parametrize("name", ["wdm8-natural", "wdm8-permuted"])
def test_policy_sweep_matches_reference(name, policy):
    """AFP grids with and without the TR fast path, against the reference's
    sweep; the fast path equals the direct path bit for bit."""
    jcfg, ju, tcfg, tu = _pair(name)
    want = np.asarray(jsw.sweep_policy(jcfg, ju, policy, AXES))
    fast = tsw.sweep_policy(tcfg, tu, policy, AXES)
    direct = tsw.sweep_policy(tcfg, tu, policy, AXES, tr_fast=False)
    assert fast.dtype == torch.float32 and tuple(fast.shape) == (3, 3)
    _hold_shares(fast.numpy(), want, 36)
    assert torch.equal(fast, direct)


@pytest.mark.parametrize("policy", ["ltc", "ltd", "lta"])
@pytest.mark.parametrize("name", ["wdm8-natural", "wdm8-permuted", "wdm16-natural"])
def test_min_tr_sweep_matches_reference(name, policy):
    jcfg, ju, tcfg, tu = _pair(name)
    axes = {"sigma_rlv": RLVS}
    want = np.asarray(jsw.sweep_min_tr(jcfg, ju, policy, axes))
    got = tsw.sweep_min_tr(tcfg, tu, policy, axes).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name,scheme", [
    ("wdm8-natural", "seq"), ("wdm8-permuted", "seq"),
    ("wdm8-natural", "vtrs_ssm"), ("wdm8-permuted", "vtrs_ssm"),
    ("wdm8-natural", "seq_retry"),
    ("wdm8-natural", "protocol_lta"), ("wdm8-permuted", "protocol_lta"),
    ("wdm16-natural", "vtrs_ssm"),
])
def test_scheme_sweep_matches_reference(name, scheme):
    jcfg, ju, tcfg, tu = _pair(name, n=6 if name.startswith("wdm8") else 4)
    got = tsw.sweep_scheme(tcfg, tu, scheme, AXES)
    assert tuple(got.alg_success.shape) == (3, 3, tu.u_go.shape[0] * tu.u_rlv.shape[0])
    _hold_eval(got, jsw.sweep_scheme(jcfg, ju, scheme, AXES), got.ideal_ok.shape[-1])


def test_fixed_overrides_match_reference():
    """``fixed=`` values are float32 like the axis values: sigma_llv_frac =
    0.3 is where a double-precision product with the grid spacing would
    round differently from the reference's float32 one."""
    jcfg, ju, tcfg, tu = _pair("wdm8-permuted")
    fixed = {"sigma_fsr_frac": 0.05, "sigma_tr_frac": 0.2, "sigma_llv_frac": 0.3}
    _hold_eval(tsw.sweep_scheme(tcfg, tu, "vtrs_ssm", AXES, fixed=fixed),
               jsw.sweep_scheme(jcfg, ju, "vtrs_ssm", AXES, fixed=fixed), 36)
    axes = {"sigma_go": np.array([3.0, 15.0], np.float32)}
    want = np.asarray(jsw.sweep_min_tr(jcfg, ju, "ltc", axes, fixed=fixed))
    got = tsw.sweep_min_tr(tcfg, tu, "ltc", axes, fixed=fixed).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_per_point_batch_equals_single_points():
    """Each point's rows of a flattened batch equal the single-point batch at
    that point's value, bit for bit, on fig7's sigma_llv_frac axis and fig8's
    fsr_mean axis (float32 products with the grid spacing and the FSR)."""
    _, _, tcfg, tu = _pair("wdm8-natural")
    t = 36
    for name, values in (("sigma_llv_frac", [0.1, 0.15, 0.3, 0.45]),
                         ("fsr_mean", [7.5, 8.96, 9.3]),
                         ("thermal_drift", [0.0, 0.7, -1.3])):
        vals = torch.tensor(values, dtype=torch.float32)
        batch = tinst(tcfg, tu, tvar.Variations(sigma_rlv=3.0, **{name: vals}))
        for p, v in enumerate(values):
            one = tinst(tcfg, tu, tvar.Variations(sigma_rlv=3.0, **{name: np.float32(v)}))
            for f, a, b in zip(one._fields, batch, one):
                assert torch.equal(a[p * t:(p + 1) * t].view(torch.int32),
                                   b.view(torch.int32)), (name, v, f)


@pytest.fixture
def heater_axis():
    """A test axis registered in both packages: a uniform laser red-shift."""
    name = "tv_laser_heater"
    for mod in (jvar, tvar):
        mod.register_axis(name, lambda cfg: 0.0, doc="test axis",
                          transform=lambda sys, value, cfg: sys._replace(laser=sys.laser + value))
    yield name
    for mod in (jvar, tvar):
        mod._AXIS_REGISTRY.pop(name, None)


def test_registered_axis_is_sweepable(heater_axis):
    jcfg, ju, tcfg, tu = _pair("wdm8-natural")
    axes = {heater_axis: np.array([0.0, 0.5], np.float32), "tr_mean": TRS}
    want = np.asarray(jsw.sweep(jsw.SweepRequest(cfg=jcfg, units=ju, policy="ltc",
                                                 axes=axes)).data)
    got = tsw.sweep(tsw.SweepRequest(cfg=tcfg, units=tu, policy="ltc", axes=axes)).data
    _hold_shares(got.numpy(), want, 36)
    base = tsw.sweep(tsw.SweepRequest(cfg=tcfg, units=tu, policy="ltc",
                                      axes={"tr_mean": TRS})).data
    assert torch.equal(got[0], base)


def test_timeline_sweep_matches_reference():
    """Trial-mean TemporalStats grids with a trailing step axis, as the
    reference's sweep gives them (its test_sweep_timeline_integration)."""
    n_ch = 8
    jcfg = jwdm.WDM8_G200
    ju = japi.make_units(jcfg, 2, 3, 3)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    jtl = jtemp.make_timeline(3, n_ch, thermal=0.2, events=((1, "lane_kill", 3),))
    ttl = timeline_from_numpy(*(np.asarray(a) for a in jtl), device="cpu")
    kw = dict(scheme="protocol_lta", axes={"sigma_rlv": np.array([0.2, 0.4, 2.24])},
              fixed={"tr_mean": 5.0})
    want = jsw.sweep(jsw.SweepRequest(cfg=jcfg, units=ju, timeline=jtl, **kw)).data
    got = tsw.sweep(tsw.SweepRequest(cfg=tcfg, units=tu, timeline=ttl, **kw)).data
    for f, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape == (3, 3), f
        np.testing.assert_array_equal(_counts(g.numpy(), 9), _counts(w, 9), err_msg=f)
    one = tsw.sweep(tsw.SweepRequest(cfg=tcfg, units=tu, timeline=ttl, chunk_size=1, **kw)).data
    _equal_tree(got, one)


@pytest.mark.parametrize("kind", ["scheme", "policy direct", "min_tr", "policy fast"])
def test_chunk_size_invariance(kind):
    """Any chunk size gives the same grids, bit for bit: 1, 2 (a smaller
    last chunk) and all P points at once."""
    _, _, tcfg, tu = _pair("wdm8-permuted")
    kw = {"scheme": dict(scheme="seq", axes=AXES),
          "policy direct": dict(policy="lta", axes=AXES, tr_fast=False),
          "min_tr": dict(policy="lta", metric="min_tr", axes={"sigma_rlv": RLVS}),
          "policy fast": dict(policy="ltc", axes={"sigma_rlv": RLVS, "sigma_go": RLVS,
                                                  "tr_mean": TRS})}[kind]
    grids = [tsw.sweep(tsw.SweepRequest(cfg=tcfg, units=tu, chunk_size=c, **kw)).data
             for c in (1, 2, 9, None)]
    for g in grids[1:]:
        _equal_tree(grids[0], g)


def test_axis_order_follows_the_mapping():
    _, _, tcfg, tu = _pair("wdm8-natural")
    a = tsw.sweep(tsw.SweepRequest(cfg=tcfg, units=tu, scheme="seq", axes=AXES))
    b = tsw.sweep(tsw.SweepRequest(cfg=tcfg, units=tu, scheme="seq",
                                   axes={"tr_mean": TRS, "sigma_rlv": RLVS}))
    assert a.axis_names == ("sigma_rlv", "tr_mean") and b.axis_names == ("tr_mean", "sigma_rlv")
    np.testing.assert_array_equal(b.axis("tr_mean"), TRS)
    assert torch.equal(a.data.cafp, b.data.cafp.T)
    assert torch.equal(a.data.alg_success, b.data.alg_success.transpose(0, 1))
    with pytest.raises(ValueError, match="no axis"):
        a.axis("sigma_go")
    fast = tsw.sweep(tsw.SweepRequest(cfg=tcfg, units=tu, policy="ltc",
                                      axes={"tr_mean": TRS, "sigma_rlv": RLVS}))
    direct = tsw.sweep(tsw.SweepRequest(cfg=tcfg, units=tu, policy="ltc", axes=AXES))
    assert fast.axis_names == ("tr_mean", "sigma_rlv")
    assert torch.equal(fast.data, direct.data.T)


@pytest.mark.parametrize("target", [dict(policy="lta"), dict(policy="ltd", tr_fast=False),
                                    dict(policy="ltc", metric="min_tr"),
                                    dict(scheme="vtrs_ssm"), dict(scheme="protocol_lta_h1")])
def test_sweep_equals_its_per_point_reference(target):
    """The engine against the port's own per-point loop: per-trial outcomes
    and ``min_tr`` exactly, shares as counts."""
    _, _, tcfg, tu = _pair("wdm8-permuted")
    axes = {"sigma_rlv": RLVS} if target.get("metric") == "min_tr" else AXES
    req = tsw.SweepRequest(cfg=tcfg, units=tu, axes=axes, **target)
    got, want = tsw.sweep(req).data, tsw.sweep_reference(req).data
    if "scheme" in target:
        _hold_eval(got, want, 36)
    elif target.get("metric") == "min_tr":
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        _hold_shares(got.numpy(), want.numpy(), 36)


def test_shmoo_and_scheme_views():
    _, _, tcfg, tu = _pair("wdm8-natural")
    cafp = tapi.shmoo(tcfg, tu, RLVS, TRS, scheme="seq")
    assert torch.equal(cafp, tsw.sweep_scheme(tcfg, tu, "seq", AXES).cafp)
    afp = tapi.shmoo(tcfg, tu, RLVS, TRS, policy="ltc")
    assert torch.equal(afp, tsw.sweep_policy(tcfg, tu, "ltc", AXES))
    with pytest.raises(ValueError, match="exactly one"):
        tapi.shmoo(tcfg, tu, RLVS, TRS)
    assert tuple(tapi.SCHEMES) == tapi.registered_schemes() == tuple(japi.SCHEMES)
    assert dict(tapi.SCHEME_POLICY) == dict(japi.SCHEME_POLICY)
    assert "protocol_lta" in tapi.SCHEMES and tapi.SCHEME_POLICY["seq_retry"] == "lta"
    import repro_torch.core as tcore

    assert tcore.sweep is tsw.sweep and tcore.SweepRequest is tsw.SweepRequest


def test_sweep_validation_errors():
    """The reference's request checks (tests/test_sweep.py and the timeline
    checks of tests/test_temporal.py), for the engine and the oracle."""
    _, _, tcfg, tu = _pair("wdm8-natural", n=2)
    for call in (tsw.sweep_grid, tsw.sweep_grid_reference):
        with pytest.raises(ValueError, match="exactly one"):
            call(tcfg, tu, AXES)
        with pytest.raises(ValueError, match="unknown sweep axis"):
            call(tcfg, tu, {"tr_mean": TRS}, policy="ltc", fixed={"bogus": 1.0})
        with pytest.raises(ValueError, match="overlap"):
            call(tcfg, tu, AXES, policy="ltc", fixed={"sigma_rlv": 1.0})
        with pytest.raises(ValueError, match="unknown metric"):
            call(tcfg, tu, AXES, policy="ltc", metric="nope")
        with pytest.raises(ValueError, match="cannot be an axis"):
            call(tcfg, tu, AXES, policy="ltc", metric="min_tr")
        with pytest.raises(ValueError, match="policy sweeps"):
            call(tcfg, tu, {"sigma_rlv": RLVS}, scheme="seq", metric="min_tr")
    with pytest.raises(ValueError, match="unknown sweep axis"):
        tsw.sweep_policy(tcfg, tu, "ltc", {"bogus": RLVS})
    with pytest.raises(ValueError, match=">= 0"):
        tsw.sweep_policy(tcfg, tu, "ltc", {"sigma_rlv": np.array([1.0, -1.0])})
    with pytest.raises(ValueError, match="at least one"):
        tsw.sweep_policy(tcfg, tu, "ltc", {})
    tl = make_timeline(3, 8, thermal=0.2, device="cpu")
    req = tsw.SweepRequest(cfg=tcfg, units=tu, scheme="protocol_lta", timeline=tl,
                           axes={"sigma_rlv": np.array([0.2, 0.4])}, fixed={"tr_mean": 5.0})
    with pytest.raises(NotImplementedError):
        tsw.sweep_reference(req)
    with pytest.raises(ValueError, match="protocol_"):
        tsw.SweepRequest(cfg=tcfg, units=tu, scheme="vtrs_ssm", timeline=tl,
                         axes={"sigma_rlv": np.array([0.2])})
    with pytest.raises(ValueError):
        tsw.SweepRequest(cfg=tcfg, units=tu, scheme="protocol_lta", metric="min_tr",
                         axes={"sigma_rlv": np.array([0.2])}, timeline=tl)
    with pytest.raises(ValueError, match="channels"):
        tsw.SweepRequest(cfg=tcfg, units=tu, scheme="protocol_lta", axes={"sigma_rlv": RLVS},
                         timeline=make_timeline(3, 4, device="cpu"))


def test_mesh_and_fabric_are_not_ported_yet():
    """``mesh=`` takes a 1-D ``SweepMesh`` only (tests/test_torch_mesh.py
    holds mesh sweeps to the unsharded engine): a mesh-like object with two
    axes gets the reference's ``ValueError``, an object that is no mesh a
    ``TypeError``.
    A fabric request refuses a plain sweep's transceiver units."""
    from repro_torch.configs.fabric import FABRIC_TINY

    _, _, tcfg, tu = _pair("wdm8-natural", n=2)
    with pytest.raises(ValueError, match=r"sweep meshes are 1-D \(the chunk axis\); got axes "
                                         r"\('data', 'model'\)"):
        tsw.sweep_policy(tcfg, tu, "ltc", AXES,
                         mesh=SimpleNamespace(devices=("cpu", "cpu"), axis_names=("data", "model")))
    with pytest.raises(TypeError, match="make_sweep_mesh"):
        tsw.sweep_policy(tcfg, tu, "ltc", AXES, mesh=object())
    with pytest.raises(ValueError, match="fabric sweeps take FabricUnits"):
        tsw.SweepRequest(cfg=tcfg, units=tu, scheme="seq", axes=AXES, fabric=FABRIC_TINY)


def test_kernel_wrappers_refuse_more_trials_than_a_launch_holds():
    """A flattened grid could pass the launches' int trial count; the
    wrappers refuse it before any launch (meta tensors: no memory)."""
    t = 2 ** 31
    x = torch.empty((t, 8), device="meta")
    with pytest.raises(ValueError, match="trials in one launch"):
        build_tables(x, x, x, x, max_alias=8, max_entries=24)
    with pytest.raises(ValueError, match="trials in one launch"):
        perfect_matching(torch.empty((t, 8), dtype=torch.int64, device="meta"))


def test_fig17_seq_retry_record():
    """``BENCH_sweep.json``'s fig17/seq_retry record (WDM8_G200, seed 17,
    24 x 24 units drawn in JAX's earlier threefry layout, fig17's TR axis)
    equals the port's sweep as CAFP counts of 576 trials."""
    records = json.loads((ROOT / "BENCH_sweep.json").read_text())["records"]
    rec = next(r for r in records if r["name"] == "fig17/seq_retry")["derived"]
    cfg = config_from_fields(**dataclasses.asdict(jwdm.WDM8_G200))
    units = tapi.make_units(cfg, 17, 24, 24, device="cpu", partitionable=False)
    trs = np.linspace(0.25 * 1.12, 8 * 1.12, 12).astype(np.float32)  # benchmarks tr_sweep()
    np.testing.assert_array_equal(trs, np.asarray(rec["tr"], np.float32))
    got = tsw.sweep_scheme(cfg, units, "seq_retry", {"tr_mean": trs}).cafp.numpy()
    np.testing.assert_array_equal(_counts(got, 576),
                                  _counts(np.asarray(rec["cafp_vs_ideal_lta"]), 576))
    with jax.threefry_partitionable(False):
        ju = japi.make_units(jwdm.WDM8_G200, 17, 24, 24)
    for g, w in zip(units, ju):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
