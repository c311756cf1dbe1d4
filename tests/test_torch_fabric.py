"""The port's fabric layer (``repro_torch.fabric``, ``repro_torch.configs.fabric``
and ``SweepRequest(fabric=...)``) against the JAX reference on identical
inputs, on the CPU.

* topology: every preset's topology arrays, route alternatives and the
  specs' validation errors equal the reference's;
* units: ``make_fabric_units`` equals the reference's draws bit for bit, in
  both of JAX's threefry layouts and for all four comb groups;
* systems: ``instantiate_links`` equals the reference's ``instantiate_link``
  under ``jax.disable_jit()`` bit for bit (the port follows the eager
  arithmetic: XLA:CPU fuses multiply-adds under ``jit``);
* bring-up: ``bringup`` against the reference's jitted ``bringup``; per-link
  records and the dup-sanitized state exactly; and on the reference's own
  (jitted) systems, moved across, the port's per-link outcomes exactly;
* parity, aggregation and state: constraints-off parity inside the port, and
  ``aggregate_stats`` against a numpy oracle;
* sweeps: ``sweep(fabric=)`` against the per-point ``bringup`` loop, across
  chunk sizes and against the reference's unsharded ``sweep``; the
  request's fabric validation with the reference's messages.

Tolerances: integer and boolean fields exactly.  ``FabricStats`` means as
integer counts (mean x K, or x routes) exactly and within 1e-7: the port
divides the count by K in float32, while the reference's jitted mean
multiplies the sum by 1/K (5/6 reads 0.83333337 there, 0.8333333 here).
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import fabric as jfab  # noqa: E402
from repro.configs import fabric as jcfab  # noqa: E402
from repro.configs import wdm as jwdm  # noqa: E402
from repro.core import sampling as jsamp  # noqa: E402
from repro.core.variations import as_variations  # noqa: E402
from repro_torch import fabric as tfab  # noqa: E402
from repro_torch.configs import fabric as tcfab  # noqa: E402
from repro_torch.convert import config_from_fields, fabric_units_from_numpy  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import sampling as tsamp  # noqa: E402
from repro_torch.core.api import oblivious_arbitrate  # noqa: E402
from repro_torch.core.sampling import SystemBatch, UnitSamples, instantiate  # noqa: E402
from repro_torch.core.sweep import SweepRequest, sweep  # noqa: E402
from repro_torch.core.temporal import make_timeline  # noqa: E402
from repro_torch.core.variations import Variations, axis_names  # noqa: E402

# The module: the package exports the function ``sweep`` over its name.
jsw = importlib.import_module("repro.core.sweep")

JCFG = jwdm.WDM8_G200
TCFG = config_from_fields(**dataclasses.asdict(JCFG))
TCFG16 = config_from_fields(**dataclasses.asdict(jwdm.WDM16_G200))
TR = 5.0
SYS_FIELDS = ("laser", "ring", "fsr", "tr_unit")
EV_FIELDS = ("alg", "ideal", "lanes", "zero", "dup", "order", "ltc_ok", "shift", "ch_up",
             "wl", "entry")


def _tspec(jspec):
    return tfab.FabricSpec(**dataclasses.asdict(jspec))


@functools.lru_cache(maxsize=None)
def _ref_bringup(jcfg, jspec, tr, scheme, seed):
    """The reference's jitted bring-up, once per case."""
    return jfab.bringup(jcfg, jspec, tr_mean=tr, scheme=scheme, seed=seed)


def _hold_stats(got, want, n):
    """FabricStats: counts over ``n`` exactly, values within 1e-7."""
    for f in want._fields:
        g = np.asarray(getattr(got, f).numpy(), np.float64)
        w = np.asarray(getattr(want, f), np.float64)
        assert g.shape == w.shape, f
        np.testing.assert_array_equal(np.rint(g * n), np.rint(w * n), err_msg=f)
        assert np.abs(g - w).max() <= 1e-7, f


def _hold_ev(got, want):
    for f in EV_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, (f, g.dtype, w.dtype, g.shape)
        np.testing.assert_array_equal(g, w, err_msg=f)


def _eager_systems(jcfg, jspec, ju, over):
    """The reference's per-link ``instantiate_link``, un-jitted, stacked to
    the port's (2K, N) rows."""
    var = as_variations(over)
    with jax.disable_jit():
        per = [jfab.instantiate_link(jcfg, jspec, jax.tree_util.tree_map(lambda a: a[k], ju), var)
               for k in range(jspec.n_links)]
    return [np.concatenate([np.asarray(getattr(s, f)) for s in per]) for f in SYS_FIELDS]


# ------------------------------------------------------------- topology --

@pytest.mark.parametrize("name", sorted(jcfab.FABRIC_CONFIGS))
def test_preset_topology_matches_reference(name):
    cfg_key, jspec = jcfab.FABRIC_CONFIGS[name]
    tkey, tspec = tcfab.FABRIC_CONFIGS[name]
    assert tkey == cfg_key and dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    for attr in ("pairs", "n_pairs", "n_links", "n_groups", "max_hops"):
        assert getattr(tspec, attr) == getattr(jspec, attr), attr
    for fn in ("link_pair", "link_in_pair", "link_group", "route_hops"):
        np.testing.assert_array_equal(getattr(tspec, fn)(), getattr(jspec, fn)(), err_msg=fn)
    for g, w in zip(tspec.link_pods() + tspec.route_alternatives(),
                    jspec.link_pods() + jspec.route_alternatives()):
        np.testing.assert_array_equal(g, w)
    for pods, hops in ((3, 1), (8, 2), (16, 3), (5, 4)):
        assert tcfab.ring_routes(pods, hops) == jcfab.ring_routes(pods, hops)


@pytest.mark.parametrize("kw", [
    dict(pods=1), dict(links_per_pair=0), dict(comb_group="rack"),
    dict(pods=3, routes=((0, 0),)), dict(pods=3, routes=((0, 7),)), dict(pods=3, routes=((1,),)),
    dict(pods=4, routes=((0, 1, 2), (2, 3)), fallbacks=(((0, 3, 2),),)),
    dict(pods=4, routes=((0, 1, 2),), fallbacks=(((0, 3),),)),
    dict(pods=4, routes=((0, 1, 2),), fallbacks=(((0, 0, 2),),)),
])
def test_spec_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        jfab.FabricSpec(**kw)
    with pytest.raises(ValueError) as got:
        tfab.FabricSpec(**kw)
    assert str(got.value) == str(want.value)


def test_topology_and_alternatives():
    spec = tfab.FabricSpec(pods=4, links_per_pair=3, comb_group="pod",
                           routes=((0, 1, 2), (3, 0)))
    assert spec.n_pairs == 6 and spec.n_links == 18
    src, dst = spec.link_pods()
    assert np.all(src < dst)
    np.testing.assert_array_equal(spec.link_group(), src)
    hops = spec.route_hops()
    assert hops[1].tolist() == [spec.pairs.index((0, 3)), -1]
    spec = tfab.FabricSpec(pods=4, routes=((0, 1, 2), (2, 3)), fallbacks=(((0, 3, 2),), ()))
    hops, valid = spec.route_alternatives()
    np.testing.assert_array_equal(hops[:, 0], spec.route_hops())
    np.testing.assert_array_equal(valid, [[True, True], [True, False]])
    with pytest.raises(ValueError, match="hops"):
        tcfab.ring_routes(4, 4)
    assert "comb_coupling" in axis_names()
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        Variations(comb_coupling=1.5)


def test_auto_link_chunk_degenerate_and_bisection():
    with pytest.raises(ValueError, match="n_links"):
        tfab.auto_link_chunk(TCFG, 0)
    assert tfab.auto_link_chunk(TCFG, 1) == 1
    assert tfab.auto_link_chunk(TCFG, 8, budget=1) == 1
    assert tfab.auto_link_chunk(TCFG, 8) == 8
    from repro_torch.core.sweep import scheme_point_bytes

    budget = scheme_point_bytes(TCFG16, 2 * 37) + 5
    chunk = tfab.auto_link_chunk(TCFG16, 1008, budget=budget)
    assert chunk == 37
    assert tfab.auto_link_chunk(TCFG16, 10080) == 10080  # 4 GiB holds 10k WDM16 links


# ---------------------------------------------------------------- units --

@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("comb_group", ["link", "bundle", "pod", "fabric"])
def test_make_fabric_units_bit_exact(comb_group, partitionable):
    jspec = dataclasses.replace(jcfab.FABRIC_TINY, comb_group=comb_group)
    with jax.threefry_partitionable(partitionable):
        want = jfab.make_fabric_units(JCFG, jspec, 33)
    got = tfab.make_fabric_units(TCFG, _tspec(jspec), 33, device="cpu",
                                 partitionable=partitionable)
    assert got.n_links == jspec.n_links
    for f, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, f
        np.testing.assert_array_equal(g.numpy().view(np.int32), w.view(np.int32), err_msg=f)


@pytest.mark.parametrize("partitionable", [True, False])
def test_sample_systems_matches_reference(partitionable):
    with jax.threefry_partitionable(partitionable):
        want = jsamp.sample_systems(jax.random.key(5), JCFG, 3, 4)
    got = tsamp.sample_systems(prng.key_from_seed(5), TCFG, 3, 4, device="cpu",
                               partitionable=partitionable)
    for f, g, w in zip(SYS_FIELDS, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


# -------------------------------------------------------------- systems --

@pytest.mark.parametrize("over", [
    {}, {"comb_coupling": 0.0}, {"comb_coupling": 0.5}, {"comb_coupling": 1.0},
    {"sigma_llv_frac": np.float32(0.3)},
    {"comb_coupling": np.float32(0.3), "thermal_drift": 0.25},
], ids=["defaults", "c=0", "c=0.5", "c=1", "sigma_llv=0.3", "c=0.3+drift"])
@pytest.mark.parametrize("comb_group", ["link", "bundle"])
def test_instantiate_links_equals_eager_reference(comb_group, over):
    jspec = dataclasses.replace(jcfab.FABRIC_TINY, comb_group=comb_group)
    ju = jfab.make_fabric_units(JCFG, jspec, 3)
    tu = fabric_units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    got = tfab.instantiate_links(TCFG, _tspec(jspec), tu, Variations(**over))
    for f, g, w in zip(SYS_FIELDS, got, _eager_systems(JCFG, jspec, ju, over)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy().view(np.int32), w.view(np.int32), err_msg=f)
    laser = got.laser.numpy().reshape(-1, 2, 8)
    np.testing.assert_array_equal(laser[:, 0], laser[:, 1])  # both ends share the comb
    if over.get("comb_coupling") == 1.0 and comb_group == "bundle":
        group = jspec.link_group()
        for k in range(jspec.n_links):
            np.testing.assert_array_equal(laser[k, 0], laser[np.argmax(group == group[k]), 0])


# -------------------------------------------------------------- bring-up --

@pytest.mark.parametrize("scheme", ["vtrs_ssm", "seq_retry", "protocol_lta"])
@pytest.mark.parametrize("comb_group", ["link", "bundle"])
def test_bringup_matches_reference(comb_group, scheme):
    jspec = dataclasses.replace(jcfab.FABRIC_TINY, comb_group=comb_group)
    tspec = _tspec(jspec)
    want = _ref_bringup(JCFG, jspec, TR, scheme, 3)
    got = tfab.bringup(TCFG, tspec, tr_mean=TR, scheme=scheme, seed=3, device="cpu")
    _hold_ev(got.ev, want.ev)
    _hold_stats(got.stats, want.stats, jspec.n_links)
    for f, g, w in zip(got.state._fields, got.state, want.state):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    for f, g, w in zip(SYS_FIELDS, got.system,
                       _eager_systems(JCFG, jspec, want.units, {"tr_mean": TR})):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    assert got.system.laser.shape == (2 * jspec.n_links, 8)
    # link chunking changes nothing
    one = tfab.bringup(TCFG, tspec, tr_mean=TR, scheme=scheme, seed=3, device="cpu",
                       link_chunk=1)
    for f in EV_FIELDS:
        assert torch.equal(getattr(one.ev, f), getattr(got.ev, f)), f


def test_bringup_mid_matches_reference_and_its_systems():
    """FABRIC_MID (48 links at WDM16) with vtrs_ssm; and on the reference's
    own jitted systems, moved across, the port's per-link outcomes."""
    jcfg, jspec = jwdm.WDM16_G200, jcfab.FABRIC_MID
    want = _ref_bringup(jcfg, jspec, 4.48, "vtrs_ssm", 33)
    got = tfab.bringup(TCFG16, tcfab.FABRIC_MID, tr_mean=4.48, scheme="vtrs_ssm", seed=33,
                       device="cpu")
    _hold_ev(got.ev, want.ev)
    _hold_stats(got.stats, want.stats, jspec.n_links)
    sys_ = SystemBatch(*(torch.tensor(np.asarray(a)) for a in want.system))
    asg = oblivious_arbitrate(TCFG16, sys_, 4.48, "vtrs_ssm")
    from repro_torch.core import ideal

    rec = tfab.link_record(TCFG16, "ltc", asg.wl, asg.entry,
                           ideal.success(sys_, "ltc", TCFG16.s, 4.48))
    _hold_ev(rec, want.ev)


@pytest.mark.parametrize("scheme", ["vtrs_ssm", "seq_retry", "protocol_lta"])
@pytest.mark.parametrize("comb_group", ["link", "bundle"])
def test_constraints_off_parity_inside_the_port(comb_group, scheme):
    """Zero coupling == independent per-link arbitration: the core
    ``instantiate`` of each link (L = 1 laser, R = 2 rings), stacked, then
    one flat ``oblivious_arbitrate``, bit for bit."""
    spec = tfab.FabricSpec(pods=3, links_per_pair=4, comb_group=comb_group)
    res = tfab.bringup(TCFG, spec, tr_mean=TR, scheme=scheme, seed=3, device="cpu")
    u = res.units
    per = [instantiate(TCFG, UnitSamples(u.go[k:k + 1, None], u.llv[k:k + 1], u.rlv[k],
                                         u.fsr[k], u.tr[k]))
           for k in range(spec.n_links)]
    flat = SystemBatch(*(torch.cat(x) for x in zip(*per)))
    for f, a, b in zip(SYS_FIELDS, flat, res.system):
        assert torch.equal(a, b), f
    asg = oblivious_arbitrate(TCFG, flat, TR, scheme)
    assert torch.equal(asg.wl.view(-1, 2, 8), res.ev.wl)
    assert torch.equal(asg.entry.view(-1, 2, 8), res.ev.entry)


def _numpy_stats(spec, n, alg, ideal_ok, lanes, ltc_ok, shift, ch_up):
    """A plain numpy oracle of ``aggregate_stats``: loops over routes and
    alternatives, means as float32 count / float32 length."""
    f32 = lambda c, d: np.float32(c) / np.float32(d)  # noqa: E731
    k = len(alg)
    lp = spec.link_pair()
    out = {"link_up": f32(alg.sum(), k),
           "afp": np.float32(1.0) - f32(ideal_ok.sum(), k),
           "cafp": f32((~alg & ideal_ok).sum(), k)}
    both = ltc_ok[:, 0] & ltc_ok[:, 1]
    eq = shift[:, 0] == shift[:, 1]
    out["matched"] = f32((alg & both & eq).sum(), k)
    out["reconciled"] = f32((alg & both & ~eq).sum(), k)
    out["bandwidth"] = f32(lanes.sum() / n, k)
    if not spec.routes:
        return {**out, **{f: np.float32(1.0) for f in (
            "route_up", "route_cont", "route_served", "route_cont_served", "route_bandwidth")}}

    def up(route):
        return all(alg[lp == h].any() for h in route)

    def cont(route):
        avail = [ch_up[(lp == h) & (lanes > 0)].any(axis=0) for h in route]
        return bool(np.logical_and.reduce(avail).any())

    def bw(route):
        return min(max(lanes[lp == h].max() / n, 0.0) for h in route)

    pairs = {p: i for i, p in enumerate(spec.pairs)}
    hop = lambda r: [pairs[(min(a, b), max(a, b))] for a, b in zip(r, r[1:])]  # noqa: E731
    alts = [[hop(r)] + [hop(a) for a in (spec.fallbacks[i] if spec.fallbacks else ())]
            for i, r in enumerate(spec.routes)]
    n_r = len(alts)
    out["route_up"] = f32(sum(up(a[0]) for a in alts), n_r)
    out["route_cont"] = f32(sum(cont(a[0]) for a in alts), n_r)
    out["route_served"] = f32(sum(any(up(r) for r in a) for a in alts), n_r)
    out["route_cont_served"] = f32(sum(any(cont(r) for r in a) for a in alts), n_r)
    out["route_bandwidth"] = f32(sum(max(bw(r) for r in a) for a in alts), n_r)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("which", ["mid-with-fallbacks", "tiny", "no-routes"])
def test_aggregate_stats_matches_numpy_oracle(which, seed):
    spec = {"mid-with-fallbacks": tcfab.FABRIC_MID, "tiny": tcfab.FABRIC_TINY,
            "no-routes": tfab.FabricSpec(pods=3, links_per_pair=3)}[which]
    n, k = 16, spec.n_links
    rng = np.random.default_rng(seed)
    alg = rng.random(k) < 0.6
    lanes = np.where(alg, n, rng.integers(0, n + 1, k)).astype(np.int32)
    lanes[rng.random(k) < 0.2] = 0
    ev = tfab.LinkEval(
        alg=torch.from_numpy(alg), ideal=torch.from_numpy(rng.random(k) < 0.8),
        lanes=torch.from_numpy(lanes),
        zero=torch.zeros((k, 2), dtype=torch.bool), dup=torch.zeros((k, 2), dtype=torch.bool),
        order=torch.zeros((k, 2), dtype=torch.bool),
        ltc_ok=torch.from_numpy(rng.random((k, 2)) < 0.7),
        shift=torch.from_numpy(rng.integers(0, 3, (k, 2)).astype(np.int32)),
        ch_up=torch.from_numpy(rng.random((k, n)) < 0.3),
        wl=torch.zeros((k, 2, n), dtype=torch.int32),
        entry=torch.zeros((k, 2, n), dtype=torch.int32))
    cfg = TCFG16
    got = tfab.aggregate_stats(cfg, spec, ev)
    want = _numpy_stats(spec, n, *(getattr(ev, f).numpy() for f in
                                   ("alg", "ideal", "lanes", "ltc_ok", "shift", "ch_up")))
    for f in got._fields:
        assert got.__getattribute__(f).dtype == torch.float32
        assert float(getattr(got, f)) == float(want[f]), f
    # a leading batch axis of points gives per-point stats
    two = tfab.aggregate_stats(cfg, spec, tfab.LinkEval(*(torch.stack([a, a]) for a in ev)))
    for f in got._fields:
        assert torch.equal(getattr(two, f), getattr(got, f).expand(2)), f


def test_state_from_assignment_matches_reference():
    wl = np.array([[2, 2, -1, 3], [1, 3, 3, 3]], np.int32)
    entry = np.array([[0, 1, -1, 2], [4, 0, 1, 2]], np.int32)
    st = tfab.state_from_assignment(torch.from_numpy(wl), torch.from_numpy(entry))
    assert st.lock.tolist() == [[2, -1, -1, 3], [1, 3, -1, -1]]
    assert st.entry.tolist() == [[0, -1, -1, 2], [4, 0, -1, -1]]
    assert bool((st.cursor >= 0).all()) and st.probes.tolist() == [0, 0]
    rng = np.random.default_rng(0)
    wl = rng.integers(-1, 6, (200, 8)).astype(np.int32)    # duplicates on most rows
    entry = rng.integers(-1, 24, (200, 8)).astype(np.int32)
    want = jfab.state_from_assignment(jnp.asarray(wl), jnp.asarray(entry))
    got = tfab.state_from_assignment(torch.from_numpy(wl), torch.from_numpy(entry))
    for f, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


def test_bringup_mesh_and_default_device(monkeypatch):
    from repro_torch.launch import SweepMesh

    want = tfab.bringup(TCFG, tcfab.FABRIC_TINY, link_chunk=2, device="cpu")
    got = tfab.bringup(TCFG, tcfab.FABRIC_TINY, link_chunk=2, device="cpu",
                       mesh=SweepMesh(("cpu",) * 2))
    for f, g, w in zip(want.ev._fields, got.ev, want.ev):
        assert torch.equal(g, w), f
    with pytest.raises(TypeError, match="make_sweep_mesh"):
        tfab.bringup(TCFG, tcfab.FABRIC_TINY, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfab.make_fabric_units(TCFG, tcfab.FABRIC_TINY, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfab.bringup(TCFG, tcfab.FABRIC_TINY)


# ---------------------------------------------------------------- sweeps --

@pytest.mark.parametrize("scheme", ["vtrs_ssm", "protocol_lta"])
def test_fabric_sweep_matches_loop_and_reference(scheme):
    jspec, tspec = jcfab.FABRIC_TINY, tcfab.FABRIC_TINY
    axes = {"comb_coupling": [0.0, 1.0], "tr_mean": [4.0, 5.0]}
    ju = jfab.make_fabric_units(JCFG, jspec, 3)
    tu = tfab.make_fabric_units(TCFG, tspec, 3, device="cpu")
    req = SweepRequest(cfg=TCFG, units=tu, scheme=scheme, fabric=tspec, axes=axes)
    res = sweep(req)
    assert res.axis_names == ("comb_coupling", "tr_mean")
    one = sweep(req.replace(chunk_size=1)).data
    for f in res.data._fields:
        grid = getattr(res.data, f)
        assert grid.shape == (2, 2) and grid.dtype == torch.float32, f
        assert torch.equal(grid, getattr(one, f)), f
    for i, c in enumerate(axes["comb_coupling"]):
        for j, tr in enumerate(axes["tr_mean"]):
            ref = tfab.bringup(TCFG, tspec, tr_mean=tr, scheme=scheme, seed=3, device="cpu",
                               variations={"comb_coupling": c})
            for f in res.data._fields:
                assert torch.equal(getattr(res.data, f)[i, j], getattr(ref.stats, f)), f
    if scheme == "vtrs_ssm":  # the reference's protocol_lta sweep costs a long jit compile
        want = jsw.sweep(jsw.SweepRequest(cfg=JCFG, units=ju, scheme=scheme, fabric=jspec,
                                          axes=axes)).data
        _hold_stats(res.data, want, jspec.n_links)


def test_fabric_sweep_per_point_sigma_and_chunked_links():
    """A sigma axis crossed with comb coupling on FABRIC_MID, where a chunk
    of points spans several link chunks: equal to the per-point loop."""
    spec = tcfab.FABRIC_MID
    tu = tfab.make_fabric_units(TCFG16, spec, 1, device="cpu")
    axes = {"sigma_rlv": [0.5, 2.0], "comb_coupling": [0.0, 0.5]}
    req = SweepRequest(cfg=TCFG16, units=tu, scheme="vtrs_ssm", fabric=spec, axes=axes,
                       fixed={"tr_mean": 4.48})
    res = sweep(req).data
    for i, s in enumerate(axes["sigma_rlv"]):
        for j, c in enumerate(axes["comb_coupling"]):
            ref = tfab.bringup(TCFG16, spec, tr_mean=4.48, scheme="vtrs_ssm", seed=1,
                               device="cpu", link_chunk=7,
                               variations={"sigma_rlv": s, "comb_coupling": c})
            for f in res._fields:
                assert torch.equal(getattr(res, f)[i, j], getattr(ref.stats, f)), f


def test_sweep_request_fabric_validation():
    spec = tcfab.FABRIC_TINY
    units = tfab.make_fabric_units(TCFG, spec, 0, device="cpu")
    ok = dict(cfg=TCFG, units=units, fabric=spec, axes={"tr_mean": [5.0]})
    with pytest.raises(ValueError, match="pass scheme=..., not policy="):
        SweepRequest(policy="ltc", **ok)
    with pytest.raises(ValueError, match="fabric sweeps require metric='eval'"):
        SweepRequest(scheme="vtrs_ssm", metric="min_tr", cfg=TCFG, units=units, fabric=spec,
                     axes={"sigma_rlv": [1.0]})
    with pytest.raises(ValueError, match="take FabricUnits"):
        SweepRequest(scheme="vtrs_ssm", cfg=TCFG, fabric=spec, units=torch.zeros(3),
                     axes={"tr_mean": [5.0]})
    with pytest.raises(ValueError, match="units carry 6 links but the spec describes 1"):
        SweepRequest(scheme="vtrs_ssm", cfg=TCFG, units=units,
                     fabric=tfab.FabricSpec(pods=2, links_per_pair=1), axes={"tr_mean": [5.0]})
    ftl = tfab.make_fabric_timeline(spec, 2, 8, device="cpu")
    SweepRequest(scheme="vtrs_ssm", timeline=ftl, **ok)
    with pytest.raises(ValueError, match="per-transceiver Timeline has no link addressing"):
        SweepRequest(scheme="vtrs_ssm", timeline=make_timeline(2, 8, device="cpu"), **ok)
    with pytest.raises(ValueError, match="carries per-link faults but no topology"):
        SweepRequest(scheme="vtrs_ssm", cfg=TCFG, units=units, axes={"tr_mean": [5.0]},
                     timeline=ftl)
    with pytest.raises(ValueError, match="timeline spans 1 links but the fabric spec describes 6"):
        SweepRequest(scheme="vtrs_ssm", timeline=tfab.make_fabric_timeline(
            tfab.FabricSpec(pods=2, links_per_pair=1), 2, 8, device="cpu"), **ok)
    with pytest.raises(ValueError, match="timeline has 9 channels but cfg has 8"):
        SweepRequest(scheme="vtrs_ssm", timeline=tfab.make_fabric_timeline(spec, 2, 9,
                                                                           device="cpu"), **ok)
    with pytest.raises(ValueError, match="must be in"):
        SweepRequest(scheme="vtrs_ssm", cfg=TCFG, units=units, fabric=spec,
                     axes={"comb_coupling": [1.5]})
    with pytest.raises(TypeError, match="make_sweep_mesh"):
        SweepRequest(scheme="vtrs_ssm", mesh=object(), **ok)
    from repro_torch.core.sweep import sweep_reference

    with pytest.raises(NotImplementedError, match="no fabric path"):
        sweep_reference(SweepRequest(scheme="vtrs_ssm", **ok))


def test_sweep_request_messages_match_reference():
    """The messages of the reference's fabric validation, in its order."""
    jspec, tspec = jcfab.FABRIC_TINY, tcfab.FABRIC_TINY
    ju = jfab.make_fabric_units(JCFG, jspec, 0)
    tu = tfab.make_fabric_units(TCFG, tspec, 0, device="cpu")
    cases = [
        dict(policy="ltc", metric="min_tr", axes={"tr_mean": [5.0]}),
        dict(scheme="vtrs_ssm", metric="min_tr", axes={"tr_mean": [5.0]}),
        dict(scheme="vtrs_ssm", axes={"tr_mean": [5.0]}, fabric2=(2, 1)),
        dict(scheme="vtrs_ssm", axes={"nope": [5.0]}),
        dict(scheme="vtrs_ssm", axes={}),
    ]
    for case in cases:
        case = dict(case)
        shape = case.pop("fabric2", None)
        jf = jfab.FabricSpec(pods=shape[0], links_per_pair=shape[1]) if shape else jspec
        tf = tfab.FabricSpec(pods=shape[0], links_per_pair=shape[1]) if shape else tspec
        with pytest.raises(ValueError) as want:
            jsw.SweepRequest(cfg=JCFG, units=ju, fabric=jf, **case)
        with pytest.raises(ValueError) as got:
            SweepRequest(cfg=TCFG, units=tu, fabric=tf, **case)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pods,links_per_pair,seed,tr_mean", [
    (2, 2, 0, 4.0), (3, 2, 7, 5.0), (4, 1, 3, 4.5),
])
def test_degraded_metrics_dominate(pods, links_per_pair, seed, tr_mean):
    routes = tcfab.ring_routes(pods, 1)
    fallbacks = tuple((tuple((i + j) % pods for j in (0, pods - 1, 1)),) if pods > 2 else ()
                      for i in range(len(routes)))
    spec = tfab.FabricSpec(pods=pods, links_per_pair=links_per_pair, comb_group="bundle",
                           routes=routes, fallbacks=fallbacks if pods > 2 else ())
    s = tfab.bringup(TCFG, spec, tr_mean=tr_mean, scheme="vtrs_ssm", seed=seed,
                     device="cpu").stats
    assert float(s.route_served) >= float(s.route_up)
    assert float(s.route_cont_served) >= float(s.route_cont)
    assert 0.0 <= float(s.route_bandwidth) <= 1.0
    bare = dataclasses.replace(spec, fallbacks=())
    r = tfab.bringup(TCFG, bare, tr_mean=tr_mean, scheme="vtrs_ssm", seed=seed,
                     device="cpu").stats
    assert torch.equal(r.route_served, r.route_up)
    assert torch.equal(r.route_cont_served, r.route_cont)
