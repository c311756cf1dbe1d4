"""The port's fabric chaos (``repro_torch.fabric.chaos`` and
``SweepRequest(fabric=..., timeline=...)``) against the JAX reference on
identical inputs, on the CPU.

* ``make_fabric_timeline`` / ``chaos_timeline``: every array equal (float32
  drifts bit for bit, liveness and ``disturbed`` exactly) for every
  registered scenario and each drift form; every ``ValueError`` with the
  reference's message;
* ``run_fabric_timeline_impl`` against the reference's jitted
  ``run_fabric_timeline``, per step and in the final state: ``tiny-flap``
  warm and cold with ``vtrs_ssm``, warm with ``protocol_lta``, and
  ``mid-combout`` cut to 3 steps (a comb outage: every lane of a bundle
  dies, so both rows of its links lose every lock);
* the no-fault parity (a quiet timeline's step 0 is ``bringup``), link-chunk
  invariance (chunks of 1, 5 and K links), ``summarize_chaos`` and the
  fault semantics of the reference's tests, inside the port;
* chaos sweeps against the per-point loop, across chunk sizes and against
  the reference's unsharded ``sweep``.

Tolerances: every per-link field ((S, K) and (S, K, 2, N)) and the final
``ProtocolState`` exactly.  ``FabricStats`` and link means as integer counts
(mean x K, or x routes) exactly, and their values within 1.2e-7 of the
reference's relative to max(1, |value|): the port divides a count by K in
float32, the reference's jitted mean multiplies the sum by 1/K.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import fabric as jfab  # noqa: E402
from repro.configs import fabric as jcfab  # noqa: E402
from repro_torch import fabric as tfab  # noqa: E402
from repro_torch.configs import fabric as tcfab  # noqa: E402
from repro_torch.convert import config_from_fields, fabric_timeline_from_numpy  # noqa: E402
from repro_torch.core.sweep import SweepRequest, sweep  # noqa: E402

# The module: the package exports the function ``sweep`` over its name.
jsw = importlib.import_module("repro.core.sweep")

SPEC = tcfab.FABRIC_TINY
CFG = config_from_fields(**dataclasses.asdict(jcfab.chaos_timeline("tiny-flap")[0]))
N = CFG.grid.n_ch
PER_LINK = ("wl", "probes", "rounds", "locked", "broken", "churn", "feasible")


def _close(got, want, n, what):
    """Means over ``n``: counts exactly, values within 1.2e-7 relative."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, what
    np.testing.assert_array_equal(np.rint(g * n), np.rint(w * n), err_msg=what)
    assert (np.abs(g - w) <= 1.2e-7 * np.maximum(1.0, np.abs(w))).all(), what


def _scenario(name, steps=None, seed=0):
    """(reference inputs, port inputs) of a registered scenario, cut to
    ``steps``: (cfg, spec, timeline, units) each."""
    jcfg, jspec, jtl = jcfab.chaos_timeline(name)
    tcfg, tspec, ttl = tcfab.chaos_timeline(name, device="cpu")
    if steps is not None:
        jtl = jax.tree_util.tree_map(lambda a: a[:steps], jtl)
        ttl = tfab.FabricTimeline(*(a[:steps] for a in ttl))
    ju = jfab.make_fabric_units(jcfg, jspec, seed)
    tu = tfab.make_fabric_units(tcfg, tspec, seed, device="cpu")
    return (jcfg, jspec, jtl, ju), (tcfg, tspec, ttl, tu)


@functools.lru_cache(maxsize=None)
def _runs(name, scheme, warm, steps):
    """Both packages' runs of a scenario, once per case."""
    (jcfg, jspec, jtl, ju), (tcfg, tspec, ttl, tu) = _scenario(name, steps)
    want = jfab.run_fabric_timeline(jcfg, ju, jspec, jtl, scheme=scheme, warm=warm)
    got = tfab.run_fabric_timeline_impl(tcfg, tu, tspec, ttl, scheme=scheme, warm=warm)
    return got, want, tspec


# ------------------------------------------------------------- timelines --

@pytest.mark.parametrize("name", sorted(jcfab.CHAOS_SCENARIOS))
def test_chaos_timeline_matches_reference(name):
    jcfg, jspec, jtl = jcfab.chaos_timeline(name)
    tcfg, tspec, ttl = tcfab.chaos_timeline(name, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert (ttl.n_steps, ttl.n_links, ttl.n_ch) == (jtl.n_steps, jtl.n_links, jtl.n_ch)
    for f, g, w in zip(ttl._fields, ttl, jtl):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and tuple(g.shape) == w.shape, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


@pytest.mark.parametrize("kw", [
    dict(thermal=[[0, 0.0], [2, 0.4], [4, 0.1]], comb=0.3),
    dict(pod_thermal={0: 0.2, 2: [0.0, 0.1, 0.5, 0.2, 0.0]}, comb=(0.2, 3.0)),
    dict(thermal=0.1, events=((1, "lane_kill", 3, 5), (3, "lane_heal", 3, 5),
                              (2, "ring_kill", 0, 1, 7), (4, "ring_heal", 0, 1, 7),
                              (1, "comb_kill", 2), (2, "link_kill", 4), (4, "link_heal", 4),
                              (0, "link_flap", 5, 3))),
], ids=["breakpoints", "pods-and-comb", "events"])
def test_make_fabric_timeline_forms_match_reference(kw):
    want = jfab.make_fabric_timeline(jcfab.FABRIC_TINY, 5, N, **kw)
    got = tfab.make_fabric_timeline(SPEC, 5, N, device="cpu", **kw)
    for f, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    back = fabric_timeline_from_numpy(*(np.asarray(a) for a in want), device="cpu")
    for g, b in zip(got, back):
        assert torch.equal(g, b)


@pytest.mark.parametrize("args,kw", [
    ((0, N), {}),
    ((2, N), dict(events=((0, "link_kill", 0, 1),))),
    ((2, N), dict(events=((0, "link_flap", 0, 0),))),
    ((2, N), dict(events=((5, "link_kill", 0),))),
    ((2, N), dict(events=((0, "comb_kill", 99),))),
    ((2, N), dict(events=((0, "pod_kill", 0),))),
    ((2, N), dict(events=((0, "link_kill", 6),))),
    ((2, N), dict(events=((0, "lane_kill", 0, N),))),
    ((2, N), dict(events=((0, "ring_kill", 0, 2, 1),))),
    ((2, N), dict(pod_thermal={7: 1.0})),
    ((3, N), dict(thermal=[0.1, 0.2])),
])
def test_timeline_errors_match_reference(args, kw):
    with pytest.raises(ValueError) as want:
        jfab.make_fabric_timeline(jcfab.FABRIC_TINY, *args, **kw)
    with pytest.raises(ValueError) as got:
        tfab.make_fabric_timeline(SPEC, *args, device="cpu", **kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ runs --

@pytest.mark.parametrize("name,scheme,warm,steps", [
    ("tiny-flap", "vtrs_ssm", True, None),
    ("tiny-flap", "vtrs_ssm", False, None),
    ("tiny-flap", "protocol_lta", True, None),
    ("mid-combout", "vtrs_ssm", True, 3),
])
def test_run_fabric_timeline_matches_reference(name, scheme, warm, steps):
    (got_state, got), (want_state, want), spec = _runs(name, scheme, warm, steps)
    for f in PER_LINK:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in got.fabric._fields:
        _close(getattr(got.fabric, f).numpy(), getattr(want.fabric, f), spec.n_links, f)
    for f, g, w in zip(got_state._fields, got_state, want_state):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
    assert got.health is None
    if name == "mid-combout":  # bundle 0's comb dies at step 2: all its links go dark
        dead = np.flatnonzero(spec.link_group() == 0)
        assert (got.wl[2, dead] < 0).all() and not got.feasible[2, dead].any()


def test_summarize_chaos_matches_reference():
    (_, got), (_, want), spec = _runs("tiny-flap", "vtrs_ssm", True, None)
    g, w = tfab.summarize_chaos(got), jfab.summarize_chaos(want)
    assert g.wl is None and g.health is None
    for f in PER_LINK[1:]:
        x = getattr(g, f)
        assert x.dtype == torch.float32 and tuple(x.shape) == (got.probes.shape[0],), f
        _close(x.numpy(), getattr(w, f), spec.n_links, f)
    assert g.fabric is got.fabric


def test_no_fault_parity_bit_identical():
    tl = tfab.make_fabric_timeline(SPEC, 3, N, device="cpu")
    assert not tl.disturbed.any()
    units = tfab.make_fabric_units(CFG, SPEC, 0, device="cpu")
    st, cs = tfab.run_fabric_timeline_impl(CFG, units, SPEC, tl, scheme="vtrs_ssm")
    ref = tfab.bringup(CFG, SPEC, scheme="vtrs_ssm", seed=0, device="cpu")
    assert torch.equal(cs.wl[0], ref.ev.wl)
    for f in cs.fabric._fields:
        assert torch.equal(getattr(cs.fabric, f)[0], getattr(ref.stats, f)), f
        assert torch.equal(getattr(cs.fabric, f)[1:], getattr(cs.fabric, f)[:1].expand(2)), f
    assert int(cs.probes[1:].sum()) == 0 and int(cs.broken[1:].sum()) == 0
    assert int(cs.churn[1:].sum()) == 0
    assert torch.equal(cs.wl[1:], cs.wl[:1].expand(2, -1, -1, -1))
    for f in st._fields:
        assert torch.equal(getattr(st, f), getattr(ref.state, f)), f


@pytest.mark.parametrize("chunk", [1, 5, 6])
def test_link_chunk_invariance(chunk):
    _, spec, tl = tcfab.chaos_timeline("tiny-flap", device="cpu")
    units = tfab.make_fabric_units(CFG, spec, 0, device="cpu")
    ref = tfab.run_fabric_timeline_impl(CFG, units, spec, tl, scheme="vtrs_ssm")
    alt = tfab.run_fabric_timeline_impl(CFG, units, spec, tl, scheme="vtrs_ssm",
                                        link_chunk=chunk)
    for part_ref, part_alt in zip(ref, alt):
        for f, a, b in zip(part_ref._fields, part_ref, part_alt):
            if isinstance(a, tuple):
                for x, y in zip(a, b):
                    assert torch.equal(x, y), f
            elif a is not None:
                assert torch.equal(a, b), f


def test_mesh_health_and_mismatch_raise():
    units = tfab.make_fabric_units(CFG, SPEC, 0, device="cpu")
    tl = tfab.make_fabric_timeline(SPEC, 2, N, device="cpu")
    with pytest.raises(TypeError, match="make_sweep_mesh"):
        tfab.run_fabric_timeline(CFG, units, SPEC, tl, mesh=object())
    _, cs = tfab.run_fabric_timeline(CFG, units, SPEC, tl, health=True)
    from repro_torch.launch import SweepMesh

    _, on_mesh = tfab.run_fabric_timeline(CFG, units, SPEC, tl, health=True, link_chunk=1,
                                          mesh=SweepMesh(("cpu",) * 3))
    assert torch.equal(on_mesh.health, cs.health) and torch.equal(on_mesh.wl, cs.wl)
    assert cs.health.shape == (2, SPEC.n_links) and cs.health.dtype == torch.int8
    with pytest.raises(ValueError, match="channels|needs"):
        tfab.run_fabric_timeline(CFG, units, SPEC,
                                 tfab.make_fabric_timeline(SPEC, 2, N + 2, device="cpu"))


# ----------------------------------------------------- fault semantics --

def _run(tl, *, warm=True, seed=0):
    units = tfab.make_fabric_units(CFG, SPEC, seed, device="cpu")
    return tfab.run_fabric_timeline(CFG, units, SPEC, tl, scheme="vtrs_ssm", warm=warm)


def test_link_kill_isolation_and_heal_recovery():
    tl = tfab.make_fabric_timeline(SPEC, 5, N, device="cpu",
                                   events=((1, "link_kill", 2), (3, "link_heal", 2)))
    _, cs = _run(tl)
    for s in (1, 2):
        assert bool((cs.wl[s, 2] < 0).all()) and not bool(cs.feasible[s, 2])
    assert int(cs.probes[2, 2]) == 0
    other = [k for k in range(SPEC.n_links) if k != 2]
    for s in (1, 2):
        assert torch.equal(cs.wl[s, other], cs.wl[0, other])
        assert int(cs.probes[s, other].sum()) == 0
    assert int(cs.locked[3, 2]) == 2 * N
    bw = cs.fabric.bandwidth
    assert float(bw[1]) < float(bw[0]) and torch.equal(bw[3:], bw[0].expand(2))


def test_comb_and_ring_kill():
    tl = tfab.make_fabric_timeline(SPEC, 3, N, device="cpu", events=((1, "comb_kill", 0),))
    _, cs = _run(tl)
    group = SPEC.link_group()
    dead, alive = np.flatnonzero(group == 0), np.flatnonzero(group != 0)
    assert bool((cs.wl[1:, dead] < 0).all()) and not bool(cs.feasible[1:, dead].any())
    assert torch.equal(cs.wl[1, alive], cs.wl[0, alive])
    assert torch.equal(cs.fabric.afp[1], cs.fabric.afp[0])
    tl = tfab.make_fabric_timeline(SPEC, 3, N, device="cpu", events=((1, "ring_kill", 0, 1, 4),))
    _, cs = _run(tl)
    keep = cs.wl[0].clone()
    keep[0, 1, 4] = -1
    assert torch.equal(cs.wl[1], keep) and int(cs.locked[1, 0]) == 2 * N - 1
    assert bool(cs.feasible[1, 0]) and int(cs.probes[1, 1:].sum()) == 0


def test_disturbed_gating_and_warm_beats_cold():
    sp = CFG.grid.grid_spacing
    tl = tfab.make_fabric_timeline(SPEC, 4, N, device="cpu", pod_thermal={2: 0.5 * sp})
    _, cs = _run(tl)
    src, dst = SPEC.link_pods()
    cold_pod = np.flatnonzero((src != 2) & (dst != 2))
    hot = np.flatnonzero((src == 2) | (dst == 2))
    assert int(cs.probes[1:, cold_pod].sum()) == 0 and bool(tl.disturbed[1:, hot].all())
    assert bool((cs.locked[1:, hot] == 2 * N).all())
    _, _, tl = tcfab.chaos_timeline("tiny-flap", device="cpu")
    _, w = _run(tl, warm=True)
    _, c = _run(tl, warm=False)
    feas = w.feasible[1:].to(torch.int64)
    assert int((w.probes[1:] * feas).sum()) < int((c.probes[1:] * feas).sum())
    assert int(w.locked[-1].sum()) >= int(c.locked[-1].sum())


# ---------------------------------------------------------------- sweeps --

def test_chaos_sweep_matches_points_and_reference():
    jspec = jcfab.FABRIC_TINY
    events = dict(thermal=0.3, events=((1, "link_kill", 0),))
    jtl = jfab.make_fabric_timeline(jspec, 3, N, **events)
    ttl = tfab.make_fabric_timeline(SPEC, 3, N, device="cpu", **events)
    ju = jfab.make_fabric_units(jcfab.chaos_timeline("tiny-flap")[0], jspec, 0)
    tu = tfab.make_fabric_units(CFG, SPEC, 0, device="cpu")
    axes = {"tr_mean": [4.0, 5.0]}
    req = SweepRequest(cfg=CFG, units=tu, scheme="vtrs_ssm", fabric=SPEC, timeline=ttl,
                       axes=axes)
    res = sweep(req).data
    assert res.wl is None and res.health is None
    assert tuple(res.probes.shape) == (2, 3) and res.feasible.dtype == torch.float32
    assert tuple(res.fabric.bandwidth.shape) == (2, 3)
    one = sweep(req.replace(chunk_size=1)).data
    for i, tr in enumerate(axes["tr_mean"]):
        _, cs = tfab.run_fabric_timeline(CFG, tu, SPEC, ttl, {"tr_mean": tr})
        s = tfab.summarize_chaos(cs)
        for f in PER_LINK[1:]:
            assert torch.equal(getattr(res, f)[i], getattr(s, f)), f
            assert torch.equal(getattr(one, f), getattr(res, f)), f
        for f in s.fabric._fields:
            assert torch.equal(getattr(res.fabric, f)[i], getattr(s.fabric, f)), f
            assert torch.equal(getattr(one.fabric, f), getattr(res.fabric, f)), f
    cfg = jcfab.chaos_timeline("tiny-flap")[0]
    want = jsw.sweep(jsw.SweepRequest(cfg=cfg, units=ju, scheme="vtrs_ssm", fabric=jspec,
                                      timeline=jtl, axes=axes)).data
    for f in PER_LINK[1:]:
        _close(getattr(res, f).numpy(), getattr(want, f), SPEC.n_links, f)
    for f in res.fabric._fields:
        _close(getattr(res.fabric, f).numpy(), getattr(want.fabric, f), SPEC.n_links, f)
