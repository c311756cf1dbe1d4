"""The port's multi-device paths over a 1-D ``SweepMesh`` on the CPU:
``sweep(mesh=)``, fabric ``bringup(mesh=)``, ``run_fabric_timeline(mesh=)``,
``chunked_map``'s plan and ``checkpoint.store.restore(shardings=)``.

The reference's contract for ``mesh=`` is "bit-identical to the unsharded
engine and invariant to the mesh size" (``src/repro/core/sweep.py``).  Its
own mesh path fails under the installed jax (ROADMAP queue 3), so each
family is held here to the port's unsharded path bit for bit, on meshes of
1 to 4 placeholder CPU devices (a ``SweepMesh`` accepts repeats) at chunk
sizes 1 and 2, some with more devices than chunks; and one mesh case of each
family to the reference's *unsharded* path, with the tolerances of the
existing tests: integer and boolean outputs exactly, AFP/CAFP and the other
shares as integer counts exactly (and within 1e-7; fabric means within
1.2e-7 relative), timeline trial means as integer sums, ``min_tr`` bit for
bit.
"""
import dataclasses
import functools
import importlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import fabric as jfab  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import fabric as jcfab  # noqa: E402
from repro.configs import wdm as jwdm  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import temporal as jtemp  # noqa: E402
from repro_torch import fabric as tfab  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import fabric as tcfab  # noqa: E402
from repro_torch.convert import config_from_fields, timeline_from_numpy, units_from_numpy  # noqa: E402
from repro_torch.core.protocol import ProtocolState, cold_state  # noqa: E402
from repro_torch.launch import SweepMesh, make_sweep_mesh  # noqa: E402
from repro_torch.obs.phase import PhaseRecorder, use_recorder  # noqa: E402

jsw = importlib.import_module("repro.core.sweep")
tsw = importlib.import_module("repro_torch.core.sweep")

ROOT = Path(__file__).resolve().parents[1]
JCFG = jwdm.WDM8_G200
TCFG = config_from_fields(**dataclasses.asdict(JCFG))
RLVS = np.array([0.28, 2.24], np.float32)
AXES = {"sigma_rlv": RLVS, "tr_mean": np.array([3.0, 5.0, 9.5], np.float32)}
TR_AXIS = {"tr_mean": np.array([5.0, 9.5], np.float32)}
TIMELINE_AXIS = {"sigma_rlv": np.array([0.2, 2.24], np.float32)}
FABRIC_AXES = {"comb_coupling": [0.0, 1.0], "tr_mean": [4.0, 5.0]}
FAMILIES = ("policy ltc", "scheme seq", "scheme protocol_lta", "min_tr lta", "timeline",
            "fabric sweep", "bringup", "chaos")


@functools.lru_cache(maxsize=None)
def _inputs():
    """Both packages' inputs: WDM8 units (3 x 3), a 3-step timeline with a
    lane kill, FABRIC_TINY units, tiny-flap's scenario."""
    ju = japi.make_units(JCFG, 2, 3, 3)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    jtl = jtemp.make_timeline(3, 8, thermal=0.2, events=((1, "lane_kill", 3),))
    ttl = timeline_from_numpy(*(np.asarray(a) for a in jtl), device="cpu")
    jfu = jfab.make_fabric_units(JCFG, jcfab.FABRIC_TINY, 3)
    tfu = tfab.make_fabric_units(TCFG, tcfab.FABRIC_TINY, 3, device="cpu")
    jcc, jcs, jct = jcfab.chaos_timeline("tiny-flap")
    tcc, tcs, tct = tcfab.chaos_timeline("tiny-flap", device="cpu")
    return dict(ju=ju, tu=tu, jtl=jtl, ttl=ttl, jfu=jfu, tfu=tfu,
                jchaos=(jcc, jcs, jct, jfab.make_fabric_units(jcc, jcs, 0)),
                tchaos=(tcc, tcs, tct, tfab.make_fabric_units(tcc, tcs, 0, device="cpu")))


def _run(family: str, chunk: int, mesh):
    """The port's result of ``family`` at ``chunk`` (grid points a chunk;
    links a chunk for bring-up, twice as many for chaos) on ``mesh`` (None:
    unsharded)."""
    d = _inputs()
    tu = d["tu"]
    if family == "policy ltc":
        return tsw.sweep_policy(TCFG, tu, "ltc", AXES, chunk_size=chunk, mesh=mesh)
    if family == "scheme seq":
        return tsw.sweep_scheme(TCFG, tu, "seq", AXES, chunk_size=chunk, mesh=mesh)
    if family == "scheme protocol_lta":
        return tsw.sweep_scheme(TCFG, tu, "protocol_lta", TR_AXIS, chunk_size=chunk, mesh=mesh)
    if family == "min_tr lta":
        return tsw.sweep_min_tr(TCFG, tu, "lta", {"sigma_rlv": np.array([0.28, 1.12, 2.24])},
                                chunk_size=chunk, mesh=mesh)
    if family == "timeline":
        return tsw.sweep(tsw.SweepRequest(
            cfg=TCFG, units=tu, scheme="protocol_lta", timeline=d["ttl"],
            axes=TIMELINE_AXIS, fixed={"tr_mean": 5.0}, chunk_size=chunk, mesh=mesh)).data
    if family == "fabric sweep":
        return tsw.sweep(tsw.SweepRequest(
            cfg=TCFG, units=d["tfu"], scheme="vtrs_ssm", fabric=tcfab.FABRIC_TINY,
            axes=FABRIC_AXES, chunk_size=chunk, mesh=mesh)).data
    if family == "bringup":
        r = tfab.bringup(TCFG, tcfab.FABRIC_TINY, tr_mean=5.0, scheme="protocol_lta", seed=3,
                         device="cpu", link_chunk=chunk, mesh=mesh)
        return r.ev, r.stats, r.state, r.system
    cfg, spec, tl, units = d["tchaos"]
    return tfab.run_fabric_timeline(cfg, units, spec, tl, scheme="vtrs_ssm", health=True,
                                    link_chunk=2 * chunk, mesh=mesh)


def _same(got, want, what=""):
    """Equal structure, and every tensor equal exactly (float32 bit for bit)."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        fields = getattr(want, "_fields", range(len(want)))
        for f, g, w in zip(fields, got, want):
            _same(g, w, f"{what}.{f}")
        return
    if want is None:
        assert got is None, what
        return
    assert got.dtype == want.dtype and got.shape == want.shape and got.device == want.device, what
    view = (lambda x: x.view(torch.int32)) if want.dtype == torch.float32 else (lambda x: x)
    assert torch.equal(view(got), view(want)), what


@functools.lru_cache(maxsize=None)
def _unsharded(family: str, chunk: int):
    return _run(family, chunk, None)


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("size", [1, 2, 3, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_mesh_equals_unsharded(family, size, chunk):
    """Bit for bit, on every mesh size; at chunk 2 the policy grid's two
    points are one chunk, so meshes of 2 to 4 devices leave devices idle."""
    _same(_run(family, chunk, SweepMesh(("cpu",) * size)), _unsharded(family, chunk), family)


def _counts(x, n):
    return np.rint(np.asarray(x, np.float64) * n).astype(np.int64)


def _hold(got, want, n, rel=False):
    """Shares as counts over ``n`` exactly and within 1e-7 (``rel``: 1.2e-7
    relative); integer and boolean fields exactly."""
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape
    if g.dtype == np.float32:
        np.testing.assert_array_equal(_counts(g, n), _counts(w, n))
        tol = 1.2e-7 * np.maximum(1.0, np.abs(w)) if rel else 1e-7
        assert (np.abs(g.astype(np.float64) - w) <= tol).all()
    else:
        np.testing.assert_array_equal(g, w)


@functools.lru_cache(maxsize=None)
def _reference(family: str):
    """The reference's unsharded result of ``family``."""
    d = _inputs()
    ju = d["ju"]
    if family == "policy ltc":
        return jsw.sweep_policy(JCFG, ju, "ltc", AXES)
    if family == "scheme seq":
        return jsw.sweep_scheme(JCFG, ju, "seq", AXES)
    if family == "scheme protocol_lta":
        return jsw.sweep_scheme(JCFG, ju, "protocol_lta", TR_AXIS)
    if family == "min_tr lta":
        return jsw.sweep_min_tr(JCFG, ju, "lta", {"sigma_rlv": np.array([0.28, 1.12, 2.24])})
    if family == "timeline":
        return jsw.sweep(jsw.SweepRequest(
            cfg=JCFG, units=ju, scheme="protocol_lta", timeline=d["jtl"],
            axes=TIMELINE_AXIS, fixed={"tr_mean": 5.0})).data
    if family == "fabric sweep":
        return jsw.sweep(jsw.SweepRequest(cfg=JCFG, units=d["jfu"], scheme="vtrs_ssm",
                                          fabric=jcfab.FABRIC_TINY, axes=FABRIC_AXES)).data
    if family == "bringup":
        r = jfab.bringup(JCFG, jcfab.FABRIC_TINY, tr_mean=5.0, scheme="protocol_lta", seed=3)
        return r.ev, r.stats, r.state, r.system
    cfg, spec, tl, units = d["jchaos"]
    return jfab.run_fabric_timeline(cfg, units, spec, tl, scheme="vtrs_ssm", health=True)


@pytest.mark.parametrize("family", FAMILIES)
def test_mesh_equals_reference_unsharded(family):
    got = _run(family, 1, SweepMesh(("cpu",) * 3))
    want = _reference(family)
    trials, links = 9, tcfab.FABRIC_TINY.n_links
    if family in ("policy ltc", "min_tr lta"):
        np.testing.assert_array_equal(got.numpy().view(np.int32) if family == "min_tr lta"
                                      else _counts(got.numpy(), trials),
                                      np.asarray(want).view(np.int32) if family == "min_tr lta"
                                      else _counts(want, trials))
    elif family.startswith("scheme"):
        for f, g, w in zip(got._fields, got, want):
            _hold(g, w, trials)
    elif family == "timeline":  # trial means (probes, rounds, ...) as integer sums
        for f, g, w in zip(got._fields, got, want):
            np.testing.assert_array_equal(_counts(g.numpy(), trials), _counts(w, trials),
                                          err_msg=f)
    elif family == "fabric sweep":
        for f, g, w in zip(got._fields, got, want):
            _hold(g, w, links, rel=True)
    elif family == "bringup":
        # (the systems: the reference's jitted instantiate is an FMA apart,
        # ROADMAP queue 3; tests/test_torch_fabric.py holds them to its eager
        # form, and the mesh cases above to the unsharded port)
        (ev, stats, state, _), (jev, jstats, jstate, _) = got, want
        for part, ref in ((ev, jev), (state, jstate)):
            for f, g, w in zip(part._fields, part, ref):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
        for f, g, w in zip(stats._fields, stats, jstats):
            _hold(g, w, links, rel=True)
    else:
        (state, cs), (jstate, jcs) = got, want
        for f in ("wl", "probes", "rounds", "locked", "broken", "churn", "feasible", "health"):
            np.testing.assert_array_equal(getattr(cs, f).numpy(), np.asarray(getattr(jcs, f)),
                                          err_msg=f)
        for f, g, w in zip(cs.fabric._fields, cs.fabric, jcs.fabric):
            _hold(g, w, links, rel=True)
        for f, g, w in zip(state._fields, state, jstate):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


def test_fabric_sweep_shards_points_not_links():
    """A fabric sweep's mesh splits the chunks of grid points; each point's
    inner link chunks run whole on its device, unsharded."""
    rec = PhaseRecorder()
    with use_recorder(rec):
        _run("fabric sweep", 1, SweepMesh(("cpu",) * 3))
    notes = {n["name"]: n for n in rec.notes}
    assert notes["chunked_map.sweep_points"]["n_chunks"] == 6  # 4 points, rounded up to 3 x 2
    assert notes["chunked_map.fabric_links"]["n_chunks"] == 1


_REFERENCE_PLAN = """
import json, sys
import jax.numpy as jnp
from repro.core.sweep import chunked_map
from repro.launch.mesh import make_sweep_mesh
from repro.obs.phase import PhaseRecorder, use_recorder

out = []
for items, chunk, n_dev in json.loads(sys.argv[1]):
    rec = PhaseRecorder()
    with use_recorder(rec):
        got = chunked_map(lambda x: x * 2.0, jnp.arange(float(items)), chunk=chunk,
                          mesh=make_sweep_mesh(n_dev), tag="plan")
    assert got.tolist() == [2.0 * i for i in range(items)]
    out.append(rec.notes[0]["n_chunks"])
print(json.dumps(out))
"""


def test_chunked_map_plan_note_matches_reference():
    """The plan note's n_chunks is the reference's, rounded up to whole
    chunks per device (the reference's ``shard_map`` runs on placeholder
    CPU devices in a subprocess: jax fixes the host device count at start)."""
    import json

    cases = [(7, 2, 1), (7, 2, 3), (5, 1, 4), (2, 2, 4), (9, 3, 2), (8, 4, 4)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _REFERENCE_PLAN, json.dumps(cases)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = []
    for items, chunk, n_dev in cases:
        rec = PhaseRecorder()
        with use_recorder(rec):
            out = tsw.chunked_map(lambda x: x * 2.0, torch.arange(float(items)), chunk=chunk,
                                  mesh=SweepMesh(("cpu",) * n_dev), tag="plan")
        assert out.tolist() == [2.0 * i for i in range(items)]
        got.append(rec.notes[0]["n_chunks"])
    assert got == want == [4, 6, 8, 4, 4, 4]


def test_chunked_map_places_chunks_and_returns_home():
    """Device d runs the contiguous chunks [d k, (d + 1) k); broadcast trees
    reach every chunk; results come back to the device of ``xs``."""
    seen = []

    def fn(offset, item):
        seen.append(item.tolist())
        return item + offset

    mesh = SweepMesh(("cpu",) * 3)
    out = tsw.chunked_map(fn, torch.arange(5), chunk=1, mesh=mesh,
                          broadcast=(torch.tensor(10),))
    assert out.tolist() == [10, 11, 12, 13, 14] and out.device.type == "cpu"
    assert seen == [[0], [1], [2], [3], [4]]  # chunks 0-1, 2-3, 4 (and an empty 5)
    tree = tsw.chunked_map(lambda item: (torch.from_numpy(item[0] * 2), None),
                           (np.arange(4.0), None), chunk=3, mesh=mesh)
    assert tree[1] is None and tree[0].tolist() == [0.0, 2.0, 4.0, 6.0]


def test_mesh_validation():
    # a 2-D jax mesh gets the reference's message from both packages
    mesh_2d = jax.sharding.Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1),
                                ("data", "model"))
    message = r"sweep meshes are 1-D \(the chunk axis\); got axes \('data', 'model'\)"
    with pytest.raises(ValueError, match=message):
        jsw.SweepRequest(cfg=JCFG, units=_inputs()["ju"], policy="ltc", axes=AXES, mesh=mesh_2d)
    with pytest.raises(ValueError, match=message):
        tsw.SweepRequest(cfg=TCFG, units=_inputs()["tu"], policy="ltc", axes=AXES, mesh=mesh_2d)
    with pytest.raises(TypeError, match="make_sweep_mesh"):
        tfab.bringup(TCFG, tcfab.FABRIC_TINY, device="cpu", mesh=("cpu",))
    with pytest.raises(ValueError, match="at least one device"):
        SweepMesh(())
    mesh = SweepMesh(["cpu", torch.device("cpu")])
    assert mesh.size == 2 and mesh.axis_names == ("sweep",)
    assert mesh.devices == (torch.device("cpu"),) * 2
    # sweep_reference ignores the mesh
    req = tsw.SweepRequest(cfg=TCFG, units=_inputs()["tu"], policy="ltc", axes=AXES, mesh=mesh)
    _same(tsw.sweep_reference(req).data, tsw.sweep_reference(req.replace(mesh=None)).data)


def test_make_sweep_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sweep_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_sweep_mesh(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="need 3 devices for a sweep mesh, have 2"):
        make_sweep_mesh(3)
    assert make_sweep_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_sweep_mesh(1).size == 1


def test_restore_shardings_of_a_reference_checkpoint():
    """A checkpoint the reference wrote restores, with ``shardings``, as the
    reference's own restore onto ``SingleDeviceSharding(cpu)``; a tree of
    another structure raises in both."""
    import jax.numpy as jnp
    from repro.core import protocol as jproto

    rng = np.random.default_rng(5)
    fields = [rng.integers(-1, 8, (6, 8)).astype(np.int32) for _ in range(3)] + \
        [rng.integers(0, 50, (6,)).astype(np.int32)]
    jstate = jproto.ProtocolState(*(jnp.asarray(f) for f in fields))
    cpu = jax.devices("cpu")[0]
    with tempfile.TemporaryDirectory() as d:
        jstore.save(d, 3, jstate)
        jshard = jproto.ProtocolState(*(jax.sharding.SingleDeviceSharding(cpu),) * 4)
        want = jstore.restore(d, 3, jstate, shardings=jshard)
        target = cold_state(6, 8, "cpu")
        got = store.restore(d, 3, target, shardings=ProtocolState(
            torch.device("cpu"), "cpu", None, torch.device("cpu")))
        assert type(got) is ProtocolState
        for f, g, w in zip(got._fields, got, want):
            assert g.device.type == "cpu" and g.dtype == torch.int32, f
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
        with pytest.raises(ValueError):
            jstore.restore(d, 3, jstate, shardings=(jshard.lock,) * 3)
        for bad in ((None,) * 4, {"lock": None}, "cpu"):
            with pytest.raises(ValueError, match="shardings do not match"):
                store.restore(d, 3, target, shardings=bad)
