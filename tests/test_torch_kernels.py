"""The port's kernel modules (``feasibility``, ``table_build``) against the
JAX reference on identical inputs, on the CPU (their plain versions).

Tolerances: per-trial minimum TRs, residuals, line ids, entry counts and
table deltas are held exactly (float32 bit for bit) against the core
reference.  Against the reference's *streaming* table builder, ``wl`` and
``n_valid`` agree exactly and ``delta`` is held to one ulp of the larger of
|j*fsr| and delta: that builder fuses its multiply-add (see
``_assert_tables``), so it differs from its own dense oracle there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import ideal as jideal  # noqa: E402
from repro.core import reach as jreach  # noqa: E402
from repro.core.grid import wdm_config  # noqa: E402
from repro.core.sampling import SystemBatch as JSys  # noqa: E402
from repro.core.sampling import instantiate as jinst  # noqa: E402
from repro.core.search_table import (  # noqa: E402
    build_search_tables,
    build_search_tables_dense,
)
from repro.kernels import ops  # noqa: E402
from repro_torch.convert import config_from_fields, units_from_numpy  # noqa: E402
from repro_torch.core import ideal as tideal  # noqa: E402
from repro_torch.core import reach as treach  # noqa: E402
from repro_torch.core.sampling import SystemBatch as TSys  # noqa: E402
from repro_torch.core.sampling import instantiate as tinst  # noqa: E402
from repro_torch.core.search_table import build_search_tables as tbuild  # noqa: E402
from repro_torch.core.search_table import mask_wavelength  # noqa: E402
from repro_torch.kernels.feasibility import feasibility  # noqa: E402
from repro_torch.kernels.table_build import build_tables  # noqa: E402

CFGS = {
    "wdm4-natural": wdm_config(n_ch=4),
    "wdm4-permuted": wdm_config(n_ch=4).with_orders("permuted"),
    "wdm8-natural": wdm_config(n_ch=8),
    "wdm8-permuted": wdm_config(n_ch=8).with_orders("permuted"),
}


def _systems(name, seed=3, n_laser=8, n_ring=8):
    """The same 8 x 8 trials as a reference and a port SystemBatch."""
    jcfg = CFGS[name]
    ju = japi.make_units(jcfg, seed, n_laser, n_ring)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    return jcfg, jinst(jcfg, ju), tcfg, tinst(tcfg, tu)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _tsys(jsys):
    return TSys(*(torch.tensor(np.asarray(a)) for a in jsys))


def assert_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", list(CFGS))
def test_min_tr_matches_core_ideal_bit_for_bit(name):
    jcfg, js, tcfg, ts = _systems(name)
    s = jnp.asarray(jcfg.s)
    assert_bits(tideal.ltd_min_tr(ts, tcfg.s).numpy(), jideal.ltd_min_tr(js, s))
    assert_bits(tideal.ltc_min_tr(ts, tcfg.s).numpy(), jideal.ltc_min_tr(js, s))
    np.testing.assert_array_equal(tideal.ltc_best_shift(ts, tcfg.s).numpy(),
                                  np.asarray(jideal.ltc_best_shift(js, s)))
    assert_bits(treach.scaled_residual(ts).numpy(), jreach.scaled_residual(js))
    for tr in (5.0, 8.96):
        for policy in ("ltd", "ltc"):
            np.testing.assert_array_equal(
                tideal.success(ts, policy, tcfg.s, tr).numpy(),
                np.asarray(jideal.success(js, policy, s, tr)))
        np.testing.assert_array_equal(treach.reach_matrix(ts, tr).numpy(),
                                      np.asarray(jreach.reach_matrix(js, tr)))


@pytest.mark.parametrize("name", ["wdm8-natural", "wdm8-permuted"])
def test_min_tr_matches_pallas_interpret(name):
    """Within 1 ulp: the Pallas kernel multiplies by 1/tr_unit and forms the
    residual as d - fsr*floor(d/fsr); the port follows the core formula
    (``jnp.mod``, then an IEEE divide), held exactly above."""
    jcfg, js, tcfg, ts = _systems(name)
    ltd_k, ltc_k = ops.feasibility(*js, s=jcfg.s, backend="interpret")
    ltd, ltc = feasibility(*ts, tcfg.s)
    np.testing.assert_array_max_ulp(ltd.numpy(), np.asarray(ltd_k), maxulp=1)
    np.testing.assert_array_max_ulp(ltc.numpy(), np.asarray(ltc_k), maxulp=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_min_tr_near_integer_residuals(seed):
    """d / fsr within an ulp of an integer: the remainder's sign fix and
    the IEEE divide must follow ``jnp.mod`` exactly."""
    rng = np.random.default_rng(seed)
    t, n = 64, 8
    fsr = (8.0 + 2.0 * rng.random((t, n))).astype(np.float32)
    ring = (10.0 * rng.random((t, n)) - 5.0).astype(np.float32)
    laser = ring + rng.integers(-3, 4, (t, n)).astype(np.float32) * fsr
    nudge = rng.integers(0, 3, (t, n))
    laser = np.where(nudge == 1, np.nextafter(laser, np.float32(np.inf)), laser)
    laser = np.where(nudge == 2, np.nextafter(laser, np.float32(-np.inf)), laser)
    tr_unit = (0.9 + 0.2 * rng.random((t, n))).astype(np.float32)
    js = JSys(*(jnp.asarray(a) for a in (laser, ring, fsr, tr_unit)))
    s = rng.permutation(n).astype(np.int32)
    ltd, ltc = feasibility(*_tsys(js), s)
    assert_bits(ltd.numpy(), jideal.ltd_min_tr(js, jnp.asarray(s)))
    assert_bits(ltc.numpy(), jideal.ltc_min_tr(js, jnp.asarray(s)))


def _assert_tables(tt, jsys, tr, vis, max_alias=8, max_entries=None):
    kw = dict(visible=None if vis is None else jnp.asarray(vis),
              max_alias=max_alias, max_entries=max_entries)
    dense = build_search_tables_dense(jsys, tr, **kw)
    stream = build_search_tables(jsys, tr, **kw)
    assert tt.wl.dtype == torch.int32 and tt.n_valid.dtype == torch.int32
    for ref in (dense, stream):
        np.testing.assert_array_equal(tt.wl.numpy(), np.asarray(ref.wl))
        np.testing.assert_array_equal(tt.n_valid.numpy(), np.asarray(ref.n_valid))
    assert_bits(tt.delta.numpy(), dense.delta)
    # The streaming builder's XLA:CPU loop contracts (laser - ring) - j*fsr
    # into one fused multiply-add; the port and the dense oracle round j*fsr
    # first.  The two differ by at most one ulp of the larger of |j*fsr|
    # and delta.
    fsr = np.asarray(jsys.fsr)[:, :, None]
    scale = np.maximum(np.float32(max_alias) * fsr, np.abs(np.asarray(dense.delta)))
    finite = np.isfinite(np.asarray(dense.delta))
    np.testing.assert_array_equal(np.isfinite(np.asarray(stream.delta)), finite)
    gap = np.abs(tt.delta.numpy()[finite] - np.asarray(stream.delta)[finite])
    assert np.all(gap <= np.spacing(scale[finite]))


def _vis(kind, t, n, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    return rng.random((t, n) if kind == "2d" else (t, n, n)) < 0.6


@pytest.mark.parametrize("vis_kind", ["none", "2d", "3d"])
@pytest.mark.parametrize("tr", [2.0, 8.96, 20.0])
@pytest.mark.parametrize("name", list(CFGS))
def test_tables_match_reference_builders(name, tr, vis_kind):
    jcfg, js, tcfg, ts = _systems(name)
    vis = _vis(vis_kind, ts.n_trials, ts.n_ch)
    tt = tbuild(ts, tr, visible=None if vis is None else torch.from_numpy(vis),
                max_alias=tcfg.max_fsr_alias)
    _assert_tables(tt, js, tr, vis)


@pytest.mark.parametrize("max_alias,max_entries", [(0, None), (3, 5), (1, 40)])
def test_tables_alias_bound_and_width(max_alias, max_entries):
    jcfg, js, tcfg, ts = _systems("wdm8-natural")
    tt = tbuild(ts, 20.0, max_alias=max_alias, max_entries=max_entries)
    _assert_tables(tt, js, 20.0, None, max_alias=max_alias, max_entries=max_entries)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_alias", [1, 3, 8])
def test_tables_tie_order_on_quantized_systems(seed, max_alias):
    """Grid-quantized systems make many candidate deltas exactly equal
    across (line, alias) pairs; ties must fall in flat-index order."""
    rng = np.random.default_rng(seed)
    t, n = 12, 8
    js = JSys(
        laser=jnp.asarray(rng.integers(0, 8, (t, n)).astype(np.float32) * 0.25),
        ring=jnp.asarray(rng.integers(-4, 4, (t, n)).astype(np.float32) * 0.25),
        fsr=jnp.asarray(rng.integers(1, 4, (t, n)).astype(np.float32) * 0.25),
        tr_unit=jnp.ones((t, n), jnp.float32),
    )
    tt = tbuild(_tsys(js), 3.0, max_alias=max_alias)
    _assert_tables(tt, js, 3.0, None, max_alias=max_alias)


@pytest.mark.parametrize("name,tr,vis_kind", [
    ("wdm8-natural", 2.0, "none"),
    ("wdm8-permuted", 8.96, "none"),
    ("wdm8-natural", 20.0, "3d"),
    ("wdm8-permuted", 8.96, "2d"),
])
def test_tables_match_pallas_interpret(name, tr, vis_kind):
    jcfg, js, tcfg, ts = _systems(name)
    vis = _vis(vis_kind, ts.n_trials, ts.n_ch)
    d_k, w_k, nv_k = ops.build_tables(
        js.laser, js.ring, js.fsr, tr * js.tr_unit,
        visible=None if vis is None else jnp.asarray(vis), max_alias=8,
        backend="interpret")
    tr_t = treach.as_f32(tr, "cpu") * ts.tr_unit
    d, w, nv = build_tables(ts.laser, ts.ring, ts.fsr, tr_t,
                            visible=None if vis is None else torch.from_numpy(vis),
                            max_alias=8, max_entries=3 * ts.n_ch)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_k))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(nv_k))
    np.testing.assert_array_max_ulp(d.numpy(), np.asarray(d_k), maxulp=1)


def test_mask_wavelength_first_entry():
    from repro.core.search_table import mask_wavelength as jmask

    jcfg, js, tcfg, ts = _systems("wdm8-permuted")
    jt = build_search_tables(js, 20.0)
    tt = tbuild(ts, 20.0)
    rng = np.random.default_rng(0)
    wl_id = rng.integers(-1, 8, ts.n_trials).astype(np.int32)
    for ring in range(ts.n_ch):
        np.testing.assert_array_equal(
            mask_wavelength(tt, ring, torch.from_numpy(wl_id)).numpy(),
            np.asarray(jmask(jt, ring, jnp.asarray(wl_id))))
