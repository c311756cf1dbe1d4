"""The port's Lock-to-Any path against the JAX reference on identical inputs,
on the CPU: adjacency packing, the ``match`` and ``bottleneck`` kernels'
plain versions (against the Pallas kernels in interpret mode and against the
reference core), the ``seq_retry`` arbiter on shared search tables, the LtA
policy entry points, and the fig17 retry-budget setting.

Tolerances: integer and boolean outputs (bitmasks, ``match_wl``, ok flags,
entries, line ids) are exact and thresholds and deltas bit for bit, against
the reference's eager core functions and its Pallas kernels.  The jitted
reference entry points are held bit for bit through their un-jitted bodies
(``policy_min_tr_impl``), and the jitted ``policy_min_tr`` within 1e-6 nm:
under ``jax.jit`` XLA:CPU fuses ``instantiate``'s ``ring_grid + s_rlv *
u_rlv`` into a multiply-add, so 8 of 32 ring wavelengths (WDM4 permuted,
8 x 8, seed 3) sit one ulp (<= 4.8e-7 nm at |ring| < 8 nm) from the eager
values, which the port reproduces, and the thresholds built on them move by
as much.  Jitted AFP and CAFP are held as exact failure counts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from benchmarks.common import tr_sweep  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import matching as jmatch  # noqa: E402
from repro.core.grid import wdm_config  # noqa: E402
from repro.core.lta_retry import sequential_retry as jretry  # noqa: E402
from repro.core.reach import reach_matrix as jreach  # noqa: E402
from repro.core.reach import scaled_residual as jres  # noqa: E402
from repro.core.sampling import instantiate as jinst  # noqa: E402
from repro.core.search_table import build_search_tables as jbuild  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    config_from_fields,
    tables_from_numpy,
    units_from_numpy,
)
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import ideal as tideal  # noqa: E402
from repro_torch.core import matching as tmatch  # noqa: E402
from repro_torch.core.lta_retry import sequential_retry as tretry  # noqa: E402
from repro_torch.core.reach import reach_matrix as treach  # noqa: E402
from repro_torch.core.reach import scaled_residual as tres  # noqa: E402
from repro_torch.core.sampling import instantiate as tinst  # noqa: E402
from repro_torch.kernels.bitmask_match import (  # noqa: E402
    bottleneck_threshold,
    bottleneck_threshold_plain,
    perfect_matching,
    perfect_matching_plain,
)

CFGS = {
    "wdm4-natural": wdm_config(n_ch=4),
    "wdm4-permuted": wdm_config(n_ch=4).with_orders("permuted"),
    "wdm8-natural": wdm_config(n_ch=8),
    "wdm8-permuted": wdm_config(n_ch=8).with_orders("permuted"),
}
BUDGETS = {
    "seq_retry": {},
    "seq_retry_r1": {"n_rounds": 1},
    "seq_retry_r2": {"n_rounds": 2},
    "seq_retry_r4": {"n_rounds": 4},
    "seq_retry_phys": {"constrained_first": False},
}


def _systems(jcfg, seed, n_laser, n_ring):
    """The same trials as a reference and a port SystemBatch, and configs."""
    ju = japi.make_units(jcfg, seed, n_laser, n_ring)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    return jcfg, ju, jinst(jcfg, ju), tcfg, tu, tinst(tcfg, tu)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _reference_words(adj):
    """The reference's packing as one unsigned word per ring, viewed int64."""
    a = np.asarray(adj)
    if a.ndim == 3:                     # (T, N, 2) little-endian uint32 words
        a = a[..., 0].astype(np.uint64) | (a[..., 1].astype(np.uint64) << np.uint64(32))
    else:                               # (T, N) int32, read as uint32
        a = a.astype(np.uint32).astype(np.uint64)
    return a.view(np.int64)


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_adjacency_bitmask_matches_reference(n):
    rng = np.random.default_rng(n)
    reach = rng.random((6, n, n)) < 0.5
    reach[0] = True                     # every bit set, bit n-1 included
    got = tmatch.adjacency_bitmask(torch.from_numpy(reach))
    assert got.dtype == torch.int64 and tuple(got.shape) == (6, n)
    _eq(got.numpy(), _reference_words(jmatch.adjacency_bitmask(jnp.asarray(reach))))
    # real reach matrices of sampled systems
    _, _, js, _, _, ts = _systems(wdm_config(n_ch=n), 2, 3, 3)
    got = tmatch.adjacency_bitmask(treach(ts, 6.0))
    _eq(got.numpy(), _reference_words(jmatch.adjacency_bitmask(jreach(js, 6.0))))


@pytest.mark.parametrize("tr", [2.0, 4.5, 9.0])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_perfect_matching_plain_matches_pallas_and_core(n, tr):
    """``match_wl`` on every trial, perfect or not, and the ok flags."""
    _, _, js, _, _, ts = _systems(wdm_config(n_ch=n), 1, 10, 10)
    j_adj = jmatch.adjacency_bitmask(jreach(js, tr))
    mw, ok = perfect_matching(tmatch.adjacency_bitmask(treach(ts, tr)))
    assert mw.dtype == torch.int32 and ok.dtype == torch.bool
    mw_k, ok_k = ops.perfect_matching(j_adj, backend="interpret")
    mw_c, mr_c = jmatch.max_matching(j_adj)
    _eq(mw.numpy(), mw_k)
    _eq(mw.numpy(), mw_c)
    _eq(ok.numpy(), ok_k)
    _eq(ok.numpy(), jmatch.has_perfect_matching(jreach(js, tr)))
    _eq(tmatch.max_matching(tmatch.adjacency_bitmask(treach(ts, tr)))[1].numpy(), mr_c)
    if tr == 2.0:
        assert 0 < int(ok.sum()) < ok.numel()     # the case holds both outcomes


@pytest.mark.parametrize("density", [0.08, 0.2, 0.5])
@pytest.mark.parametrize("n", [32, 64])
def test_perfect_matching_plain_wide_matches_core(n, density):
    """Random bitmasks with the top bit in play: bit 31 at N = 32 (negative
    int32 word in the reference), bit 63 at N = 64 (two reference words)."""
    rng = np.random.default_rng(int(n * 10 + density * 100))
    reach = rng.random((8, n, n)) < density
    reach[:, :, n - 1] |= rng.random((8, n)) < 0.5
    j_adj = jmatch.adjacency_bitmask(jnp.asarray(reach))
    mw, ok = perfect_matching_plain(tmatch.adjacency_bitmask(torch.from_numpy(reach)))
    _eq(mw.numpy(), jmatch.max_matching(j_adj)[0])
    _eq(ok.numpy(), jmatch.has_perfect_matching(jnp.asarray(reach)))


def _quantized(n, seed=0, t=24):
    return np.random.default_rng(seed).integers(0, 4, (t, n, n)).astype(np.float32)


@pytest.mark.parametrize("kind", ["residual", "quantized"])
@pytest.mark.parametrize("n", [8, 16])
def test_bottleneck_plain_matches_pallas_and_core(n, kind):
    """N = 8 crosses the reference's Hall path, N = 16 its sweep; quantized
    integer weights 0-3 force massive ties."""
    if kind == "residual":
        _, _, js, _, _, ts = _systems(wdm_config(n_ch=n), 3, 6, 6)
        w_j, w_t = jres(js), tres(ts)
    else:
        w = _quantized(n)
        w_j, w_t = jnp.asarray(w), torch.from_numpy(w)
    thr = bottleneck_threshold(w_t)
    assert thr.dtype == torch.float32
    _eq(_bits(thr.numpy()), _bits(ops.bottleneck_threshold(w_j, backend="interpret")))
    _eq(_bits(thr.numpy()), _bits(jmatch.bottleneck_matching_threshold(w_j)))
    _eq(_bits(bottleneck_threshold_plain(w_t).numpy()),
        _bits(jmatch._bottleneck_threshold_kuhn(w_j)))


@pytest.mark.parametrize("tr", [5.0, 8.96])
@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("name", ["wdm4-permuted", "wdm8-natural", "wdm8-permuted"])
def test_sequential_retry_matches_reference(name, budget, tr):
    """The arbiter alone, on the reference's own search tables."""
    _, _, js, _, _, _ = _systems(CFGS[name], 3, 8, 8)
    jt = jbuild(js, tr)
    tt = tables_from_numpy(*(np.asarray(a) for a in jt), device="cpu")
    a_j = jretry(jt, **BUDGETS[budget])
    a_t = tretry(tt, **BUDGETS[budget])
    assert a_t.entry.dtype == torch.int32 and a_t.wl.dtype == torch.int32
    _eq(a_t.entry.numpy(), a_j.entry)
    _eq(a_t.wl.numpy(), a_j.wl)
    _eq(_bits(a_t.delta.numpy()), _bits(a_j.delta))


def test_sequential_retry_stable_lock_order_on_ties():
    """Rings with equal peak counts lock in ring index order (the stable
    argsort ``jnp.argsort`` gives), on tables full of such ties."""
    _, _, js, _, _, _ = _systems(CFGS["wdm8-natural"], 5, 6, 6)
    jt = jbuild(js, 20.0)                       # TR past the FSR: many aliases
    n_valid = np.asarray(jt.n_valid)
    assert all(len(set(row.tolist())) < len(row) for row in n_valid)
    tt = tables_from_numpy(*(np.asarray(a) for a in jt), device="cpu")
    _eq(tretry(tt).wl.numpy(), jretry(jt).wl)


@pytest.mark.parametrize("name", list(CFGS))
def test_lta_policy_entry_points_match_reference(name):
    jcfg, ju, js, tcfg, tu, ts = _systems(CFGS[name], 3, 8, 8)
    per_trial = tideal.min_tr(ts, "lta", tcfg.s)
    eager = jmatch.bottleneck_matching_threshold(jres(js))
    _eq(_bits(per_trial.numpy()), _bits(eager))
    _eq(_bits(tapi.policy_trial_min_tr(tcfg, tu, "lta").numpy()), _bits(eager))
    m_t = tapi.policy_min_tr(tcfg, tu, "lta")
    _eq(_bits(m_t.numpy()), _bits(np.max(np.asarray(eager))))
    _eq(_bits(m_t.numpy()), _bits(japi.policy_min_tr_impl(jcfg, ju, "lta")))
    assert abs(float(m_t) - float(japi.policy_min_tr(jcfg, ju, "lta"))) <= 1e-6
    for tr in (2.0, 3.5, 5.0, 8.96):
        ok_t = tideal.success(ts, "lta", tcfg.s, tr)
        _eq(ok_t.numpy(), jmatch.has_perfect_matching(jreach(js, tr)))
        _eq(ok_t.numpy(), per_trial.numpy() <= np.float32(tr))
        a_t = float(tapi.evaluate_policy(tcfg, tu, "lta", tr))
        a_j = float(japi.evaluate_policy(jcfg, ju, "lta", tr))
        assert round(a_t * 64) == round(a_j * 64) and abs(a_t - a_j) <= 1e-7


@pytest.mark.parametrize("n", [16, 32])
def test_lta_policy_wide_matches_reference_impl(n):
    """WDM16 and WDM32 on 30 trials: ideal LtA success per trial (the
    ``match`` kernel's plain version) against the reference core, and
    ``evaluate_policy("lta")`` against the reference's un-jitted body, AFP
    as an exact failure count and within 1e-7."""
    jcfg, ju, js, tcfg, tu, ts = _systems(wdm_config(n_ch=n), 3, 5, 6)
    fails = 0
    for tr in (2.0, 4.48, 8.96):
        ok_t = tideal.success(ts, "lta", tcfg.s, tr)
        _eq(ok_t.numpy(), jmatch.has_perfect_matching(jreach(js, tr)))
        a_t = float(tapi.evaluate_policy(tcfg, tu, "lta", tr))
        a_j = float(japi.evaluate_policy_impl(jcfg, ju, "lta", tr))
        assert round(a_t * 30) == round(a_j * 30) == int((~ok_t).sum())
        assert abs(a_t - a_j) <= 1e-7
        fails += int((~ok_t).sum())
    assert fails > 0


def test_fig17_seq_retry_cafp_counts_match_live_reference():
    """fig17's setting: WDM8_G200, the reference's units at seed 17 (24 x 24),
    the paper's 12-point TR sweep.  CAFP failure counts equal the reference's
    live ``evaluate_scheme`` at every TR."""
    jcfg, ju, _, tcfg, tu, _ = _systems(wdm_config(n_ch=8, ghz=200), 17, 24, 24)
    t = 24 * 24
    counts_t, counts_j = [], []
    for tr in tr_sweep():
        r = tapi.evaluate_scheme(tcfg, tu, "seq_retry", float(tr))
        jr = japi.evaluate_scheme(jcfg, ju, "seq_retry", float(tr))
        counts_t.append(int((~r.alg_success & r.ideal_ok).sum()))
        counts_j.append(int(np.sum(~np.asarray(jr.alg_success) & np.asarray(jr.ideal_ok))))
        assert round(float(r.cafp) * t) == counts_t[-1]
        assert abs(float(r.cafp) - float(jr.cafp)) <= 1e-7
    assert counts_t == counts_j
    assert counts_t[:5] == [0, 0, 2, 138, 217]  # 0.0035 * 576 = 2, 0.2396 -> 138
