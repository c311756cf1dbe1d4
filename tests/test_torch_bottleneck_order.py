"""Lane-group models of the ``bottleneck`` and ``feasibility`` CUDA kernels
(``src/repro_torch/kernels/csrc/``), in numpy, against the JAX reference on
identical inputs, on the CPU.

CUDA kernels run only on a card, so their search order is modelled here and
held against the reference before it reaches one.  The ``bottleneck`` model keeps the kernel's design: a
group of G lanes per trial (G = 8, 16, 32 for N <= 8, 16, 32, and 32 lanes
with two lines a lane up to N = 64), the order-preserving uint32 key of each
float (-0 and +0 one key, settled lines at the key of +inf), the group's
least key by a butterfly of xor shuffles (one redux at G = 32 in the kernel)
and its first line by a ballot, the exact early stop, the walk-back.  The
``feasibility`` model keeps its reduction over shifts: NaN first, then float
order, the first shift on ties.

Tolerance: thresholds bit for bit (float32 bit patterns), against a
transcription of the serial scan (one thread a trial, the kernel this design
replaces), ``jmatch.bottleneck_matching_threshold``, the Pallas kernel in
interpret mode and the reference's single-pass sweep; NaN positions exactly
and every other value bit for bit against the plain ``feasibility``.  On
signed zeros the serial scan alone decides the bits: the sweep takes
``jnp.maximum`` / ``jnp.min``, which order -0 below +0, and the Pallas kernel
extracts rows by a masked sum, which turns -0 into +0; the sweep is held to
the same values there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import matching as jmatch  # noqa: E402
from repro.core.grid import wdm_config  # noqa: E402
from repro.core.reach import scaled_residual as jres  # noqa: E402
from repro.core.sampling import instantiate as jinst  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro_torch.convert import config_from_fields, units_from_numpy  # noqa: E402
from repro_torch.core.reach import scaled_residual as tres  # noqa: E402
from repro_torch.core.sampling import instantiate as tinst  # noqa: E402
from repro_torch.kernels.bitmask_match import bottleneck_threshold  # noqa: E402
from repro_torch.kernels.feasibility import feasibility_plain, per_shift_min_tr  # noqa: E402

KEY_INF = np.uint32(0xFF800000)   # order_key(+inf)
NO_KEY = np.uint32(0xFFFFFFFF)


def order_key(x):
    """float32 -> uint32 with a < b <=> key(a) < key(b) (not NaN); -0 -> +0."""
    u = np.array(x, np.float32, ndmin=1).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def lane_shape(n):
    """(G lanes a group, L lines a lane) of the kernels' dispatch."""
    if n <= 32:
        return next(g for g in (8, 16, 32) if n <= g), 1
    return 32, 2


def group_first_min(keys):
    """keys (L, G): lane gl holds the keys of indices gl + j * G.  The
    lane-local min over slots, a butterfly of xor shuffles over the group,
    then a ballot per slot and the first set bit.  -> (least key, index)."""
    n_slots, g = keys.shape
    m = keys.min(axis=0)
    lanes = np.arange(g)
    off = g // 2
    while off:
        m = np.minimum(m, m[lanes ^ off])
        off //= 2
    assert (m == m[0]).all(), "the butterfly left the lanes disagreeing"
    for j in range(n_slots):
        hit = np.flatnonzero(keys[j] == m[0])
        if hit.size:
            return m[0], int(hit[0]) + j * g
    raise AssertionError("no lane holds the least key")


def bottleneck_model(w, early_stop=True):
    """The kernel's search on one trial's (N, N) float32 weights.
    Returns (threshold, select steps taken)."""
    n = w.shape[0]
    g, n_slots = lane_shape(n)
    lines = np.arange(n_slots)[:, None] * g + np.arange(g)[None, :]   # (L, G)
    valid = lines < n
    safe = np.minimum(lines, n - 1)
    inf = np.float32(np.inf)
    match_rg = np.full((n_slots, g), -1)
    match_wl = np.full((n_slots, g), -1)
    thr, steps = np.float32(-np.inf), 0
    for i in range(n):
        dist = np.where(valid, w[i][safe], inf).astype(np.float32)
        parent = np.full((n_slots, g), i)
        open_ = valid.copy()
        free_key = NO_KEY
        for _ in range(n):
            key = np.where(open_, order_key(dist).reshape(dist.shape), KEY_INF)
            kmin, kk = group_first_min(key)
            if early_stop and (kmin == KEY_INF or kmin > free_key):
                break
            steps += 1
            dk, r = dist.flat[kk], match_rg.flat[kk]
            open_.flat[kk] = False
            if r < 0:
                free_key = min(free_key, kmin)
                continue
            wk = w[r][safe]
            cand = np.where(wk > dk, wk, dk).astype(np.float32)
            better = open_ & (cand < dist)
            dist = np.where(better, cand, dist).astype(np.float32)
            parent = np.where(better, r, parent)
        fval = np.where(valid & (match_rg < 0), dist, inf).astype(np.float32)
        _, k = group_first_min(order_key(fval).reshape(fval.shape))
        best = fval.flat[k]
        if best > thr:
            thr = best
        for _ in range(n):
            r = parent.flat[k]
            prev = match_wl.flat[r]
            match_wl.flat[r] = k
            match_rg.flat[k] = r
            if r == i:
                break
            k = prev if prev > 0 else 0
    return np.float32(thr), steps


def serial_scan(w):
    """The serial search of one trial, step for step as one thread ran it:
    N select steps a ring over a first-min scan, strict compares.  Only
    compares and selections of input values, so Python floats keep the
    float32 values, signed zeros included."""
    n = w.shape[0]
    w = w.tolist()
    inf = float("inf")
    match_wl, match_rg, thr = [-1] * n, [-1] * n, -inf
    for i in range(n):
        dist, parent, settled = list(w[i]), [i] * n, [False] * n
        for _ in range(n):
            kk, dk = 0, inf if settled[0] else dist[0]
            for k in range(1, n):
                d = inf if settled[k] else dist[k]
                if d < dk:
                    dk, kk = d, k
            settled[kk] = True
            r = match_rg[kk]
            if r < 0:
                continue
            for k in range(n):
                if not settled[k]:
                    cand = w[r][k] if w[r][k] > dk else dk
                    if cand < dist[k]:
                        dist[k], parent[k] = cand, r
        k, best = 0, dist[0] if match_rg[0] < 0 else inf
        for j in range(1, n):
            d = dist[j] if match_rg[j] < 0 else inf
            if d < best:
                best, k = d, j
        if best > thr:
            thr = best
        for _ in range(n):
            r = parent[k]
            prev = match_wl[r]
            match_wl[r], match_rg[k] = k, r
            if r == i:
                break
            k = prev if prev > 0 else 0
    return np.float32(thr)


def _model(w, early_stop=True):
    out = [bottleneck_model(x, early_stop) for x in np.asarray(w, np.float32)]
    return np.array([o[0] for o in out], np.float32), sum(o[1] for o in out)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _eq_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _quantized(n, seed, t=24):
    return np.random.default_rng(seed).integers(0, 4, (t, n, n)).astype(np.float32)


def _residuals(name, seed=3, n_laser=6, n_ring=4):
    """The same trials' scaled residuals from the reference and the port."""
    key, order = name.split("-")
    jcfg = wdm_config(n_ch=int(key[3:])).with_orders(order)
    ju = japi.make_units(jcfg, seed, n_laser, n_ring)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    return np.asarray(jres(jinst(jcfg, ju))), tres(tinst(tcfg, tu)).numpy()


def _hold(w, interpret=True):
    """The model, with and without the early stop, bit for bit against the
    serial scan, the reference's threshold, its sweep and (optionally) the
    Pallas kernel."""
    got, steps = _model(w)
    fixed, fixed_steps = _model(w, early_stop=False)
    wj = jnp.asarray(w)
    _eq_bits(got, fixed)
    _eq_bits(got, [serial_scan(x) for x in w])
    _eq_bits(got, jmatch.bottleneck_matching_threshold(wj))
    _eq_bits(got, jmatch._bottleneck_threshold_sweep(wj))
    if interpret:
        _eq_bits(got, ops.bottleneck_threshold(wj, backend="interpret"))
    assert steps <= fixed_steps
    return got, steps, fixed_steps


@pytest.mark.parametrize("n", [5, 8, 12, 16])
def test_model_on_tie_heavy_integers(n):
    """Integer weights 0-3: most selections are ties, so the first-min order
    and the early stop's tie rule decide the walk."""
    _, steps, fixed_steps = _hold(_quantized(n, seed=n))
    assert steps < fixed_steps


@pytest.mark.parametrize("name", ["wdm8-natural", "wdm8-permuted", "wdm16-natural"])
def test_model_on_residual_systems(name):
    w_ref, w_port = _residuals(name)
    _eq_bits(w_port, w_ref)
    got, _, _ = _hold(w_ref)
    _eq_bits(got, bottleneck_threshold(torch.from_numpy(w_port)).numpy())


@pytest.mark.parametrize("n", [33, 64])
def test_model_two_lines_a_lane(n):
    """N > 32: one warp, two lines a lane; the ballot of slot 1 only where
    slot 0 holds no least key."""
    _hold(_quantized(n, seed=n, t=4), interpret=False)


@pytest.mark.parametrize("n", [5, 12])
def test_model_on_infinite_rows_and_columns(n):
    """Rows of +inf (every free line at +inf: the serial scan's line 0, a
    matched one), columns of +inf, and all-+inf trials."""
    w = _quantized(n, seed=100 + n)
    w[0::3, 1, :] = np.inf
    w[1::3, :, 2] = np.inf
    w[2::6, 0:2, :] = np.inf
    w[5] = np.inf
    got, _, _ = _hold(w)
    assert np.isinf(got).any() and np.isfinite(got).any()


@pytest.mark.parametrize("n", [6, 16])
def test_model_on_signed_zeros(n):
    """-0 and +0 compare equal: one key, the first line wins, and the value
    carried is the one the serial scan carries, sign included."""
    rng = np.random.default_rng(200 + n)
    w = rng.choice(np.array([-0.0, 0.0, 1.0, 2.0], np.float32), (24, n, n))
    got, _ = _model(w)
    _eq_bits(got, [serial_scan(x) for x in w])
    assert (_bits(got) == _bits(-0.0)).any()
    np.testing.assert_array_equal(got, jmatch._bottleneck_threshold_sweep(jnp.asarray(w)))


def test_order_key_is_float_order():
    vals = np.array([-np.inf, -3.5, -1e-38, -0.0, 0.0, 1e-45, 2.0, 3.4e38, np.inf],
                    np.float32)
    keys = order_key(vals)
    assert (np.diff(keys.astype(np.int64)) >= 0).all()
    assert keys[3] == keys[4] and keys[-1] == KEY_INF
    assert len(set(keys.tolist())) == len(vals) - 1


def _feasibility_inputs(n, seed, t=70):
    """Random systems with NaN and +-inf planted as in the card's smoke run."""
    rng = np.random.default_rng(seed)
    laser = rng.uniform(-5, 5, (t, n)).astype(np.float32)
    ring = rng.uniform(-5, 5, (t, n)).astype(np.float32)
    fsr = rng.uniform(4, 8, (t, n)).astype(np.float32)
    tr_unit = rng.uniform(0.9, 1.1, (t, n)).astype(np.float32)
    fsr[0::7, 2 % n] = 0.0
    laser[1::7, 3 % n] = np.nan
    fsr[2::7, 1 % n] = np.inf
    tr_unit[3::7, 0] = 0.0
    tr_unit[4::7, n - 1] = np.inf
    laser[5::7, 0] = -np.inf
    return laser, ring, fsr, tr_unit, rng.permutation(n)


@pytest.mark.parametrize("n", [5, 13, 40])
def test_feasibility_shift_reduction_model(n):
    """ltc as the kernel takes it: the least (NaN-first) key over the shifts,
    lanes of G with L slots, its first shift from a ballot."""
    laser, ring, fsr, tr_unit, s = _feasibility_inputs(n, seed=n)
    args = tuple(torch.from_numpy(a) for a in (laser, ring, fsr, tr_unit))
    req = per_shift_min_tr(*args, s).numpy()                     # (N, T)
    ltd, ltc = (x.numpy() for x in feasibility_plain(*args, s))
    g, n_slots = lane_shape(n)
    got = np.empty_like(ltc)
    for t in range(req.shape[1]):
        key = np.full(n_slots * g, NO_KEY, np.uint32)
        key[:n] = np.where(np.isnan(req[:, t]), np.uint32(0), order_key(req[:, t]))
        _, c = group_first_min(key.reshape(n_slots, g))
        got[t] = req[c, t]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ltc))
    both = ~np.isnan(ltc)
    _eq_bits(got[both], ltc[both])
    _eq_bits(req[0], ltd)
    assert np.isnan(ltc).any() and np.isinf(req).any()
