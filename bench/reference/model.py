"""Plain PyTorch reference of the wavelength-arbitration simulator.

The per-trial semantics of arXiv 2411.14810 (Choi & Stojanovic), written out
in plain tensor operations with no kernel, no chunking and no grid engine:
instantiate a point's systems from unit deviates (Eq. 3-4), build every
ring's search table (Sec. V-A), arbitrate with the LtC schemes (sequential
tuning, RS/SSM, VT-RS/SSM, Sec. V-B..D) or the protocol engine
(``protocol.py``), classify the outcome (Fig. 9) and score it against the
ideal LtC or LtA arbiter (Sec. III-A).  The formulations are the simulator's
published plain ones (dense candidate tables with a stable sort, per-shift
residual maxima, Kuhn's matching on bool lanes), frozen here so that a
change to the program is judged against them.

Every float tensor is of ``dtype`` (float32 as the deployment states; a
lower precision only for the control).  Runs on any device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

PHI = -(10 ** 6)   # relation not found


class Deployment(NamedTuple):
    """A configuration file's numbers (``bench/configs/<name>.json``)."""

    n_ch: int
    grid_spacing: float
    ring_bias: float
    fsr_mean: float
    sigma_go: float
    sigma_llv_frac: float
    sigma_rlv: float
    sigma_fsr_frac: float
    sigma_tr_frac: float
    max_alias: int
    max_entries: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Deployment":
        return cls(int(cfg["n_ch"]), float(cfg["grid_spacing_nm"]), float(cfg["ring_bias_nm"]),
                   float(cfg["fsr_mean_nm"]), float(cfg["sigma_go_nm"]),
                   float(cfg["sigma_llv_frac"]), float(cfg["sigma_rlv_nm"]),
                   float(cfg["sigma_fsr_frac"]), float(cfg["sigma_tr_frac"]),
                   int(cfg["max_fsr_alias"]), int(cfg["max_entries"]))


def order(kind: str, n: int) -> np.ndarray:
    """Spectral ordering r = s: natural (0, 1, ...) or the paper's permuted
    (0, N/2, 1, N/2 + 1, ...), Table II."""
    if kind == "natural":
        return np.arange(n, dtype=np.int64)
    if kind == "permuted":
        half = n // 2
        out = np.empty(n, dtype=np.int64)
        out[0::2] = np.arange(half)
        out[1::2] = np.arange(half) + half
        return out
    raise ValueError(f"unknown order {kind!r}")


class Systems(NamedTuple):
    laser: torch.Tensor    # (T, N) laser lines, relative to the grid centre [nm]
    ring: torch.Tensor     # (T, N) ring resonances
    fsr: torch.Tensor      # (T, N)
    tr_unit: torch.Tensor  # (T, N) tuning-range multiplier


def instantiate(dep: Deployment, units, r: np.ndarray, sigma_rlv, *, dtype,
                device) -> Systems:
    """One point's L * R systems (trial = l * R + r) from unit deviates, with
    sigma_rLV overridden (a float32 value) and every other half-range at the
    deployment's default (Eq. 3-4)."""
    u_go, u_llv, u_rlv, u_fsr, u_tr = (torch.as_tensor(u).to(device, dtype) for u in units)
    n = dep.n_ch
    spacing = float(np.float32(dep.grid_spacing))
    idx = torch.arange(n, dtype=dtype, device=device)
    laser_grid = (idx - (n - 1) / 2.0) * spacing
    ring_pos = torch.as_tensor(r, device=device).to(dtype)
    ring_grid = -float(np.float32(dep.ring_bias)) + (ring_pos - (n - 1) / 2.0) * spacing
    s_rlv = torch.tensor(float(np.float32(sigma_rlv)), dtype=dtype, device=device)
    laser = laser_grid + dep.sigma_go * u_go + (dep.sigma_llv_frac * dep.grid_spacing) * u_llv
    ring = ring_grid + s_rlv * u_rlv
    fsr = dep.fsr_mean * (1.0 + dep.sigma_fsr_frac * u_fsr)
    tr_unit = 1.0 + dep.sigma_tr_frac * u_tr
    n_l, n_r = u_llv.shape[0], u_rlv.shape[0]
    lasers = laser[:, None, :].expand(n_l, n_r, n).reshape(n_l * n_r, n)
    rings = lambda x: x[None].expand(n_l, n_r, n).reshape(n_l * n_r, n)  # noqa: E731
    return Systems(lasers.contiguous(), rings(ring).contiguous(), rings(fsr).contiguous(),
                   rings(tr_unit).contiguous())


def concat(systems: list) -> Systems:
    return Systems(*(torch.cat(parts) for parts in zip(*systems)))


def scaled_residual(sys: Systems) -> torch.Tensor:
    """(T, ring, line): the red-shift from ring i to line k modulo its FSR,
    over its TR multiplier (Eq. 5): line k is reachable at mean TR t iff
    this is <= t."""
    d = sys.laser[:, None, :] - sys.ring[:, :, None]
    return torch.remainder(d, sys.fsr[:, :, None]) / sys.tr_unit[:, :, None]


# --- ideal arbiters ---------------------------------------------------------

def ltc_min_tr(sys: Systems, s: np.ndarray) -> torch.Tensor:
    """(T,) least mean TR for Lock-to-Cyclic: the best cyclic shift of s."""
    res = scaled_residual(sys)
    n = res.shape[-1]
    rings = torch.arange(n, device=res.device)
    s = torch.as_tensor(s, device=res.device)
    return torch.stack([res[:, rings, (s + c) % n].amax(dim=-1) for c in range(n)]).amin(dim=0)


def first_true(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Along the last axis: (index of the first True, 0 if none; any)."""
    e = mask.shape[-1]
    iota = torch.arange(e, dtype=torch.int64, device=mask.device)
    first = torch.where(mask, iota, e).amin(dim=-1)
    found = first < e
    return torch.where(found, first, 0), found


def kuhn(reach: torch.Tensor) -> torch.Tensor:
    """(T, N, N) bool ring x line -> (T, N) line matched to each ring, -1 if
    none: Kuhn's augmenting paths, ring by ring, breadth first over lines."""
    t, n, _ = reach.shape
    dev = reach.device
    rows = torch.arange(t, device=dev)
    ring_iota = torch.arange(n, device=dev)[None, :, None]
    match_wl = torch.full((t, n), -1, dtype=torch.int64, device=dev)
    match_rg = torch.full((t, n), -1, dtype=torch.int64, device=dev)
    for i in range(n):
        matched = match_rg >= 0
        has_line = match_wl >= 0
        line_of = match_wl.clamp(min=0)
        start = reach[:, i, :]
        parent = torch.where(start, i, -1)
        frontier, visited = start, start
        free_wl = torch.full((t,), -1, dtype=torch.int64, device=dev)
        for _ in range(n):
            first, hit = first_true(frontier & ~matched)
            free_wl = torch.where(hit & (free_wl < 0), first, free_wl)
            in_front = has_line & torch.gather(frontier, 1, line_of)
            newly = reach & in_front[:, :, None] & ~visited[:, None, :]
            reached = newly.any(dim=1)
            par_new = torch.where(newly, ring_iota, n).amin(dim=1)
            cont = (free_wl < 0)[:, None]
            parent = torch.where(cont & reached, par_new, parent)
            frontier = reached & cont
            visited = visited | reached
            if not bool(frontier.any()):
                break
        k, active = free_wl, free_wl >= 0
        for _ in range(n):
            if not bool(active.any()):
                break
            k_safe = k.clamp(min=0)
            r = parent[rows, k_safe].clamp(min=0)
            prev = match_wl[rows, r]
            match_wl[rows, r] = torch.where(active, k_safe, prev)
            match_rg[rows, k_safe] = torch.where(active, r, match_rg[rows, k_safe])
            active = active & (r != i) & (prev >= 0)
            k = torch.where(active, prev, k)
    return match_wl


def perfect(reach: torch.Tensor) -> torch.Tensor:
    """(T,) bool: the ring x line graph holds a perfect matching."""
    return (kuhn(reach) >= 0).all(dim=1)


def lta_min_tr(sys: Systems) -> torch.Tensor:
    """(T,) least mean TR for Lock-to-Any: the bottleneck threshold, the
    least of a trial's weights w such that {weights <= w} holds a perfect
    matching.  No trial's threshold is below the largest row or column
    minimum, so that bound is tried first; the trials it does not settle
    run a binary search over their sorted weights."""
    w = scaled_residual(sys)
    t, n, _ = w.shape
    lower = torch.maximum(w.amin(dim=2).amax(dim=1), w.amin(dim=1).amax(dim=1))
    out = lower.clone()
    rest = torch.nonzero(~perfect(w <= lower[:, None, None])).reshape(-1)
    if rest.numel():
        wr = w[rest]
        cand = torch.sort(wr.reshape(-1, n * n), dim=1).values
        rows = torch.arange(rest.numel(), device=w.device)
        lo = torch.searchsorted(cand, lower[rest][:, None], right=True).reshape(-1)
        hi = torch.full_like(lo, n * n - 1)
        for _ in range(math.ceil(math.log2(n * n)) + 1):
            mid = (lo + hi) // 2
            ok = perfect(wr <= cand[rows, mid][:, None, None])
            lo = torch.where(ok, lo, mid + 1)
            hi = torch.where(ok, mid, hi)
        out[rest] = cand[rows, hi]
    return out


# --- search tables and the LtC schemes --------------------------------------

class Tables(NamedTuple):
    delta: torch.Tensor    # (T, N, E) ascending tuning distances, +inf padded
    wl: torch.Tensor       # (T, N, E) line of each peak, -1 padded
    n_valid: torch.Tensor  # (T, N)


def search_tables(dep: Deployment, sys: Systems, tr: torch.Tensor) -> Tables:
    """Every ring's first E peaks over delta in [0, TR_i], in (delta, line,
    alias) order; tr (T,) is each trial's mean TR."""
    t, n = sys.laser.shape
    n_j = 2 * dep.max_alias + 1
    e = min(dep.max_entries, n * n_j)
    tr_ring = tr[:, None] * sys.tr_unit
    j = torch.arange(-dep.max_alias, dep.max_alias + 1, device=tr.device).to(tr.dtype)
    d = (sys.laser[:, None, :, None] - sys.ring[:, :, None, None]) - j * sys.fsr[:, :, None, None]
    ok = (d >= 0.0) & (d <= tr_ring[:, :, None, None])
    flat = torch.where(ok, d, torch.inf).reshape(t, n, n * n_j)
    delta, idx = torch.sort(flat, dim=-1, stable=True)
    delta, idx = delta[..., :e], idx[..., :e]
    finite = torch.isfinite(delta)
    return Tables(delta, torch.where(finite, idx // n_j, -1), finite.sum(dim=-1))


class Chain(NamedTuple):
    aggressor: torch.Tensor
    victim: torch.Tensor
    forward: torch.Tensor
    chain: torch.Tensor     # chain position -> ring


def chain_of(s: np.ndarray, device) -> Chain:
    n = len(s)
    pi = np.argsort(s)
    second = pi[(np.arange(n) + 1) % n]
    agg, vic = np.minimum(pi, second), np.maximum(pi, second)
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return Chain(as_t(agg), as_t(vic), as_t(agg == pi), as_t(pi))


def _gather(tables: Tables, entry: torch.Tensor) -> torch.Tensor:
    """Line held by each ring's chosen entry, -1 where none."""
    t, n = entry.shape
    rows = torch.arange(t, device=entry.device)[:, None]
    rings = torch.arange(n, device=entry.device)[None, :]
    e_safe = entry.clamp(0, tables.wl.shape[-1] - 1)
    return torch.where(entry >= 0, tables.wl[rows, rings, e_safe], -1)


def sequential(tables: Tables, ch: Chain) -> torch.Tensor:
    """Lock-to-nearest in chain order; a lock hides its line from the rings
    physically downstream (Sec. V-D).  -> (T, N) line per ring."""
    t, n, _ = tables.wl.shape
    dev = tables.wl.device
    rows = torch.arange(t, device=dev)
    cap = torch.full((t, n), -1, dtype=torch.int64, device=dev)
    for ring in ch.chain.tolist():
        taken = torch.zeros((t, n + 1), dtype=torch.bool, device=dev)
        if ring > 0:
            up = cap[:, :ring]
            taken.scatter_(1, torch.where(up >= 0, up, n), True)
            taken[:, n] = False
        wl_row = tables.wl[:, ring, :]
        vis = (wl_row >= 0) & ~torch.gather(taken, 1, wl_row.clamp(0, n))
        first, found = first_true(vis)
        cap[:, ring] = torch.where(found, wl_row[rows, first], -1)
    return cap


def _unit_search(tables: Tables, ch: Chain, entry: torch.Tensor) -> torch.Tensor:
    rows = torch.arange(tables.wl.shape[0], device=entry.device)[:, None]
    e_ok = (entry >= 0) & (entry < tables.n_valid[:, ch.aggressor])
    line = tables.wl[rows, ch.aggressor, entry.clamp(0, tables.wl.shape[-1] - 1)]
    vic_wl = tables.wl[:, ch.victim, :]
    first, found = first_true((vic_wl == line[..., None]) & (vic_wl >= 0))
    masked = torch.where(found, first, -1)
    return torch.where(e_ok & (masked >= 0), masked - entry, PHI)


def relation_search(tables: Tables, ch: Chain, tolerant: bool) -> torch.Tensor:
    """(T, N) chain-oriented relation indices, PHI where none (Sec. V-B)."""
    n = ch.chain.shape[0]
    last = tables.n_valid[:, ch.aggressor] - 1
    a = _unit_search(tables, ch, last)
    b = _unit_search(tables, ch, torch.zeros_like(last))
    a_ok, b_ok = a != PHI, b != PHI
    ri = torch.where(a_ok & b_ok & ((a - b) % n == 0), a, PHI)
    ri = torch.where(a_ok & ~b_ok, a, ri)
    ri = torch.where(b_ok & ~a_ok, b, ri)
    if tolerant:
        ri = torch.where(ri == PHI, _unit_search(tables, ch, torch.clamp(last, max=1)), ri)
    return torch.where(ch.forward[None, :] | (ri == PHI), ri, -ri)


def single_step_matching(tables: Tables, ri: torch.Tensor, ch: Chain) -> torch.Tensor:
    """Closed-form lock allocation along sub-chains (Sec. V-C, Fig. 13)."""
    t, n = ri.shape
    dev = ri.device
    cut = ri == PHI
    any_cut = cut.any(dim=1)
    at_zero = (torch.arange(n, device=dev) == 0)[None, :]
    is_head = torch.where(any_cut[:, None], torch.roll(cut, 1, dims=1), at_zero)
    ri_safe = torch.where(cut, 0, ri)
    u = torch.zeros(t, dtype=torch.int64, device=dev)
    acc = torch.zeros(t, dtype=torch.int64, device=dev)
    e_diag = torch.zeros((t, n), dtype=torch.int64, device=dev)
    for step in range(2 * n):
        p = step % n
        head = is_head[:, p]
        u = torch.where(head, 0, u + 1)
        acc = torch.where(head, 0, acc + ri_safe[:, (p - 1) % n])
        e_diag[:, p] = u + acc
    nv = tables.n_valid[:, ch.chain]
    rho = torch.arange(n, device=dev)
    e_cand = (e_diag[:, None, :] + rho[None, :, None]) % n
    rho0, _ = first_true(torch.all(e_cand < nv[:, None, :], dim=-1))
    e_free = torch.take_along_dim(e_cand, rho0[:, None, None], dim=1)[:, 0, :]
    e_pos = torch.where(any_cut[:, None], e_diag % n, e_free)
    e_pos = torch.where(cut, nv - 1, e_pos)
    e_pos = torch.where((e_pos >= 0) & (e_pos < nv), e_pos, -1)
    entry = torch.full((t, n), -1, dtype=torch.int64, device=dev)
    entry[:, ch.chain] = e_pos
    return _gather(tables, entry)


class Outcome(NamedTuple):
    success: torch.Tensor
    lock_err: torch.Tensor   # zero or duplicate lock
    order_err: torch.Tensor


def classify(wl: torch.Tensor, s: np.ndarray, policy: str) -> Outcome:
    """Fig. 9: zero lock, duplicate lock, or a broken lane order."""
    t, n = wl.shape
    zero = (wl < 0).any(dim=1)
    counts = torch.zeros((t, n + 1), dtype=torch.int64, device=wl.device)
    counts.scatter_add_(1, torch.where(wl >= 0, wl, n), torch.ones_like(wl))
    dup = (counts[:, :n] > 1).any(dim=1)
    s = torch.as_tensor(s, device=wl.device)
    if policy == "ltc":
        shift = (wl - s[None, :]) % n
        order_ok = (shift == shift[:, :1]).all(dim=1)
    elif policy == "lta":
        order_ok = torch.ones(t, dtype=torch.bool, device=wl.device)
    else:
        raise ValueError(policy)
    bad_lock = zero | dup
    return Outcome(~bad_lock & order_ok, bad_lock, ~bad_lock & ~order_ok)


SCHEME_POLICY = {"seq": "ltc", "rs_ssm": "ltc", "vtrs_ssm": "ltc", "protocol_lta": "lta"}


class TrialOutcomes(NamedTuple):
    """Per-trial outcomes of a scheme, all (T,) bool."""

    alg_success: torch.Tensor
    ideal_ok: torch.Tensor
    lock_err: torch.Tensor
    order_err: torch.Tensor


def scheme_trials(dep: Deployment, sys: Systems, s: np.ndarray, scheme: str,
                  tr: torch.Tensor) -> TrialOutcomes:
    """Arbitrate every trial with ``scheme`` at its mean TR (tr (T,)) and
    score it against the scheme's ideal policy (CAFP's event, Eq. 6)."""
    from .protocol import protocol_lta

    policy = SCHEME_POLICY[scheme]
    if policy == "ltc":
        ideal = ltc_min_tr(sys, s) <= tr
    else:
        ideal = perfect(scaled_residual(sys) <= tr[:, None, None])
    tables = search_tables(dep, sys, tr)
    ch = chain_of(s, tr.device)
    if scheme == "seq":
        wl = sequential(tables, ch)
    elif scheme in ("rs_ssm", "vtrs_ssm"):
        wl = single_step_matching(tables, relation_search(tables, ch, scheme == "vtrs_ssm"), ch)
    else:
        wl = protocol_lta(tables)
    out = classify(wl, s, policy)
    return TrialOutcomes(out.success, ideal, out.lock_err & ideal, out.order_err & ideal)


def trial_mean(x: torch.Tensor) -> torch.Tensor:
    """(..., T) bool -> float32 count over T, divided in float32."""
    t = torch.tensor(float(x.shape[-1]), dtype=torch.float32, device=x.device)
    return x.sum(dim=-1).to(torch.float32) / t
