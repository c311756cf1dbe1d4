"""Oblivious arbitration protocol engine: round-driven distributed wavelength
arbitration (beyond the paper; the §V-E future work it defers).

The paper's schemes are one-shot.  This engine simulates a *protocol*: many
rounds of probe / release / augment messages between per-ring controllers,
on top of which multi-hop augmenting Lock-to-Any (and an LtD-conditioned
variant) are ordinary registered schemes.

A controller only sees its own search table (entry indices, never
wavelength values) and masking events: a re-search against the live bus in
which lines held by other rings are missing.  Every such unit-search
transaction counts as a *probe*.

Round structure (a host loop; every phase is batched over trials):

  probe    in a fixed controller order, every starved ring re-searches the
           masked bus red-ward of its tuner ``cursor`` and locks the first
           visible peak;
  augment  every still-starved ring runs a displacement chain of up to
           ``depth`` hops: a free line, else a donor that relocks red-ward
           (chain closed), else the nearest donor surrenders its line and
           becomes the next hop's seeker;
  release  starved rings reset their cursor to entry 0.

Each re-search goes through ``kernels.probe.masked_research`` (the ``probe``
CUDA kernel for CUDA tensors, its plain version for CPU tensors).  The
reference's ``lax.while_loop`` is a host ``while`` loop whose condition is
read once per round (the one device-to-host sync of a round); its
``fori_loop``s are Python loops over the same static trip counts.

Two rules keep the port equal to the reference:

* every phase works on clones of its input state and updates them in place
  in the reference's statement order (a donor's write reads the value the
  seeker's write left), so the state a round started from stays intact for
  the round's ``changed`` / halt / refund decisions;
* ties follow the reference: the "constrained" order is a *stable* argsort
  of the peak counts, and every first-True choice is ``first_true`` (0 when
  none), never an argmax of a bool tensor.

``trace=cap`` threads the flight recorder (``repro_torch.obs.trace``)
through the rounds: each phase appends its events to a ``TraceBuffer`` in
place, in the reference's order, and the buffer is cloned once a round so
that halted trials can drop the round's events.  With ``trace=None`` no
recorder code runs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..kernels.probe import masked_research
from ..obs.phase import count, span
from ..obs.trace import (
    EV_DISPLACE,
    EV_HALT,
    EV_LOCK,
    EV_PROBE,
    EV_RELEASE,
    EV_SURRENDER,
    TraceBuffer,
    clone_trace,
    merge_traces,
    trace_append,
    trace_buffer,
)
from .relation import ChainSpec
from .sampling import resolve_device
from .search_table import SearchTables, first_true
from .ssm import Assignment

_ORDERS = ("constrained", "physical", "chain")

#: The signature of the engine's re-search primitive, ``masked_first_entry``:
#: (wl (T, C, E), taken (T, L), floor (T, C)) -> (first, found).
ResearchFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], tuple]


def masked_first_entry(wl: torch.Tensor, taken: torch.Tensor, floor: torch.Tensor):
    """Batched masked re-search: first visible entry at-or-after ``floor``.

    wl: (T, C, E) int32 line ids of C search tables per trial (-1 padding);
    taken: (T, L) bool captured-line mask; floor: (T, C) int32 minimum entry
    index.  Returns (first (T, C) int32 entry or -1, found (T, C) bool).

    The protocol's unit primitive: one call re-searches a whole batch of
    tables at once.  It is ``kernels.probe.masked_research``: the ``probe``
    kernel for CUDA tensors, its plain version for CPU tensors.
    """
    return masked_research(wl, taken, floor)


class ProtocolState(NamedTuple):
    """Per-trial controller state between protocol phases."""

    lock: torch.Tensor    # (T, N) int32 held laser-line id, -1 if starved
    entry: torch.Tensor   # (T, N) int32 table entry of the held line, -1 if starved
    cursor: torch.Tensor  # (T, N) int32 red-ward tuner floor (monotone within a round)
    probes: torch.Tensor  # (T,) int32 cumulative unit-search transaction count


class ProtocolStats(NamedTuple):
    """Cost/outcome accounting of one ``run_protocol`` call."""

    probes: torch.Tensor  # (T,) unit-search transactions spent
    rounds: torch.Tensor  # (T,) rounds until complete (round bound if never)
    locked: torch.Tensor  # (T,) rings holding a line at exit
    worked: torch.Tensor  # (T,) rounds actually executed (complete, halt or bound)


def cold_state(n_trials: int, n_ch: int, device=None) -> ProtocolState:
    """The protocol's initial state: every ring starved, sweep at entry 0
    (on CUDA unless ``device`` names another)."""
    kw = dict(dtype=torch.int32, device=resolve_device(device))
    return ProtocolState(
        lock=torch.full((n_trials, n_ch), -1, **kw),
        entry=torch.full((n_trials, n_ch), -1, **kw),
        cursor=torch.zeros((n_trials, n_ch), **kw),
        probes=torch.zeros((n_trials,), **kw),
    )


def revalidate_state(tables: SearchTables, state: ProtocolState, *, tr=None,
                     hysteresis=0.0) -> tuple[ProtocolState, torch.Tensor]:
    """Match a carried lock state against freshly rebuilt search tables.

    A held line that no longer appears in its ring's table is *broken*; a
    surviving lock is re-anchored to the line's first entry in the new table,
    with the cursor following.  With ``tr`` ((T, N) actual tuning ranges),
    locks whose tuning distance lies within ``hysteresis`` of either window
    edge break early.  Broken rings reset to the cold per-ring state.

    Returns ``(state, kept)``; ``kept`` (T, N) bool marks surviving locks.
    Probes are carried through untouched.
    """
    e = tables.wl.shape[-1]
    held = state.lock >= 0
    hit = (tables.wl == state.lock[:, :, None]) & held[:, :, None]
    new_entry, found = first_true(hit)
    kept = found
    if tr is not None:
        delta = torch.gather(tables.delta, 2, new_entry.clamp(0, e - 1).long()[..., None])[..., 0]
        kept = kept & (delta >= hysteresis) & (delta <= tr - hysteresis)
    return state._replace(
        lock=torch.where(kept, state.lock, -1),
        entry=torch.where(kept, new_entry, -1),
        cursor=torch.where(kept, new_entry, 0),
    ), kept


def _line_counts(lock: torch.Tensor, n_lines: int, value: torch.Tensor) -> torch.Tensor:
    """(T, L) sum of ``value`` (T, N) over the rings holding each line (locks
    clipped to [0, L - 1]; starved rings add to a dropped pad column)."""
    t = lock.shape[0]
    idx = torch.where(lock >= 0, lock.clamp(0, n_lines - 1), n_lines).long()
    out = torch.zeros((t, n_lines + 1), dtype=value.dtype, device=lock.device)
    return out.scatter_add_(1, idx, value)[:, :n_lines]


def _taken_lines(lock: torch.Tensor, n_lines: int) -> torch.Tensor:
    """(T, N) locks -> (T, L) bool: line captured by some ring."""
    return _line_counts(lock, n_lines, torch.ones_like(lock)) > 0


def _line_holder(lock: torch.Tensor, n_lines: int) -> torch.Tensor:
    """(T, N) locks -> (T, L) int32: ring holding each line, -1 if free.

    The reference's one-hot sum of (ring + 1), exact under the engine's
    dup-lock freedom (each line has at most one holder)."""
    ring1 = torch.arange(1, lock.shape[1] + 1, dtype=lock.dtype,
                         device=lock.device).expand_as(lock)
    return _line_counts(lock, n_lines, ring1) - 1


def _controller_order(tables: SearchTables, spec: ChainSpec, order: str) -> torch.Tensor:
    """(T, N) int64 rank -> ring: who re-searches first in the probe phase.

    "constrained": fewest-peaks-first (stable on ties); "physical": bus
    order; "chain": the target-ordering chain.
    """
    t, n, _ = tables.wl.shape
    dev = tables.wl.device
    if order == "constrained":
        return torch.argsort(tables.n_valid, dim=1, stable=True)
    if order == "physical":
        return torch.arange(n, device=dev).expand(t, n)
    if order == "chain":
        chain = torch.as_tensor(spec.chain, dtype=torch.int64, device=dev)
        return chain.expand(t, n)
    raise ValueError(f"unknown controller order {order!r}; valid: {_ORDERS}")


def _clone(state: ProtocolState) -> ProtocolState:
    return ProtocolState(*(x.clone() for x in state))


def _probe_phase(tables: SearchTables, order: torch.Tensor, state: ProtocolState,
                 trace: TraceBuffer | None = None, rnd: int = 0) -> ProtocolState:
    """One lock sweep: starved rings relock red-ward of their cursor.  With
    ``trace``, each rank appends its ``probe`` and ``lock`` events to it."""
    t, n, e = tables.wl.shape
    rows = torch.arange(t, device=tables.wl.device)
    lock, entry, cursor, probes = _clone(state)
    for rank in range(n):
        ring = order[:, rank]
        lock_r = lock[rows, ring]
        # A starved ring with an empty table has nothing to re-search and
        # spends no probes (per-trial accounting stays batch-independent).
        searching = (lock_r < 0) & (tables.n_valid[rows, ring] > 0)
        taken = _taken_lines(lock, n)
        wl_row = tables.wl[rows, ring]                           # (T, E)
        cur = cursor[rows, ring]
        first, found = masked_research(wl_row[:, None, :], taken, cur[:, None].contiguous())
        first, found = first[:, 0], found[:, 0]
        do = searching & found
        l_new = wl_row[rows, first.clamp(0, e - 1).long()]
        lock[rows, ring] = torch.where(do, l_new, lock_r)
        entry[rows, ring] = torch.where(do, first, entry[rows, ring])
        cursor[rows, ring] = torch.where(do, first, cur)
        probes += searching.to(torch.int32)
        if trace is not None:
            trace_append(trace, searching, rnd, ring, EV_PROBE, cur)
            trace_append(trace, do, rnd, ring, EV_LOCK, first)
    return ProtocolState(lock, entry, cursor, probes)


def _augment_phase(tables: SearchTables, state: ProtocolState, depth: int,
                   n_seekers: int, k_donors: int, trace: TraceBuffer | None = None,
                   rnd: int = 0) -> ProtocolState:
    """Displacement chains for starved rings, up to ``depth`` hops each.

    Hop resolution (first match wins, all red-ward of the seeker's cursor):
    a free visible line; among the first ``k_donors`` donor candidates, one
    that can relock red-ward (two coordinated moves, chain closed);
    otherwise the nearest donor surrenders its line and seeks next, its
    cursor advanced past the surrendered entry.  ``n_seekers`` chains run per
    phase, each from the lowest-indexed not-yet-tried starved ring.  With
    ``trace``, each hop appends its ``probe``, ``lock``, ``displace`` and
    ``surrender`` events after its state writes.
    """
    t, n, e = tables.wl.shape
    dev = tables.wl.device
    k_don = max(1, min(k_donors, e))
    rows = torch.arange(t, device=dev)
    rows_k = rows[:, None]
    eiota = torch.arange(e, dtype=torch.int32, device=dev)
    lock, entry, cursor, probes = _clone(state)

    def chain_step(s, active):
        taken = _taken_lines(lock, n)
        holder = _line_holder(lock, n)
        wl_s = tables.wl[rows, s]                                 # (T, E)
        floor_s = cursor[rows, s]

        # 1) a free line red-ward of the seeker's cursor.
        f_free, free_ok = masked_research(wl_s[:, None, :], taken,
                                          floor_s[:, None].contiguous())
        f_free, free_ok = f_free[:, 0], free_ok[:, 0]

        # 2) donor candidates: entries whose line another ring holds; the
        #    first k_donors are interrogated in one batched re-search.
        cand = (wl_s >= 0) & (eiota[None, :] >= floor_s[:, None])
        x_e = torch.where(cand, torch.gather(holder, 1, wl_s.clamp(0, n - 1).long()), -1)
        cand = cand & (x_e >= 0) & (x_e != s[:, None])
        e_k = torch.sort(torch.where(cand, eiota[None, :], e), dim=1).values[:, :k_don]
        valid_k = e_k < e                                         # (T, K)
        e_k_safe = e_k.clamp(0, e - 1)
        x_k = torch.gather(x_e, 1, e_k_safe.long()).clamp(0, n - 1).long()   # (T, K)
        wl_x = tables.wl[rows_k, x_k]                             # (T, K, E)
        floor_x = torch.gather(entry, 1, x_k) + 1                 # strictly red-ward
        alt, has_alt = masked_research(wl_x, taken, floor_x)      # (T, K)
        swap_ok = valid_k & has_alt
        any_swap = swap_ok.any(dim=1)

        do_free = active & free_ok
        do_swap = active & ~free_ok & any_swap
        do_yield = active & ~free_ok & ~any_swap & cand.any(dim=1)
        take = do_free | do_swap | do_yield

        k_swap = first_true(swap_ok)[0]
        k_sel = torch.where(do_swap, k_swap, 0).long()[:, None]
        e_don = torch.gather(e_k_safe, 1, k_sel)[:, 0]
        e_s = torch.where(do_free, f_free, e_don)
        l_s = wl_s[rows, e_s.clamp(0, e - 1).long()]

        # donor of the selected entry (swap or yield case)
        x_sel = torch.gather(x_k, 1, k_sel)[:, 0]
        a_sel = torch.gather(alt, 1, k_sel)[:, 0].clamp(0, e - 1)
        l_alt = tables.wl[rows, x_sel, a_sel.long()]
        x_entry = entry[rows, x_sel]                              # read before writes

        # The seeker locks its chosen line (atomic with the donor hand-off).
        lock[rows, s] = torch.where(take, l_s, lock[rows, s])
        entry[rows, s] = torch.where(take, e_s, entry[rows, s])
        cursor[rows, s] = torch.where(take, e_s, cursor[rows, s])
        # Then the donor, read after the seeker's write (x_sel may be the
        # seeker itself when neither a swap nor a yield happens): a swap
        # relocks it red-ward at its alternative entry; a yield surrenders
        # the line with the cursor advanced past the surrendered entry.
        lock[rows, x_sel] = torch.where(
            do_swap, l_alt, torch.where(do_yield, -1, lock[rows, x_sel]))
        entry[rows, x_sel] = torch.where(
            do_swap, a_sel, torch.where(do_yield, -1, entry[rows, x_sel]))
        cursor[rows, x_sel] = torch.where(
            do_swap, a_sel, torch.where(do_yield, x_entry + 1, cursor[rows, x_sel]))

        # Probe accounting: 1 re-search by the seeker, plus one
        # release/re-search/restore per donor interrogated (up to the
        # selected one; all k_donors when the chain is stuck).
        n_inter = valid_k.sum(dim=1, dtype=torch.int32)
        scanned = torch.where(do_free, 0, torch.where(do_swap, k_swap + 1, n_inter))
        probes.add_(torch.where(active, 1 + scanned, 0).to(torch.int32))
        if trace is not None:
            trace_append(trace, active, rnd, s, EV_PROBE, floor_s)
            trace_append(trace, take, rnd, s, EV_LOCK, e_s)
            trace_append(trace, do_swap, rnd, x_sel, EV_DISPLACE, a_sel)
            trace_append(trace, do_yield, rnd, x_sel, EV_SURRENDER, x_entry)
        return torch.where(do_yield, x_sel, s), do_yield

    tried = torch.zeros((t, n), dtype=torch.bool, device=dev)
    for _ in range(min(n_seekers, n)):
        # Empty-table rings never launch chains (and spend no probes).
        starved = (lock < 0) & ~tried & (tables.n_valid > 0)
        any_s = starved.any(dim=1)
        s = first_true(starved)[0].long()
        tried[rows, s] = tried[rows, s] | any_s
        active = any_s
        for _ in range(depth):
            s, active = chain_step(s, active)
    return ProtocolState(lock, entry, cursor, probes)


def _release_phase(state: ProtocolState, trace: TraceBuffer | None = None,
                   rnd: int = 0) -> ProtocolState:
    """Starved rings restart their tuner sweep (cursor back to entry 0).
    With ``trace``, every cursor that rewinds appends one ``release`` event
    (entry = the old cursor), ring by ring as the reference's loop does."""
    starved = state.lock < 0
    if trace is not None:
        reset = starved & (state.cursor != 0)
        for i in range(state.lock.shape[1]):
            trace_append(trace, reset[:, i], rnd, i, EV_RELEASE, state.cursor[:, i])
    return state._replace(cursor=torch.where(starved, 0, state.cursor))


def _finalize(tables: SearchTables, state: ProtocolState) -> Assignment:
    e = tables.max_entries
    e_safe = state.entry.clamp(0, e - 1).long()
    delta = torch.where(
        state.entry >= 0,
        torch.gather(tables.delta, 2, e_safe[..., None])[..., 0],
        torch.inf,
    )
    wl = torch.where(state.entry >= 0, state.lock, -1)
    return Assignment(entry=state.entry, wl=wl, delta=delta)


def default_rounds(n_ch: int) -> int:
    """Static round bound: 4N, enough for the starvation "hole" to traverse
    the bus a few times; converged trials leave the loop early."""
    return 4 * n_ch


def _n_locked(lock: torch.Tensor) -> torch.Tensor:
    return (lock >= 0).sum(dim=1, dtype=torch.int32)


def _commit(state: ProtocolState, state0: ProtocolState) -> tuple[ProtocolState, torch.Tensor]:
    """Make-before-break: keep a trial's new (lock, entry, cursor) only if it
    locked strictly more rings than it started with, else roll back."""
    commit = _n_locked(state.lock) > _n_locked(state0.lock)
    c = commit[:, None]
    return state._replace(
        lock=torch.where(c, state.lock, state0.lock),
        entry=torch.where(c, state.entry, state0.entry),
        cursor=torch.where(c, state.cursor, state0.cursor),
    ), commit


def run_protocol(
    tables: SearchTables,
    spec: ChainSpec,
    *,
    order: str = "constrained",
    depth: int | None = None,
    n_rounds: int | None = None,
    n_seekers: int = 4,
    k_donors: int = 4,
    with_stats: bool = False,
    init_state: ProtocolState | None = None,
    with_state: bool = False,
    transactional: bool = False,
    patience: int | None = None,
    trace: int | None = None,
):
    """Run the round-driven oblivious arbitration protocol on a table batch.

    depth:     max displacement-chain hops per augmenting attempt (None = N,
               full multi-hop; 0 disables augmenting).
    n_rounds:  round bound (None = ``default_rounds`` = 4N).
    n_seekers: displacement chains launched per augment phase.
    k_donors:  donor-lookahead width per hop.
    order:     probe-phase controller order (see ``_controller_order``).
    init_state: resume from a live ``ProtocolState`` (warm start; pass it
               through ``revalidate_state`` first); None = ``cold_state``.
    with_state: also return the final ``ProtocolState``.
    transactional: commit a trial's re-arbitration only if it locked more
               rings than ``init_state`` held, else roll back (lock, entry,
               cursor); probes stay spent.
    patience:  halt a trial after this many consecutive rounds without a
               locked-count increase (None: halt only on exact fixed points).
    trace:     flight-recorder ring capacity (events per trial).  None
               disables it; an int appends a ``repro_torch.obs.trace.
               TraceBuffer`` to the return tuple, recording every probe /
               lock / displace / surrender / release transaction and a
               trial-level ``halt`` event.  Halted trials record nothing
               further (the recorder follows restore-and-refund);
               transactional rollbacks keep their events (the transactions
               ran, only the commit was refused).  Tracing changes no
               outcome.

    Returns ``assign`` and, per the flags, ``(assign, stats)``,
    ``(assign, state)`` or ``(assign, stats, state)``, with the
    ``TraceBuffer`` appended last when ``trace`` is set.  A trial whose round
    changed nothing is sticky-halted; halted trials are frozen (later rounds
    restore their state and refund their probes), so a trial's accounting
    does not depend on the other trials of the batch.  ``stats.probes``
    starts from ``init_state.probes``; ``stats.rounds`` is 0 for a trial that
    resumed complete and the bound for one that never completed;
    ``stats.worked`` counts the rounds a trial really executed.
    """
    with span("protocol.run"):
        t, n, _ = tables.wl.shape
        dev = tables.wl.device
        dep = n if depth is None else int(depth)
        rounds = default_rounds(n) if n_rounds is None else int(n_rounds)
        order_idx = _controller_order(tables, spec, order)
        has_peaks = tables.n_valid > 0

        state0 = cold_state(t, n, dev) if init_state is None else init_state
        # Trials resumed complete never enter the loop: round 0.  Cold starts
        # leave -1.
        done0 = torch.where((state0.lock >= 0).all(dim=1), 0, -1).to(torch.int32)
        done_round = done0
        halted = torch.zeros((t,), dtype=torch.bool, device=dev)
        plateau = torch.zeros((t,), dtype=torch.int32, device=dev)
        halt_round = torch.full((t,), -1, dtype=torch.int32, device=dev)
        state = state0
        buf = None if trace is None else trace_buffer(t, int(trace), dev)
        rnd = 0
        while rnd < rounds:
            with span("protocol.round"):
                # A trial is live while a starved ring with a nonempty table could
                # still act and the trial is not halted.  One sync per round.
                live = ((state.lock < 0) & has_peaks).any(dim=1)
                pending = (live & ~halted).any()
                with span("protocol.sync"):
                    if not bool(pending):
                        break
                count("protocol.rounds")
                prev = state
                if buf is not None:
                    prev_buf = clone_trace(buf)
                with span("protocol.probe"):
                    state = _probe_phase(tables, order_idx, state, buf, rnd)
                if dep > 0:
                    with span("protocol.augment"):
                        state = _augment_phase(tables, state, dep, n_seekers, k_donors, buf, rnd)
                with span("protocol.release"):
                    state = _release_phase(state, buf, rnd)
                changed = ((state.lock != prev.lock).any(dim=1)
                           | (state.entry != prev.entry).any(dim=1)
                           | (state.cursor != prev.cursor).any(dim=1))
                h = halted[:, None]
                state = ProtocolState(
                    lock=torch.where(h, prev.lock, state.lock),
                    entry=torch.where(h, prev.entry, state.entry),
                    cursor=torch.where(h, prev.cursor, state.cursor),
                    probes=torch.where(halted, prev.probes, state.probes),
                )
                if buf is not None:
                    # A frozen trial's events of this round go with its state changes.
                    buf = merge_traces(halted, prev_buf, buf)
                was_halted = halted
                halted = halted | (live & ~changed)
                if patience is not None:
                    improved = _n_locked(state.lock) > _n_locked(prev.lock)
                    plateau = torch.where(improved | halted, 0, plateau + 1)
                    halted = halted | (live & (plateau >= int(patience)))
                halt_round = torch.where(halted & ~was_halted & (halt_round < 0),
                                         rnd + 1, halt_round)
                complete = (state.lock >= 0).all(dim=1)
                done_round = torch.where(complete & (done_round < 0), rnd + 1, done_round)
                if buf is not None:
                    trace_append(buf, halted & ~was_halted, rnd + 1, -1, EV_HALT, -1)
                rnd += 1
        if transactional:
            state, commit = _commit(state, state0)
            done_round = torch.where(commit, done_round, done0)
        assign = _finalize(tables, state)
        out = (assign,)
        if with_stats:
            out += (ProtocolStats(
                probes=state.probes,
                rounds=torch.where(done_round < 0, rounds, done_round).to(torch.int32),
                locked=_n_locked(state.lock),
                worked=torch.where(
                    done_round >= 0, done_round,
                    torch.where(halt_round >= 0, halt_round, rounds)).to(torch.int32),
            ),)
        if with_state:
            out += (state,)
        if buf is not None:
            out += (buf,)
        return out if len(out) > 1 else assign


def run_protocol_trace(
    tables: SearchTables,
    spec: ChainSpec,
    *,
    order: str = "constrained",
    depth: int | None = None,
    n_rounds: int | None = None,
    n_seekers: int = 4,
    k_donors: int = 4,
    init_state: ProtocolState | None = None,
    transactional: bool = False,
) -> tuple:
    """Instrumented run: per-phase state snapshots for invariant checks.

    Executes exactly ``n_rounds`` rounds (no early exit) and returns
    (assignment, snapshots); snapshots is a list of (round, phase_name,
    ProtocolState on the CPU), phases "probe", "augment", "release" in
    execution order, plus a final "commit" when ``transactional``.
    Test-only; never on a hot path.
    """
    t, n, _ = tables.wl.shape
    dep = n if depth is None else int(depth)
    rounds = default_rounds(n) if n_rounds is None else int(n_rounds)
    order_idx = _controller_order(tables, spec, order)
    state0 = cold_state(t, n, tables.wl.device) if init_state is None else init_state
    state = state0
    snaps = []

    def snap(rnd, phase):
        snaps.append((rnd, phase, ProtocolState(*(x.cpu() for x in state))))

    for rnd in range(rounds):
        state = _probe_phase(tables, order_idx, state)
        snap(rnd, "probe")
        if dep > 0:
            state = _augment_phase(tables, state, dep, n_seekers, k_donors)
        snap(rnd, "augment")
        state = _release_phase(state)
        snap(rnd, "release")
    if transactional:
        state, _ = _commit(state, state0)
        snap(rounds, "commit")
    return _finalize(tables, state), snaps
