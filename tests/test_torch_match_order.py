"""A lane-group model of the ``match`` CUDA kernel
(``src/repro_torch/kernels/csrc/match.cu``), in numpy, against the JAX
reference on identical inputs, on the CPU.

CUDA kernels run only on a card, so the kernel's search order is modelled
here and held against the reference before it reaches one.  The model keeps
the kernel's parts: a group of G lanes per trial (G = 8, 16, 32 for N <= 8,
16, 32, and 32 lanes with two rings and lines a lane, x and x + 32, up to
N = 64), idle lanes x >= N holding word 0 and line -1; the level-0 fast
path (ring i's word, shuffled from lane i, against the ``matched`` word);
the column masks (line x's rings, a transpose of N ballots) built at a
trial's first deeper level; deeper levels as a ballot R of the matched rings
whose line is in the frontier, each line lane taking the lowest ring of its
column mask in R as parent, and a ballot of those lanes as the level's
reached lines; the walk-back by shuffles; ``matched`` as a word that grows
by each augmentation's free line, never rebuilt.

Tolerance: exact.  ``match_wl`` on every trial, perfect or not, and the ok
flags, against the reference core's ``max_matching`` (single-word at
N <= 32, multiword above), the Pallas kernel in interpret mode (N < 32) and
the port's plain version ``perfect_matching_plain``.  The Pallas kernel is
left out at N = 32: it takes the index of the lowest free line as
``31 - clz(max(lsb, 1))`` on int32, so a lowest free line 31 (the sign bit)
reads as line 0, and two rings end on line 0 (the staircase at N = 32).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import matching as jmatch  # noqa: E402
from repro.core.grid import wdm_config  # noqa: E402
from repro.core.reach import reach_matrix as jreach  # noqa: E402
from repro.core.sampling import instantiate as jinst  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro_torch.convert import config_from_fields, units_from_numpy  # noqa: E402
from repro_torch.core.matching import adjacency_bitmask  # noqa: E402
from repro_torch.core.reach import reach_matrix as treach  # noqa: E402
from repro_torch.core.sampling import instantiate as tinst  # noqa: E402
from repro_torch.kernels.bitmask_match import perfect_matching_plain  # noqa: E402

U64 = (1 << 64) - 1


def lane_shape(n):
    """(G lanes a group, L rings and lines a lane) of the kernel's dispatch."""
    if n <= 32:
        return next(g for g in (8, 16, 32) if n <= g), 1
    return 32, 2


def lowest_bit(word):
    return (word & -word).bit_length() - 1


class Group:
    """One trial's lane group: lane gl, slot j holds ring and line
    x = gl + j * G."""

    def __init__(self, words):
        self.n = n = len(words)
        self.g, self.slots = lane_shape(n)
        self.x = np.arange(self.slots)[:, None] * self.g + np.arange(self.g)[None, :]
        lines = U64 >> (64 - n)
        self.adj = np.array([[words[x] & lines if x < n else 0 for x in row]
                             for row in self.x], dtype=object)
        self.col = np.zeros(self.x.shape, dtype=object)
        self.match_wl = np.full(self.x.shape, -1)
        self.parent = np.full(self.x.shape, -1)

    def fetch(self, a, x):
        """__shfl_sync of slot x // G from lane x % G."""
        return a[x // self.g, x % self.g]

    def ballot(self, pred):
        """One __ballot_sync over the group's lanes per slot, as a set."""
        out = 0
        for j in range(self.slots):
            out |= sum(1 << int(gl) for gl in np.flatnonzero(pred[j])) << (j * self.g)
        return out

    def lanes_in(self, word):
        """Each lane's test of its own bit x of a group-uniform word."""
        return np.array([[(word >> int(x)) & 1 == 1 for x in row] for row in self.x])

    def transpose(self):
        """col[k] = the rings whose word holds line k: one ballot per line,
        kept by lane k."""
        for k in range(self.n):
            has = np.array([[(w >> k) & 1 == 1 for w in row] for row in self.adj])
            self.col[self.x == k] = self.ballot(has)


def match_model(words, highest_ring_first=False):
    """The kernel's search on one trial's N words (Python ints, unsigned).

    Returns (match_wl (N,), ok, stats): per ring the BFS levels beyond level
    0 and the walk-back steps, the lines reached by more than one ring of a
    level's R (where the ring order decides the parent), and whether the
    column masks were built.  ``highest_ring_first`` gives a line the
    highest ring of its column mask in R, to show which inputs the ring
    order decides."""
    grp = Group(words)
    n = grp.n
    matched = 0
    stats = {"levels": [], "steps": [], "contested": 0, "transposed": False}
    for i in range(n):
        start = grp.fetch(grp.adj, i)
        hit = start & ~matched & U64
        if hit:                                     # level 0: a path of one edge
            free_wl = lowest_bit(hit)
            grp.match_wl[grp.x == i] = free_wl
            matched |= 1 << free_wl
            stats["levels"].append(0)
            stats["steps"].append(1)
            continue
        levels = steps = 0
        free_wl = -1
        if start:
            if not stats["transposed"]:
                grp.transpose()
                stats["transposed"] = True
            grp.parent[grp.lanes_in(start)] = i
            frontier = visited = start
            while True:
                levels += 1
                in_front = np.array([[w >= 0 and (frontier >> int(w)) & 1 == 1
                                      for w in row] for row in grp.match_wl])
                rings = grp.ballot(in_front)
                by = np.array([[c & rings for c in row] for row in grp.col], dtype=object)
                fresh = (by != 0) & ~grp.lanes_in(visited)
                for j, gl in zip(*np.nonzero(fresh)):
                    b = by[j, gl]
                    grp.parent[j, gl] = b.bit_length() - 1 if highest_ring_first \
                        else lowest_bit(b)
                    stats["contested"] += bin(b).count("1") > 1
                reached = grp.ballot(fresh)
                if not reached:
                    break
                visited |= reached
                hit = reached & ~matched & U64
                if hit:
                    free_wl = lowest_bit(hit)
                    break
                frontier = reached
        if free_wl >= 0:
            k = free_wl
            for _ in range(n):
                steps += 1
                r = grp.fetch(grp.parent, k)
                prev = grp.fetch(grp.match_wl, r)
                grp.match_wl[grp.x == r] = k
                if r == i or prev < 0:
                    break
                k = prev
            matched |= 1 << free_wl
        stats["levels"].append(levels)
        stats["steps"].append(steps)
    done = (grp.x >= n) | (grp.match_wl >= 0)
    ok = grp.ballot(done) == U64 >> (64 - grp.slots * grp.g)
    return grp.match_wl.reshape(-1)[:n].copy(), ok, stats


def model_batch(reach, **kw):
    """(T, N, N) bool -> model (match_wl (T, N), ok (T,), stats per trial)."""
    words = adjacency_bitmask(torch.from_numpy(np.ascontiguousarray(reach)))
    out = [match_model([int(w) & U64 for w in row], **kw) for row in words.tolist()]
    return (np.stack([o[0] for o in out]).astype(np.int32),
            np.array([o[1] for o in out]), [o[2] for o in out])


def hold(reach):
    """The model against the reference core, the Pallas kernel in interpret
    mode (N < 32) and the port's plain version; returns the model's
    (match_wl, ok, stats)."""
    mw, ok, stats = model_batch(reach)
    n = reach.shape[-1]
    j_adj = jmatch.adjacency_bitmask(jnp.asarray(reach))
    np.testing.assert_array_equal(mw, jmatch.max_matching(j_adj)[0])
    np.testing.assert_array_equal(ok, (mw >= 0).all(axis=1))
    if n < 32:
        mw_k, ok_k = ops.perfect_matching(j_adj, backend="interpret")
        np.testing.assert_array_equal(mw, mw_k)
        np.testing.assert_array_equal(ok, ok_k)
    mw_p, ok_p = perfect_matching_plain(adjacency_bitmask(torch.from_numpy(reach)))
    np.testing.assert_array_equal(mw, mw_p.numpy())
    np.testing.assert_array_equal(ok, ok_p.numpy())
    return mw, ok, stats


def sampled_reach(n, tr, seed=4, n_laser=5, n_ring=5):
    """The same trials' reach matrices from the reference and the port."""
    jcfg = wdm_config(n_ch=n)
    ju = japi.make_units(jcfg, seed, n_laser, n_ring)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    got = treach(tinst(tcfg, tu), tr).numpy()
    np.testing.assert_array_equal(got, np.asarray(jreach(jinst(jcfg, ju), tr)))
    return got


def staircase(n):
    """Ring i < N - 1 reaches lines i and i + 1, ring N - 1 line 0 only: each
    ring takes line i at level 0, and the last one finds line N - 1 free at
    the end of a BFS of N - 1 levels through every ring, and walks back N
    steps.  Perfect: ring i -> i + 1, ring N - 1 -> 0."""
    reach = np.zeros((n, n), bool)
    for i in range(n - 1):
        reach[i, i] = reach[i, i + 1] = True
    reach[n - 1, 0] = True
    return reach


def lowest_ring(n):
    """Blocks of three rings on three lines: ring 3b reaches 3b+1 and 3b+2,
    ring 3b+1 reaches 3b and 3b+2, ring 3b+2 reaches 3b and 3b+1.  Ring
    3b+2 finds both its lines taken; both rings of the ballot reach line
    3b+2, and ring 3b, which holds the higher line, must win it.  Rings past
    the last block reach every line."""
    reach = np.zeros((n, n), bool)
    for b in range(0, n - 2, 3):
        for r, lines in ((b, (b + 1, b + 2)), (b + 1, (b, b + 2)), (b + 2, (b, b + 1))):
            reach[r, list(lines)] = True
    reach[n - n % 3:, :] = True
    return reach


@pytest.mark.parametrize("tr", [2.0, 4.48, 8.96])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_model_on_sampled_systems(n, tr):
    """Reach matrices of sampled systems: all perfect at TR 8.96, some
    trials short of a perfect matching at 2.0, and at 4.48 (the temporal
    path's TR) searches of two levels or more with contested lines."""
    reach = sampled_reach(n, tr)
    _, ok, stats = hold(reach)
    if tr == 8.96:
        assert ok.all()
    if tr == 8.96 and n <= 8:      # every ring at level 0: no column masks
        assert not any(s["transposed"] for s in stats)
    if tr == 2.0:
        assert not ok.all()
    if tr == 4.48 and n >= 8:
        assert max(max(s["levels"]) for s in stats) >= 2
        assert sum(s["contested"] for s in stats) > 0


@pytest.mark.parametrize("n", [5, 12, 33, 64])
def test_model_on_random_bitmasks(n):
    """Densities from sparse to dense; at N = 33 and 64 lines 31 and 63 (when
    present) reached by every ring of some trials: the top bit of the low
    32-bit half and of the 64-bit word."""
    rng = np.random.default_rng(n)
    t = 12
    reach = rng.random((t, n, n)) < np.linspace(0.05, 0.6, t)[:, None, None]
    for bit in (31, 63):
        if bit < n:
            reach[::2, :, bit] = True
    mw, ok, stats = hold(reach)
    assert ok.any() and not ok.all()
    for bit in (31, 63):
        if bit < n:
            assert (mw == bit).any()


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_model_staircase_reaches_every_level(n):
    reach = np.stack([staircase(n), staircase(n)[:, ::-1].copy()])
    mw, ok, stats = hold(reach)
    assert ok.all()
    np.testing.assert_array_equal(mw[0], np.r_[np.arange(1, n), 0])
    assert stats[0]["levels"][-1] == n - 1 and stats[0]["steps"][-1] == n
    assert stats[0]["levels"][:-1] == [0] * (n - 1)


@pytest.mark.parametrize("n", [8, 16, 33])
def test_model_lowest_ring_wins(n):
    """Two rings of a level reach one line: the lower ring takes it.  The
    same inputs with each line given the highest ring of its column mask in
    R give another ``match_wl``, so these cases decide the order."""
    rng = np.random.default_rng(n)
    reach = np.stack([lowest_ring(n)] + [
        lowest_ring(n) | (rng.random((n, n)) < 0.04) for _ in range(5)])
    mw, ok, stats = hold(reach)
    assert all(s["contested"] > 0 for s in stats)
    assert ok.all()
    np.testing.assert_array_equal(mw[0, :3], [2, 0, 1])
    wrong, _, _ = model_batch(reach, highest_ring_first=True)
    assert (wrong != mw).any(axis=1).all()


def test_model_dead_ring_and_dead_line():
    """The hot-swap path's inputs: WDM16 at TR 4.48 with a dead lane (a zero
    column) and a dead ring (a zero row).  The dead ring stays unmatched,
    no ring takes the dead line, and the other rings are held as on any
    trial; the deep searches the lost line forces are counted."""
    n = 16
    reach = sampled_reach(n, 4.48, seed=6, n_laser=6, n_ring=6)
    reach[:, :, 5] = False
    reach[:, 9, :] = False
    mw, ok, stats = hold(reach)
    assert not ok.any()
    assert (mw[:, 9] == -1).all() and not (mw == 5).any()
    assert ((mw >= 0).sum(axis=1) >= n - 3).all()
    assert max(max(s["levels"]) for s in stats) >= 2
