"""The port's ``probe`` kernel wrapper (masked re-search) against the JAX
reference, on the CPU: its plain version against the protocol engine's core
primitive ``masked_first_entry`` and against the Pallas kernel through
``ops.masked_research`` in interpret mode, on identical inputs.

Tolerance: exact (``first`` int32 and ``found`` bool), including the edge
cases the kernel must keep: a line id >= L counts as not taken, a floor >= E
finds nothing, a negative floor admits every entry, all-taken and
all-invalid rows, and a trial count that is not a multiple of the Pallas
trial block.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.protocol import masked_first_entry  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro_torch.kernels.probe import masked_research, masked_research_plain  # noqa: E402

#: (seed, C, E, L, T): the shapes of the reference's kernel parity test.
SHAPES = [
    (0, 1, 8, 8, 7),
    (1, 5, 24, 8, 130),
    (2, 16, 24, 16, 64),
    (3, 4, 12, 16, 128),
]


def _check(wl, taken, floor, interpret=True):
    first, found = masked_research(torch.from_numpy(wl), torch.from_numpy(taken),
                                   torch.from_numpy(floor))
    assert first.dtype == torch.int32 and found.dtype == torch.bool
    want_first, want_found = masked_first_entry(
        jnp.asarray(wl), jnp.asarray(taken), jnp.asarray(floor))
    np.testing.assert_array_equal(first.numpy(), np.asarray(want_first))
    np.testing.assert_array_equal(found.numpy(), np.asarray(want_found))
    if interpret:
        k_first, k_found = ops.masked_research(wl, taken, floor, backend="interpret")
        np.testing.assert_array_equal(first.numpy(), np.asarray(k_first))
        np.testing.assert_array_equal(found.numpy(), np.asarray(k_found))
    return first.numpy(), found.numpy()


@pytest.mark.parametrize("seed,c,e,n_lines,t", SHAPES)
def test_plain_matches_reference_and_pallas_interpret(seed, c, e, n_lines, t):
    rng = np.random.default_rng(seed)
    wl = rng.integers(-1, n_lines, (t, c, e)).astype(np.int32)
    taken = rng.random((t, n_lines)) < 0.4
    floor = rng.integers(0, e + 1, (t, c)).astype(np.int32)
    _check(wl, taken, floor)


def test_edge_cases():
    """Floors -1, 0, E, E+3; line ids >= L; all-taken and all-invalid rows."""
    rng = np.random.default_rng(7)
    t, c, e, n_lines = 40, 4, 12, 8
    wl = rng.integers(-1, n_lines + 3, (t, c, e)).astype(np.int32)   # ids up to L+2
    wl[:, 1, :] = -1                                                  # all invalid
    taken = rng.random((t, n_lines)) < 0.5
    taken[::5] = True                                                 # all taken
    floors = np.array([-1, 0, e, e + 3], np.int32)
    floor = np.tile(floors, (t, 1))
    first, found = _check(wl, taken, floor)
    assert not found[:, 1].any()                          # all-invalid row
    assert not found[:, 2:].any()                         # floor >= E
    # All-taken trials still see the ids >= L (never taken) and nothing else.
    big = wl[::5, 0, :] >= n_lines
    np.testing.assert_array_equal(found[::5, 0], big.any(axis=1))
    assert found[:, 0].any() and (first[:, 0] >= 0).sum() == found[:, 0].sum()


def test_negative_floor_admits_every_entry():
    wl = np.array([[[3, -1, 2, 1]]], np.int32)
    taken = np.array([[False, True, False, True]])
    for floor, want in ((-5, 2), (0, 2), (3, -1), (4, -1)):
        first, _ = _check(wl, taken, np.array([[floor]], np.int32), interpret=False)
        assert int(first[0, 0]) == want


def test_plain_is_the_cpu_path():
    """On CPU tensors the wrapper is the plain version and counts no launch."""
    rng = np.random.default_rng(1)
    wl = torch.from_numpy(rng.integers(-1, 8, (9, 2, 6)).astype(np.int32))
    taken = torch.from_numpy(rng.random((9, 8)) < 0.3)
    floor = torch.from_numpy(rng.integers(0, 6, (9, 2)).astype(np.int32))
    before = masked_research.launches
    got = masked_research(wl, taken, floor)
    want = masked_research_plain(wl, taken, floor)
    assert masked_research.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
