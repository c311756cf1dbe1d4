"""Threefry-2x32 unit draws in numpy: the benchmark's own inputs.

A frozen copy of the reference simulator's unit draw (``jax.random``'s
partitionable threefry counters, ``split`` and float32 ``uniform``), so that
the benchmark makes its Monte-Carlo units from ``--seed`` without the
program and without JAX.  The same seed gives the same units on every host.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_MASK32 = 0xFFFFFFFF


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry_2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """20 rounds of Threefry-2x32: key (2,) uint32, counter words -> output words."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key_from_seed(seed: int) -> np.ndarray:
    """A key from any integer below 2**64 in magnitude: its two 32-bit words,
    so that seeds past 2**32 give keys of their own."""
    seed = int(seed) % 2 ** 64
    return np.array([seed >> 32, seed & _MASK32], dtype=np.uint32)


def _counters(size: int) -> tuple[np.ndarray, np.ndarray]:
    i = np.arange(size, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(_MASK32)).astype(np.uint32)


def split(key, num: int) -> np.ndarray:
    """(num, 2) uint32 keys, as ``jax.random.split`` gives them."""
    y0, y1 = threefry_2x32(key, *_counters(num))
    return np.stack([y0, y1], axis=-1)


def uniform(key, shape, minval: float, maxval: float) -> np.ndarray:
    """float32 deviates in [minval, maxval), as ``jax.random.uniform`` makes them."""
    shape = tuple(int(d) for d in shape)
    y0, y1 = threefry_2x32(key, *_counters(int(np.prod(shape, dtype=np.int64))))
    bits = (y0 ^ y1).reshape(shape)
    one = np.float32(1.0)
    floats = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32) - one
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def unit_sets(seed: int, n_sets: int, n_ch: int, n_laser: int, n_ring: int) -> list:
    """``n_sets`` unit sets from ``seed``: each the five arrays (u_go (L, 1),
    u_llv (L, N), u_rlv (R, N), u_fsr (R, N), u_tr (R, N)) of uniforms in
    [-1, 1), drawn as the simulator's ``draw_unit_samples`` draws one set
    from a key."""
    out = []
    for set_key in split(key_from_seed(seed), n_sets):
        keys = split(set_key, 5)
        shapes = ((n_laser, 1), (n_laser, n_ch), (n_ring, n_ch), (n_ring, n_ch), (n_ring, n_ch))
        out.append(tuple(uniform(k, s, -1.0, 1.0) for k, s in zip(keys, shapes)))
    return out
