"""Threefry-2x32 counter-based random numbers, bit for bit as JAX draws them.

The reference draws its Monte-Carlo unit samples with ``jax.random``; this
module reproduces those draws on the host with numpy ``uint32`` arithmetic
(which wraps modulo 2**32), so the port samples the same systems from the
same seed without JAX.  It covers what ``make_units`` needs: a key from an
integer seed, ``split``, 32-bit random bits and ``uniform`` in float32.

JAX has two layouts of the counters, chosen by its ``jax_threefry_partitionable``
switch, and both are here:

* ``partitionable=True`` (JAX's default since 0.5): element i of a draw
  hashes the 64-bit counter i as the pair (i >> 32, i & 0xFFFFFFFF) and
  keeps the xor of the two output words; ``split`` keeps both words as the
  new key.
* ``partitionable=False`` (the earlier layout): a draw of n words hashes the
  counters 0 .. n - 1 (padded to an even count), the first half as the
  first word of each pair and the second half as the second, and keeps the
  outputs in that order; ``split`` draws 2 * num words the same way.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry_2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block function, 20 rounds: key (2,) uint32 and the
    two counter words (same shape, uint32) -> the two output words."""
    k0, k1 = (np.uint32(k) for k in _u32(key))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [_u32(x0) + ks[0], _u32(x1) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _hash_counts(key, count: np.ndarray) -> np.ndarray:
    """JAX's ``threefry_2x32(key, count)``: the flat counters, padded with a
    zero to an even length, split into halves that form the pairs; the two
    output halves are concatenated and the pad dropped."""
    flat = _u32(count).reshape(-1)
    odd = flat.shape[0] % 2
    if odd:
        flat = np.concatenate([flat, np.zeros(1, np.uint32)])
    half = flat.shape[0] // 2
    y0, y1 = threefry_2x32(key, flat[:half], flat[half:])
    out = np.concatenate([y0, y1])
    return (out[:-1] if odd else out).reshape(np.shape(count))


def _counter_pairs(size: int) -> tuple[np.ndarray, np.ndarray]:
    """The 64-bit counters 0 .. size - 1 as (high, low) uint32 words."""
    i = np.arange(size, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def key_from_seed(seed: int) -> np.ndarray:
    """The raw key of ``jax.random.key(seed)`` under JAX's default 32-bit
    types: a zero high word and the seed's low 32 bits (so -1 and 2**32 - 1
    give one key, and 2**32 gives the key of 0)."""
    seed = int(seed)
    if not -(2 ** 63) <= seed < 2 ** 63:
        raise ValueError(f"seed must fit in a signed 64-bit integer, got {seed}")
    return np.array([0, seed % 2 ** 32], dtype=np.uint32)


def split(key, num: int = 2, *, partitionable: bool = True) -> np.ndarray:
    """``jax.random.split(key, num)`` -> (num, 2) uint32 keys."""
    if partitionable:
        hi, lo = _counter_pairs(num)
        y0, y1 = threefry_2x32(key, hi, lo)
        return np.stack([y0, y1], axis=-1)
    return _hash_counts(key, np.arange(2 * num, dtype=np.uint32)).reshape(num, 2)


def random_bits(key, shape, *, partitionable: bool = True) -> np.ndarray:
    """32-bit random words of ``shape``, as ``jax.random.bits`` draws them."""
    shape = tuple(int(d) for d in shape)
    size = int(np.prod(shape, dtype=np.int64))
    if partitionable:
        hi, lo = _counter_pairs(size)
        y0, y1 = threefry_2x32(key, hi, lo)
        return (y0 ^ y1).reshape(shape)
    if size >= 2 ** 32 - 1:
        raise ValueError("draws of 2**32 - 1 words or more are not supported")
    return _hash_counts(key, np.arange(size, dtype=np.uint32)).reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0, *,
            partitionable: bool = True) -> np.ndarray:
    """float32 uniform deviates in [minval, maxval), as ``jax.random.uniform``
    computes them: 23 random mantissa bits under the exponent of 1.0 give a
    float in [1, 2); minus 1, times (maxval - minval), plus minval, floored
    at minval, every step in float32."""
    bits = random_bits(key, shape, partitionable=partitionable)
    one = np.float32(1.0)
    floats = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32) - one
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)
