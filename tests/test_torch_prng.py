"""The port's threefry draws (``repro_torch.core.prng``) and ``make_units``
against ``jax.random`` and the reference's ``make_units``, on the CPU.

Both of JAX's counter layouts are held: its default
(``jax_threefry_partitionable=True``) and the earlier one, selected with the
``jax.threefry_partitionable(False)`` context manager.  Tolerance: exact;
keys and random words as uint32, uniform deviates bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import wdm as jwdm  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro_torch.convert import config_from_fields  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import prng  # noqa: E402

SEEDS = (0, 4, 17, 2 ** 32 - 1)
SHAPES = ((1, 1), (24, 8), (100, 32), (7,), (3, 5))
MODES = (True, False)


def _key(seed):
    return jax.random.key(seed)


@pytest.mark.parametrize("partitionable", MODES)
@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_match_jax(seed, partitionable):
    with jax.threefry_partitionable(partitionable):
        k = _key(seed)
        key = prng.key_from_seed(seed)
        np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(k)))
        for num in (2, 3, 5):
            want = np.asarray(jax.random.key_data(jax.random.split(k, num)))
            np.testing.assert_array_equal(prng.split(key, num, partitionable=partitionable),
                                          want)


@pytest.mark.parametrize("partitionable", MODES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_match_jax(seed, partitionable):
    """Odd and even sizes (the legacy layout pads an odd count)."""
    with jax.threefry_partitionable(partitionable):
        k = _key(seed)
        key = prng.key_from_seed(seed)
        for shape in SHAPES:
            want = np.asarray(jax.random.bits(k, shape, jnp.uint32))
            got = prng.random_bits(key, shape, partitionable=partitionable)
            assert got.dtype == np.uint32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=str(shape))
            want = np.asarray(jax.random.uniform(k, shape, jnp.float32, -1.0, 1.0))
            got = prng.uniform(key, shape, -1.0, 1.0, partitionable=partitionable)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                          err_msg=str(shape))


def test_threefry_block_known_answer():
    """The Threefry-2x32 (20 rounds) known-answer vector of the Random123
    suite, which JAX's own tests also hold."""
    y0, y1 = prng.threefry_2x32(np.array([0x13198A2E, 0x03707344], np.uint32),
                                np.array([0x243F6A88], np.uint32),
                                np.array([0x85A308D3], np.uint32))
    assert (int(y0[0]), int(y1[0])) == (0xC4923A9C, 0x483DF7A0)


def test_seed_wraps_like_jax():
    """JAX's default 32-bit types keep a seed's low 32 bits."""
    for seed in (-1, 2 ** 32, 2 ** 40 + 3):
        np.testing.assert_array_equal(prng.key_from_seed(seed),
                                      np.asarray(jax.random.key_data(_key(seed))))
    with pytest.raises(ValueError, match="64-bit"):
        prng.key_from_seed(2 ** 63)


@pytest.mark.parametrize("partitionable", MODES)
@pytest.mark.parametrize("cfg_name,seed,n_laser,n_ring", [
    ("WDM8_G200", 0, 24, 24), ("WDM8_G200", 17, 5, 7), ("WDM32_G200", 4, 10, 10)])
def test_make_units_equals_reference(cfg_name, seed, n_laser, n_ring, partitionable):
    jcfg = getattr(jwdm, cfg_name)
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    with jax.threefry_partitionable(partitionable):
        want = japi.make_units(jcfg, seed, n_laser, n_ring)
    got = tapi.make_units(tcfg, seed, n_laser, n_ring, device="cpu",
                          partitionable=partitionable)
    for field, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, field
        np.testing.assert_array_equal(g.numpy().view(np.int32), w.view(np.int32),
                                      err_msg=field)
