"""The port's fresh-start LM parameters against the reference's, on the CPU.

* ``kernels.threefry``'s plain version against ``jax.random.bits``,
  ``uniform`` and ``normal`` on partitionable keys (JAX's default counter
  layout), over 1-D, 2-D, stacked 3-D and 4-D shapes whose sizes divide by
  nothing: raw words and uniforms bit for bit, normals within 2 ulp (the
  plain version computes XLA:CPU's ``erf_inv`` and ``log1p`` step by step,
  and equals JAX's eager draws here).  A block drawn by its counter range
  equals that slice of the whole draw, bit for bit.
* ``models.model.init_params(seed, cfg, device="cpu")`` for all ten smoke
  configs, in float32 and with ``param_dtype="bfloat16"``, against
  ``repro.models.model.init_params(jax.random.key(seed), cfg)`` eager and
  jitted (compiled once an arch in float32, its bf16 leaves cast from
  those draws as the reference's own ``astype`` casts them): float32
  leaves within 2 ulp (the jitted reference differs from its own eager run
  by up to 2 ulp where XLA folds ``sqrt(2) * scale``), bf16 leaves within
  one bf16 ulp, ones and zeros exact.
* The port's ``Trainer.init_state`` fresh start against the reference's at
  the same ``tcfg.seed``, to the same bounds, with zero moments.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch.mesh import make_host_mesh as jhost_mesh  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import threefry  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SHAPES = ((7,), (13, 37), (3, 17, 29), (2, 3, 5, 7))
F32_ULP = 2
RANGES = ((0.0, 1.0), (1.0, 16.0), (-3.0, 5.5))


def _ulps(got, want) -> int:
    """The largest distance in float32 ulps (bf16 ulps for bf16 arrays)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    width = {4: np.int32, 2: np.int16}[got.dtype.itemsize]
    sign = np.int64(1) << (8 * got.dtype.itemsize - 1)

    def ordered(a):
        i = a.view(width).astype(np.int64)
        return np.where(i < 0, -(i & (sign - 1)), i)

    return int(np.abs(ordered(got) - ordered(want)).max()) if got.size else 0


def _numpy(t):
    t = t.detach()
    return t.view(torch.int16).numpy().view(jnp.bfloat16) if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("seed", (0, 9, 2 ** 32 - 1))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_draws_match_jax(shape, seed):
    key, k = prng.key_from_seed(seed), jax.random.key(seed)
    got = threefry.threefry_plain(key, shape).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jax.random.bits(k, shape, jnp.uint32)))
    for lo, hi in RANGES:
        got = threefry.threefry_plain(key, shape, mode=threefry.UNIFORM, lo=lo, hi=hi).numpy()
        want = np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, hi))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), str((lo, hi)))
    for scale in (1.0, 20 ** -0.5):
        got = threefry.threefry_plain(key, shape, mode=threefry.NORMAL, lo=threefry.NORMAL_LO,
                                      hi=threefry.NORMAL_HI, scale=float(np.float32(scale)))
        got = got.numpy()
        want = np.asarray(jax.random.normal(k, shape, jnp.float32) * scale)
        assert np.isfinite(got).all() and _ulps(got, want) <= F32_ULP, scale


@pytest.mark.parametrize("shape", SHAPES)
def test_a_block_equals_that_slice_of_the_whole_draw(shape):
    """Ragged blocks, an empty one, and the whole tensor as one block."""
    key = prng.split(prng.key_from_seed(5), 3)[2]
    rng = np.random.default_rng(len(shape))
    for mode, kw in ((threefry.BITS, {}), (threefry.UNIFORM, dict(lo=1.0, hi=16.0)),
                     (threefry.NORMAL, dict(lo=threefry.NORMAL_LO, hi=1.0, scale=0.125))):
        whole = threefry.threefry_plain(key, shape, mode=mode, **kw)
        for _ in range(3):
            start = [int(rng.integers(0, d)) for d in shape]
            length = [int(rng.integers(1, d - s + 1)) for d, s in zip(shape, start)]
            got = threefry.threefry_plain(key, shape, start, length, mode=mode, **kw)
            want = whole[tuple(slice(s, s + n) for s, n in zip(start, length))]
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (start, length)
        empty = threefry.threefry_plain(key, shape, (0,) * len(shape),
                                        (0,) + tuple(shape[1:]), mode=mode, **kw)
        assert empty.shape == (0,) + tuple(shape[1:])
        out = torch.empty(shape, dtype=whole.dtype)
        assert threefry.threefry_draw(out, key, shape, mode=mode, **kw) is out
        assert torch.equal(out.view(torch.int32), whole.view(torch.int32))
    with pytest.raises(ValueError, match="outside"):
        threefry.threefry_plain(key, shape, (1,) * len(shape), shape)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        threefry.threefry_draw(torch.empty(shape, device="meta"), key, shape,
                               mode=threefry.UNIFORM)


def test_erf_inv_matches_xla_across_its_domain():
    """Both of its branches (w = -log1p(-x*x) below and above 5), XLA's
    log1p's rational branch (|x*x| < sqrt(2) - 1), +-1 and 0."""
    x = np.random.default_rng(0).uniform(-1, 1, 200_003).astype(np.float32)
    x = np.concatenate([x, np.float32([-1.0, 1.0, 0.0, threefry.NORMAL_LO, 0.99999994])])
    got = threefry.erf_inv_plain(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert _ulps(got, want) <= F32_ULP
    assert np.isposinf(got[-4]) and np.isneginf(got[-5]) and got[-3] == 0


def _hold_tree(got, want, where):
    """Leaves in the reference's flatten order: constants exact, float32
    within F32_ULP, bf16 within one bf16 ulp.  Returns the worst gap."""
    flat = jax.tree_util.tree_leaves_with_path(want)
    leaves = tree_leaves(got)
    assert len(leaves) == len(flat)
    worst = 0
    for (path, w), g in zip(flat, leaves):
        name = str(path[-1].key if hasattr(path[-1], "key") else path[-1])
        g, w = _numpy(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (where, name)
        gap = _ulps(g, w)
        if "norm" in name or name in ("D", "conv_b", "dt_bias"):
            assert gap == 0, (where, name)
        assert gap <= (1 if w.dtype == jnp.bfloat16 else F32_ULP), (where, name, gap)
        worst = max(worst, gap)
    return worst


@functools.lru_cache(maxsize=None)
def _jitted_reference(arch):
    """The reference's jitted float32 ``init_params`` at key 11, compiled
    once an arch: its bf16 leaves are the ``astype`` casts of the same
    float32 draws."""
    return jax.jit(lambda key: jm.init_params(key, jsmoke(arch)))(jax.random.key(11))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_equal_reference(arch, dtype):
    cfg = dataclasses.replace(get_smoke(arch), param_dtype=dtype)
    jcfg = dataclasses.replace(jsmoke(arch), param_dtype=dtype)
    got = M.init_params(11, cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(got))
    eager = jm.init_params(jax.random.key(11), jcfg)
    _hold_tree(got, eager, "eager")
    jitted = jax.tree_util.tree_map(lambda j, e: j.astype(e.dtype), _jitted_reference(arch),
                                    eager)
    _hold_tree(got, jitted, "jitted")


def test_init_params_takes_a_seed_or_a_raw_key():
    """A raw key gives its seed's draws, a numpy int seed the int's, another
    seed others; a ``torch.Generator`` is refused."""
    cfg = get_smoke("internlm2-1.8b")
    got = M.init_params(11, cfg, device="cpu")
    again = M.init_params(prng.key_from_seed(11), cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(again)))
    again = M.init_params(np.int64(11), cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(again)))
    other = M.init_params(12, cfg, device="cpu")
    assert not torch.equal(other["embed"], got["embed"])
    with pytest.raises(TypeError, match="Generator"):
        M.init_params(torch.Generator().manual_seed(11), cfg, device="cpu")
    with pytest.raises(ValueError, match="uint32 key"):
        M.init_params(np.zeros(3, np.uint32), cfg, device="cpu")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m"])
def test_trainer_fresh_start_equals_reference(arch, tmp_path):
    opt = dict(warmup_steps=2, decay_steps=50)
    cfg = get_smoke(arch)
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "port"), seed=7),
                 adamw.AdamWConfig(**opt), "cpu", None)
    state = tr.init_state()
    jcfg, mesh = jsmoke(arch), jhost_mesh()
    psh = jsharding.param_shardings(jcfg, mesh)
    jtr = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(ckpt_dir=str(tmp_path / "ref"), seed=7),
                           jadam.AdamWConfig(**opt), mesh, None, psh,
                           jsharding.opt_shardings(psh, jsharding.replicated(mesh)))
    want = jtr.init_state()
    assert state.step == want.step == 0
    _hold_tree(state.params, want.params, "Trainer")
    moments = tree_leaves(state.opt_state.mu) + tree_leaves(state.opt_state.nu)
    assert len(moments) == 2 * len(tree_leaves(state.params))
    assert all(not t.any() for t in moments) and int(state.opt_state.step) == 0
