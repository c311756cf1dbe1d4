"""The port's checkpoint store (``repro_torch.checkpoint.store``) and
campaign checkpoints (``save_campaign`` / ``restore_campaign`` of
``repro_torch.core.temporal``) against the JAX reference, on the CPU.

* store: flattened keys equal the reference's; round trips keep the tree's
  structure, values and dtypes; ``keep=2`` retention; a stray
  ``_tmp_step_*`` directory is never a step; ``shardings=`` raises;
* across packages: a checkpoint the reference wrote restores in the port,
  and one the port wrote restores in the reference;
* campaigns: a timeline split at step 1, 2 or 3, checkpointed, restored and
  resumed equals the uninterrupted run (the reference's
  ``tests/test_temporal.py`` gate, on the port); a campaign the reference
  saved, resumed by the port, gives the reference's tail.

Tolerances: exact (float32 bit for bit, integers and booleans equal).
"""
import functools
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.core import ArbitrationConfig as JConfig  # noqa: E402
from repro.core import DWDMGrid as JGrid  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import protocol as jproto  # noqa: E402
from repro.core import temporal as jtemp  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.convert import timeline_from_numpy, units_from_numpy  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core import temporal as ttemp  # noqa: E402
from repro_torch.core.grid import ArbitrationConfig, DWDMGrid  # noqa: E402
from repro_torch.core.protocol import ProtocolState, cold_state  # noqa: E402

EVENTS = ((2, "lane_kill", 1), (3, "lane_swap", 1))


def _tree(gen):
    return {
        "w": torch.from_numpy(gen.standard_normal((4, 6)).astype(np.float32)),
        "blocks": [{"a": torch.ones((2, 3), dtype=torch.float64),
                    "idx": torch.arange(5, dtype=torch.int32),
                    "mask": torch.tensor([True, False, True])},
                   (torch.tensor(7, dtype=torch.int64), None)],
    }


def _state(gen, t=3, n=4):
    lock = gen.integers(-1, n, (t, n)).astype(np.int32)
    return ProtocolState(*(torch.from_numpy(a) for a in (
        lock, np.where(lock >= 0, lock + 1, -1).astype(np.int32),
        gen.integers(0, 9, (t, n)).astype(np.int32), gen.integers(0, 50, t).astype(np.int32))))


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got is want is None


def _jax(tree):
    return jax.tree.map(lambda x: jnp.asarray(x.numpy()), tree)


@pytest.mark.parametrize("kind", ["tree", "protocol-state"])
def test_flat_keys_match_reference(kind):
    gen = np.random.default_rng(0)
    tree = _tree(gen) if kind == "tree" else _state(gen)
    keys = list(store._flat(tree))
    assert keys == list(jstore._flat(_jax(tree)))
    if kind == "protocol-state":
        assert keys == [".lock", ".entry", ".cursor", ".probes"]
    else:
        assert keys == ["blocks/0/a", "blocks/0/idx", "blocks/0/mask", "blocks/1/0", "w"]


@pytest.mark.parametrize("kind", ["tree", "protocol-state"])
def test_roundtrip_keeps_structure_and_dtypes(kind):
    gen = np.random.default_rng(1)
    tree = _tree(gen) if kind == "tree" else _state(gen)
    with tempfile.TemporaryDirectory() as d:
        path = store.save(d, 7, tree)
        assert path == Path(d) / "step_00000007"
        assert sorted(p.name for p in path.iterdir()) == [
            "host_0.npz", "index_0.json", "meta.json"]
        target = jax.tree.map(torch.zeros_like, tree) if kind == "tree" else cold_state(3, 4, "cpu")
        _same(store.restore(d, 7, target), tree)


def test_keep_two_retains_the_newest_steps():
    tree = _tree(np.random.default_rng(2))
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            tree["w"] = tree["w"] + 1
            store.save(d, s, tree, keep=2)
        assert store.latest_step(d) == 5
        assert sorted(p.name for p in Path(d).iterdir()) == ["step_00000004", "step_00000005"]
        _same(store.restore(d, 5, tree), tree)
    assert store.latest_step(Path(d) / "missing") is None


def test_stray_tmp_step_is_never_a_step():
    tree = {"w": torch.arange(3, dtype=torch.float32)}
    with tempfile.TemporaryDirectory() as d:
        store.save(d, 2, tree, keep=1)
        (Path(d) / "_tmp_step_00000009").mkdir()  # a save cut before its commit
        assert store.latest_step(d) == 2
        _same(store.restore(d, 2, tree), tree)
        store.save(d, 3, tree, keep=1)
        assert sorted(p.name for p in Path(d).iterdir()) == [
            "_tmp_step_00000009", "step_00000003"]
        assert store.latest_step(d) == 3


def test_restore_with_shardings_raises():
    """``shardings`` places each leaf (None keeps the target leaf's device)
    and raises on a tree of another structure."""
    tree = {"w": torch.arange(2, dtype=torch.float32), "s": (torch.ones(3, dtype=torch.int32),)}
    on_meta = {"w": tree["w"].to("meta"), "s": (tree["s"][0].to("meta"),)}
    with tempfile.TemporaryDirectory() as d:
        store.save(d, 1, tree)
        # placements that differ from the target's device: each leaf moves
        got = store.restore(d, 1, on_meta, shardings={"w": "cpu", "s": (torch.device("cpu"),)})
        _same(got, tree)
        got = store.restore(d, 1, tree, shardings={"w": torch.device("meta"), "s": ("meta",)})
        assert got["w"].device.type == "meta" == got["s"][0].device.type
        # None keeps the target leaf's device, leaf by leaf
        got = store.restore(d, 1, on_meta, shardings={"w": "cpu", "s": (None,)})
        _same(got["w"], tree["w"])
        assert got["s"][0].device.type == "meta"
        assert (got["s"][0].shape, got["s"][0].dtype) == (tree["s"][0].shape, torch.int32)
        got = store.restore(d, 1, tree, shardings={"w": None, "s": ("meta",)})
        _same(got["w"], tree["w"])
        assert got["s"][0].device.type == "meta"
        for bad in ({"w": None}, {"w": None, "s": None}, {"w": None, "s": (None, None)},
                    {"w": None, "s": [None]}):
            with pytest.raises(ValueError, match="shardings do not match"):
                store.restore(d, 1, tree, shardings=bad)


@pytest.mark.parametrize("kind", ["tree", "protocol-state"])
def test_reference_checkpoint_restores_in_port(kind):
    gen = np.random.default_rng(3)
    # the reference keeps 32-bit types (no x64), so the tree does too
    tree = ({"w": torch.from_numpy(gen.standard_normal((4, 6)).astype(np.float32)),
             "blocks": [{"idx": torch.arange(5, dtype=torch.int32),
                         "mask": torch.tensor([True, False, True])}],
             "s": torch.tensor(2.5)}
            if kind == "tree" else _state(gen))
    with tempfile.TemporaryDirectory() as d:
        jstore.save(d, 4, _jax(tree))
        _same(store.restore(d, 4, tree), tree)


@pytest.mark.parametrize("kind", ["tree", "protocol-state"])
def test_port_checkpoint_restores_in_reference(kind):
    gen = np.random.default_rng(4)
    tree = ({"w": torch.from_numpy(gen.standard_normal((4, 6)).astype(np.float32)),
             "blocks": [{"idx": torch.arange(5, dtype=torch.int32),
                         "mask": torch.tensor([True, False, True])}]}
            if kind == "tree" else _state(gen))
    with tempfile.TemporaryDirectory() as d:
        store.save(d, 4, tree)
        assert jstore.latest_step(d) == 4
        target = _jax(tree) if kind == "tree" else jproto.cold_state(3, 4)
        got = jstore.restore(d, 4, target)
    for (gp, g), (wp, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree_util.tree_flatten_with_path(_jax(tree))[0]):
        assert gp == wp and g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@functools.lru_cache(maxsize=None)
def _campaign(n_ch, seed=1):
    """A campaign and its uninterrupted run, once per width."""
    cfg = ArbitrationConfig(grid=DWDMGrid(n_ch=n_ch))
    units = api.make_units(cfg, seed, 3, 3, device="cpu")
    tl = ttemp.make_timeline(4, n_ch, thermal=0.3, events=EVENTS, device="cpu")
    var = {"tr_mean": 4.0 if n_ch == 8 else 4.48}
    return cfg, units, tl, var, ttemp.run_timeline(cfg, units, tl, var)


@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("n_ch", [8, 16], ids=["wdm8", "wdm16"])
def test_campaign_resume_equals_uninterrupted_run(n_ch, split):
    cfg, units, tl, var, (final, stats) = _campaign(n_ch)
    t = final.lock.shape[0]
    head_state, head = ttemp.run_timeline(cfg, units, ttemp.slice_timeline(tl, 0, split), var)
    with tempfile.TemporaryDirectory() as d:
        ttemp.save_campaign(d, split, head_state)
        step, resumed = ttemp.restore_campaign(d, t, n_ch, device="cpu")
    assert step == split
    _same(resumed, head_state)
    tail_state, tail = ttemp.run_timeline(cfg, units, ttemp.slice_timeline(tl, split), var,
                                          init_state=resumed)
    _same(tail_state, final)
    for a, h, tt in zip(stats, head, tail):
        assert torch.equal(a, torch.cat([h, tt]))


def test_restore_campaign_picks_the_step_and_needs_a_checkpoint():
    gen = np.random.default_rng(5)
    a, b = _state(gen), _state(gen)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError, match="no campaign checkpoint"):
            ttemp.restore_campaign(d, 3, 4, device="cpu")
        ttemp.save_campaign(d, 1, a)
        ttemp.save_campaign(d, 2, b)
        assert ttemp.restore_campaign(d, 3, 4, device="cpu")[0] == 2
        step, got = ttemp.restore_campaign(d, 3, 4, step=1, device="cpu")
    assert step == 1
    _same(got, a)


def test_reference_campaign_resumes_in_port():
    """The reference runs the head and saves it; the port restores it and
    runs the tail, which equals the reference's tail."""
    n_ch, split = 8, 2
    jcfg = JConfig(grid=JGrid(n_ch=n_ch))
    ju = japi.make_units(jcfg, 1, 3, 3)
    jtl = jtemp.make_timeline(4, n_ch, thermal=0.3, events=EVENTS)
    var = {"tr_mean": 4.0}
    head_state, _ = jtemp.run_timeline(jcfg, ju, jtemp.slice_timeline(jtl, 0, split), var)
    want_state, want = jtemp.run_timeline(jcfg, ju, jtemp.slice_timeline(jtl, split), var,
                                          init_state=head_state)
    cfg = ArbitrationConfig(grid=DWDMGrid(n_ch=n_ch))
    units = units_from_numpy(*(np.asarray(x) for x in ju), device="cpu")
    tl = timeline_from_numpy(*(np.asarray(x) for x in jtl), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        jtemp.save_campaign(d, split, head_state)
        step, resumed = ttemp.restore_campaign(d, 9, n_ch, device="cpu")
    assert step == split
    got_state, got = ttemp.run_timeline(cfg, units, ttemp.slice_timeline(tl, split), var,
                                        init_state=resumed)
    for part, g_t, w_t in (("state", got_state, want_state), ("stats", got, want)):
        for f, g, w in zip(g_t._fields, g_t, w_t):
            g, w = g.numpy(), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (part, f)
            np.testing.assert_array_equal(g, w, err_msg=f"{part}.{f}")
