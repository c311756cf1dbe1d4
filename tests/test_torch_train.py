"""The training half of the PyTorch port (``repro_torch.optim``,
``repro_torch.distributed.steps``, ``repro_torch.data``, the backward pass
of ``repro_torch.models.model``) against the JAX reference on the CPU.

Bounds, each from the dtype of the arithmetic:

* AdamW: ``lr_at`` over steps 0-120 within 2 float32 ulps of the value
  and of ``cos`` (scaled by its factor; ``cos`` may round differently); three ``apply`` steps of a random tree
  against the reference's jitted ``apply``: float32 parameters and moments
  within 4e-6 of the leaf's max |value| (XLA may contract a product and a
  sum into one FMA), a bf16 leaf within one bf16 ulp of it.
* Compression: ``send`` and ``residual`` exactly, over 30 steps.
* ``TokenPipeline``: the reference's batches bit for bit.
* ``loss_fn`` gradients against the reference's ``value_and_grad``
  compiled with XLA's excess precision off (``test_torch_lm.py``): the
  loss within 2e-4, each gradient leaf within ``GRAD_TOL`` = 8 % of its max
  |g|: the backward runs in bf16 (each product's inputs rounded to 8 bits of
  mantissa), and the two packages round and sum in other orders; mamba2's
  SSD is the widest at 7.0 %.
* ``remat`` "none" / "full" / "dots" and ``scan_levels`` 1 / 2 against each
  other bit for bit: recomputation repeats the same CPU ops.
* ``make_train_step`` at ``n_microbatch`` 1 and 2 against the reference's:
  loss and aux within 2e-4, ``grad_norm`` within ``GRAD_NORM_TOL``, the
  step and ``lr`` exactly; the first moments within ``GRAD_TOL`` of their
  max and the second within twice it (scaled gradients and their squares) and the parameters within 2 lr + 1e-6 of the
  reference's (a first Adam step moves each entry by lr times the sign of
  its gradient, so a gradient of the other sign moves it the other way).
"""
import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.distributed import steps as jsteps  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    feedback_state_from_numpy,
    lm_params_from_numpy,
    opt_state_from_numpy,
)
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.distributed import steps as tsteps  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_lm import (  # noqa: E402
    _np,
    _reference_inputs,
    _t,
    reference_compiled,
    reference_params,
)

GRAD_TOL = 0.08
GRAD_NORM_TOL = 0.02
LOSS_TOL = 2e-4
#: Three archs in tier-1 (dense GQA, Mamba-2 SSD, qk_norm MoE: the three
#: backward paths); the other seven, whose layers those three cover, under
#: ``-m slow`` (the reference's compile of each value_and_grad is 3-17 s).
ARCHS = tuple(
    a if a in ("internlm2-1.8b", "mamba2-130m", "qwen3-moe-235b-a22b")
    else pytest.param(a, marks=pytest.mark.slow)
    for a in ("internlm2-1.8b", "mamba2-130m", "qwen3-moe-235b-a22b", "qwen3-14b",
              "llama4-scout-17b-a16e", "jamba-v0.1-52b", "internvl2-76b",
              "musicgen-large", "yi-34b", "nemotron-4-340b"))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _hold_leaf(got, want, what, tol=GRAD_TOL):
    """Max |diff| within ``tol`` x max |want|; returns max |diff| / max |want|."""
    g, w = got.detach().float().numpy(), _f32(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = float(np.abs(w).max()) or 1.0
    err = float(np.abs(g - w).max())
    assert err <= tol * scale, (what, err, scale)
    return err / scale


def _grad_leaves(params):
    """``params`` with grad-requiring leaf aliases, and the aliases."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    return tree_unflatten(params, leaves), leaves


# ------------------------------------------------------------------ AdamW

def test_lr_at_equals_reference():
    cfg = dict(lr_peak=3e-4, lr_min=3e-5, warmup_steps=10, decay_steps=100)
    want = np.asarray(jadam.lr_at(jadam.AdamWConfig(**cfg), jnp.arange(121)))
    got = tadam.lr_at(tadam.AdamWConfig(**cfg), torch.arange(121)).numpy()
    assert got.dtype == np.float32
    # cos(pi prog) within 2 ulps of 1 (2^-23), scaled by 0.5 (lr_peak - lr_min),
    # and 2 ulps of the value
    tol = 2.0 ** -23 * (cfg["lr_peak"] - cfg["lr_min"]) + 2 * np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= tol), got - want
    assert float(tadam.lr_at(tadam.AdamWConfig(**cfg), 5)) == float(want[5])


def _random_tree(rng, bf16_leaf=False):
    tree = {"w": rng.normal(size=(33, 17)).astype(np.float32),
            "blocks": [{"a": rng.normal(size=(4, 8, 16)).astype(np.float32),
                        "b": rng.normal(size=(5,)).astype(np.float32)}]}
    if bf16_leaf:
        tree["h"] = np.asarray(jnp.asarray(rng.normal(size=(7, 9)), jnp.bfloat16))
    return tree


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_apply_equals_reference(moment_dtype):
    """Three steps on a random tree (one bf16 leaf), gradients whose norm
    is clipped on the first step and not after."""
    rng = np.random.default_rng(5)
    cfg = dict(lr_peak=1e-2, warmup_steps=2, decay_steps=10, moment_dtype=moment_dtype)
    jcfg, tcfg = jadam.AdamWConfig(**cfg), tadam.AdamWConfig(**cfg)
    params = _random_tree(rng, bf16_leaf=True)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jadam.init(jcfg, jp)
    tp = lm_params_from_numpy(params, "cpu")
    tst = tadam.init(tcfg, tp)
    assert tst.step.dtype == torch.int32 and int(tst.step) == 0
    assert all(m.dtype == getattr(torch, moment_dtype) for m in tree_leaves(tst.mu))
    japply = jax.jit(lambda p, g, s: jadam.apply(jcfg, p, g, s))
    for step, gscale in enumerate((3.0, 0.05, 0.02)):
        grads = jax.tree.map(lambda a: (gscale * rng.normal(size=a.shape)).astype(a.dtype),
                             params)
        jp, jst, jstats = japply(jp, jax.tree.map(jnp.asarray, grads), jst)
        out_p, out_st, tstats = tadam.apply(tcfg, tp, lm_params_from_numpy(grads, "cpu"), tst)
        assert out_p is tp and out_st.mu is tst.mu       # updated in place
        assert int(tst.step) == int(jst.step) == step + 1
        np.testing.assert_allclose(float(tstats["grad_norm"]), float(jstats["grad_norm"]),
                                   rtol=1e-6)
        assert float(tstats["lr"]) == float(jstats["lr"])
        for tree_t, tree_j in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
            for g, w in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j)):
                assert str(g.dtype).split(".")[1] == str(w.dtype), (g.dtype, w.dtype)
                tol = 2.0 ** -8 if g.dtype == torch.bfloat16 else 4e-6
                scale = float(np.abs(_f32(w)).max())
                assert float(np.abs(g.float().numpy() - _f32(w)).max()) <= tol * scale


def test_adamw_decreases_quadratic():
    """The reference's ``tests/test_substrates.py::test_adamw_decreases_quadratic``."""
    cfg = tadam.AdamWConfig(lr_peak=0.1, warmup_steps=0, decay_steps=100, weight_decay=0.0)
    params = {"x": torch.tensor([3.0, -2.0])}
    state = tadam.init(cfg, params)
    for _ in range(60):
        grads = {"x": 2 * params["x"]}
        params, state, stats = tadam.apply(cfg, params, grads, state)
    assert float(params["x"].abs().max()) < 1.0
    assert np.isfinite(float(stats["grad_norm"]))


# ------------------------------------------------------------ compression

def test_compress_equals_reference_exactly():
    """30 steps of top-k with error feedback on a random leaf, a bf16 leaf
    and a tie-heavy integer leaf (ties at the threshold are all kept)."""
    rng = np.random.default_rng(2)
    grads = {"w": rng.normal(size=(64, 32)).astype(np.float32),
             "t": rng.integers(-3, 4, (40, 10)).astype(np.float32),
             "h": np.asarray(jnp.asarray(rng.normal(size=(9, 11)), jnp.bfloat16))}
    jstate = jcomp.init_feedback(jax.tree.map(jnp.asarray, grads))
    tstate = tcomp.init_feedback(lm_params_from_numpy(grads, "cpu"))
    carried = feedback_state_from_numpy(_np(jstate.residual), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(carried.residual),
                                                 tree_leaves(tstate.residual)))
    tg = lm_params_from_numpy(grads, "cpu")
    for _ in range(30):
        jsend, jstate, jstats = jcomp.compress(jax.tree.map(jnp.asarray, grads), jstate, 0.1)
        tsend, tstate, tstats = tcomp.compress(tg, tstate, 0.1)
        assert tstats == jstats
        for got, want in ((tsend, jsend), (tstate.residual, jstate.residual)):
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                w = np.asarray(w)
                assert g.shape == w.shape
                if g.dtype == torch.bfloat16:
                    np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
                else:
                    np.testing.assert_array_equal(g.numpy().view(np.int32), w.view(np.int32))
    assert int((tsend["t"] != 0).sum()) > int(0.1 * 400)     # ties kept


def test_gradient_compression_error_feedback():
    """The reference's ``tests/test_system.py::test_gradient_compression_error_feedback``."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32))}
    state = tcomp.init_feedback({"w": g["w"]})
    sent_total = np.zeros((64, 32), np.float32)
    for _ in range(30):
        send, state, stats = tcomp.compress(g, state, k_frac=0.1)
        sent_total += send["w"].numpy()
        assert stats["wire_fraction"] <= 0.21
    dense_total = g["w"].numpy() * 30
    rel = np.abs(sent_total - dense_total).mean() / np.abs(dense_total).mean()
    assert rel < 0.15, rel
    k = tcomp.compression_for_bandwidth(0.5)
    assert 0.0 < k <= 0.25
    assert tcomp.compression_for_bandwidth(1.0) == jcomp.compression_for_bandwidth(1.0)
    assert tcomp.compression_for_bandwidth(0.001) == jcomp.compression_for_bandwidth(0.001)


# --------------------------------------------------------------- pipeline

@pytest.mark.parametrize("cfg", [
    dict(vocab=128, seq_len=16, global_batch=4, seed=3),
    dict(vocab=64, seq_len=8, global_batch=4, seed=9, n_hosts=2, host_id=1),
    dict(vocab=50, seq_len=12, global_batch=2, seed=4, mean_doc_len=5, frontend_len=3,
         d_model=6),
], ids=["plain", "host-sharded", "extra-embeds"])
def test_pipeline_batches_bit_identical(cfg):
    jp, tp = jpipe.TokenPipeline(jpipe.DataConfig(**cfg)), tpipe.TokenPipeline(
        tpipe.DataConfig(**cfg))
    try:
        for want, got in zip((next(iter(jp)) for _ in range(3)),
                             (next(iter(tp)) for _ in range(3))):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        jp.close()
        tp.close()


# -------------------------------------------------------- loss gradients

def _reference_value_and_grad(arch, jcfg, jparams, batch):
    fn = lambda p, b: jax.value_and_grad(  # noqa: E731
        lambda q: jm.loss_fn(q, jcfg, b), has_aux=True)(p)
    return reference_compiled(fn, jparams, batch)(jparams, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_equal_reference(arch):
    jcfg, tcfg = jcfgs.get_smoke(arch), tcfgs.get_smoke(arch)
    jparams = reference_params(arch)
    batch = _reference_inputs(jcfg)[0]
    (jl, jaux), jg = _reference_value_and_grad(arch, jcfg, jparams, batch)
    tree, leaves = _grad_leaves(lm_params_from_numpy(_np(jparams), "cpu"))
    tl, taux = tm.loss_fn(tree, tcfg, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(tl, leaves)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    assert abs(float(taux["aux"]) - float(jaux["aux"])) <= LOSS_TOL
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    worst = max(_hold_leaf(g, w, f"{arch} gradient {i}")
                for i, (g, w) in enumerate(zip(grads, jleaves)))
    print(f"{arch}: loss {float(tl)!r} (reference {float(jl)!r}); worst gradient leaf "
          f"max |diff| / max |g| {worst!r}")


# -------------------------------------------------------------- remat

def _counting(monkeypatch):
    """Counts ``_mixer`` calls (forward and recompute)."""
    calls = []
    orig = tm._mixer

    def mixer(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tm, "_mixer", mixer)
    return calls


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m", "qwen3-moe-235b-a22b"])
def test_remat_variants_bit_identical(arch, monkeypatch):
    """Four super-blocks, so that ``scan_levels=2`` groups them 2 x 2."""
    base = tcfgs.get_smoke(arch)
    base = dataclasses.replace(base, n_layers=4 * len(base.pattern))
    params = tm.init_params(0, base, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, base.vocab, (2, 16), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    calls = _counting(monkeypatch)
    out = {}
    for remat in ("none", "full", "dots"):
        for levels in (1, 2):
            cfg = dataclasses.replace(base, remat=remat, scan_levels=levels)
            tree, leaves = _grad_leaves(params)
            calls.clear()
            # the mm count (slow: a Python call per op) on the dense arch
            mode = _CountMM() if arch == "internlm2-1.8b" and levels == 1 else None
            with mode or contextlib.nullcontext():
                loss, _ = tm.loss_fn(tree, cfg, batch)
                grads = torch.autograd.grad(loss, leaves)
            out[remat, levels] = (loss.detach(), grads, len(calls), mode and mode.mm)
    want_loss, want_grads, n, mm_none = out["none", 1]
    assert n == 4 * len(base.pattern)
    # what backward recomputes: a checkpointed block once; a checkpointed
    # group of two once, but only up to its last block's input (PyTorch's
    # recompute stops when it has what backward needs), then each block
    calls_want = {("none", 1): n, ("full", 1): 2 * n, ("dots", 1): 2 * n,
                  ("none", 2): 2 * n, ("full", 2): 2 * n + n // 2,
                  ("dots", 2): 2 * n + n // 2}
    for (remat, levels), (loss, grads, n_calls, mm) in out.items():
        assert torch.equal(loss, want_loss), (remat, levels)
        for g, w in zip(grads, want_grads):
            assert torch.equal(g, w), (remat, levels)
        assert n_calls == calls_want[remat, levels], (remat, levels, n_calls)
    # "dots" keeps the mm outputs: its recompute runs no mm, "full"'s does
    if mm_none is not None:
        assert out["dots", 1][3] == mm_none < out["full", 1][3]


def test_training_forward_equals_serving_prefill():
    """The training forward (every remat setting) and ``prefill`` give the
    same last-position logits bit for bit: moving the bf16 cast into the
    checkpointed super-block changed no value of the serving path."""
    cfg = tcfgs.get_smoke("internlm2-1.8b")
    cfg = dataclasses.replace(cfg, n_layers=4)
    params = tm.init_params(3, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(2))
    want, _ = tm.prefill(params, cfg, tokens, 24)
    for remat, levels in (("full", 1), ("dots", 1), ("none", 1), ("full", 2)):
        c = dataclasses.replace(cfg, remat=remat, scan_levels=levels)
        tree, _ = _grad_leaves(params)
        h = tm.embed_inputs(tree, c, tokens)
        hidden, _ = tm.backbone(tree, c, h, tm._positions(2, 16, "cpu"))
        got = (hidden[:, -1, :] @ tree["lm_head"].to(tm.COMPUTE)).float()
        assert torch.equal(got.detach(), want), (remat, levels)


# ------------------------------------------------------------ train step

@pytest.mark.parametrize("n_microbatch", [1, 2])
def test_train_step_equals_reference(n_microbatch):
    arch = "internlm2-1.8b"
    jcfg, tcfg = jcfgs.get_smoke(arch), tcfgs.get_smoke(arch)
    ocfg = dict(lr_peak=1e-3, warmup_steps=1, decay_steps=10)
    jparams = reference_params(arch)
    jopt = jadam.init(jadam.AdamWConfig(**ocfg), jparams)
    batch = _reference_inputs(jcfg)[0]
    step = jsteps.make_train_step(jcfg, jadam.AdamWConfig(**ocfg), n_microbatch)
    jp, jst, jmet = reference_compiled(step, jparams, jopt, batch)(jparams, jopt, batch)

    tparams = lm_params_from_numpy(_np(jparams), "cpu")
    topt = opt_state_from_numpy(*_np(tuple(jopt)), device="cpu")
    tstep = tsteps.make_train_step(tcfg, tadam.AdamWConfig(**ocfg), n_microbatch)
    tp, tst, tmet = tstep(tparams, topt, {k: _t(v) for k, v in batch.items()})
    assert tp is tparams and tst is topt
    assert sorted(tmet) == sorted(jmet)
    for k in ("loss", "ce", "aux"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= LOSS_TOL, k
    assert abs(float(tmet["grad_norm"]) / float(jmet["grad_norm"]) - 1) <= GRAD_NORM_TOL
    assert float(tmet["lr"]) == float(jmet["lr"])
    assert int(tst.step) == int(jst.step) == 1
    lr = float(jmet["lr"])
    for g, w, p0 in zip(tree_leaves(tp), jax.tree.leaves(jp), jax.tree.leaves(jparams)):
        assert float(np.abs(g.numpy() - _f32(w)).max()) <= 2 * lr + 1e-6
        assert not np.array_equal(_f32(w), _f32(p0)) or not g.any()    # it moved
    for tree_t, tree_j in ((tst.mu, jst.mu), (tst.nu, jst.nu)):
        for i, (g, w) in enumerate(zip(tree_leaves(tree_t), jax.tree.leaves(tree_j))):
            _hold_leaf(g, w, f"moment {i}", tol=2 * GRAD_TOL if tree_t is tst.nu else GRAD_TOL)
