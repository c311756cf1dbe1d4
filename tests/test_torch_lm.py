"""The LM serving path of the PyTorch port (``repro_torch.models``)
against the JAX reference on the CPU, at the ten smoke configs (the
configs, registry and parameter rules are held in
``test_torch_lm_layers.py``, beside the layers).

* With the reference's parameters carried across, ``loss_fn``, ``prefill``
  (logits and caches) and three ``decode_step`` logits at each smoke config
  agree with the reference in bf16 within 2e-2, the bound of the
  reference's own ``tests/test_arch_smoke.py:105``.  The decode steps are
  fed the reference's greedy tokens on both sides.
* Decode after prefill equals a longer prefill on the port alone, as the
  reference's ``test_prefill_decode_consistency`` checks it.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.convert import decode_state_from_numpy, lm_params_from_numpy  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

TOL = 2e-2
#: Seven archs run in tier-1; the other three, whose families those seven
#: cover (a llama-arch dense GQA model; squared-ReLU; qk_norm MoE), run under
#: ``-m slow`` as the reference's own ``tests/test_arch_smoke.py:16`` keeps
#: its full matrix: the reference's compiles make this file ~50 s alone with
#: all ten.  Their sizes and configs are held in ``test_torch_lm_layers.py``,
#: their layers there too, and all ten run card against CPU in
#: ``chip_smoke.py``.
ARCHS = tuple(
    a if a not in ("yi-34b", "nemotron-4-340b", "qwen3-moe-235b-a22b")
    else pytest.param(a, marks=pytest.mark.slow)
    for a in ("internlm2-1.8b", "mamba2-130m", "qwen3-14b", "llama4-scout-17b-a16e",
              "jamba-v0.1-52b", "internvl2-76b", "musicgen-large",
              "yi-34b", "nemotron-4-340b", "qwen3-moe-235b-a22b"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what, tol=TOL):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=what)
    return float(np.abs(g - w).max())


def _reference_inputs(cfg):
    """The reference smoke test's inputs (``tests/test_arch_smoke.py``)."""
    key = jax.random.key(0)
    tokens = jax.random.randint(key, (2, 32), 0, cfg.vocab)
    batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, axis=1)}
    if cfg.frontend_len:
        batch["extra_embeds"] = jax.random.normal(key, (2, cfg.frontend_len, cfg.d_model)) * 0.02
    prompt = jax.random.randint(jax.random.key(3), (2, 16), 0, cfg.vocab)
    extra = None
    if cfg.frontend_len:
        extra = jax.random.normal(jax.random.key(4), (2, cfg.frontend_len, cfg.d_model)) * 0.02
    return batch, prompt, extra


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a.copy())


def _hold_state(got, want, what):
    assert got.pos == int(want.pos), what
    errs = []
    for j, (g, w) in enumerate(zip(got.caches, want.caches)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == getattr(torch, np.asarray(w[k]).dtype.name), (what, k)
            errs.append(_close(g[k], w[k], f"{what} cache {j}.{k}"))
    return max(errs)


def reference_compiled(fn, *args):
    """``fn`` jitted and compiled with XLA's excess precision off, so that
    each bf16 op rounds to bf16 as a PyTorch op does (compiled with the
    default, XLA keeps fused bf16 intermediates in f32, and the reference
    differs from its own un-jitted bodies).  What still differs is f32
    ``pow``, ``sin`` and ``cos`` by an ulp here and there, which can flip a
    bf16 rounding of a rotated key."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


_COMPILED = {}


def reference_call(arch, what, fn, *args):
    """``reference_compiled(fn, *args)(*args)``, compiled once per (arch,
    what, argument shapes) in this module."""
    key = (arch, what, str(jax.tree.map(lambda a: (a.shape, a.dtype), args)))
    if key not in _COMPILED:
        _COMPILED[key] = reference_compiled(fn, *args)
    return _COMPILED[key](*args)


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    """The reference's smoke parameters of ``arch`` (its init, key 1)."""
    return jm.init_params(jax.random.key(1), jcfgs.get_smoke(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_equal_reference(arch):
    """loss_fn, prefill (logits, caches) and 3 decode steps on the
    reference's parameters, in bf16 compute, within 2e-2."""
    jcfg, tcfg = jcfgs.get_smoke(arch), tcfgs.get_smoke(arch)
    jparams = reference_params(arch)
    tparams = lm_params_from_numpy(_np(jparams), device="cpu")
    batch, prompt, extra = _reference_inputs(jcfg)
    max_len = 16 + jcfg.frontend_len + 8

    jl, jaux = reference_call(arch, "loss", lambda p, b: jm.loss_fn(p, jcfg, b), jparams, batch)
    tl, taux = tm.loss_fn(tparams, tcfg, {k: _t(v) for k, v in batch.items()})
    assert tl.dtype == torch.float32 and tl.shape == ()
    errs = [_close(tl, jl, "loss")] + [_close(taux[k], jaux[k], k) for k in ("ce", "aux")]

    jlog, jst = reference_call(
        arch, "prefill", lambda p, t, e: jm.prefill(p, jcfg, t, max_len, extra_embeds=e),
        jparams, prompt, extra)
    tlog, tst = tm.prefill(tparams, tcfg, _t(prompt), max_len,
                           extra_embeds=None if extra is None else _t(extra))
    assert tlog.dtype == torch.float32
    errs += [_close(tlog, jlog, "prefill logits"), _hold_state(tst, jst, "prefill")]
    # the reference's caches carried across are the same state
    _hold_state(decode_state_from_numpy(_np(jst.caches), jst.pos, device="cpu"), jst, "carried")
    nxt = jnp.argmax(jlog, axis=-1)[:, None]
    for step in range(3):
        jlog, jst = reference_call(arch, "decode", lambda p, s, t: jm.decode_step(p, jcfg, s, t),
                                   jparams, jst, nxt)
        tlog, tst = tm.decode_step(tparams, tcfg, tst, _t(nxt))
        errs.append(_close(tlog, jlog, f"decode {step}"))
        nxt = jnp.argmax(jlog, axis=-1)[:, None]
    errs.append(_hold_state(tst, jst, "decode"))
    print(f"{arch}: max |port - reference| {max(errs)!r}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_longer_prefill(arch):
    """Decoding token t+1 after prefill(0..t) against prefill(0..t+1)'s
    next-token logits: the reference's consistency test
    (``tests/test_arch_smoke.py:91``), on the reference's parameters.  Each
    side equals the reference's within 2e-2, and the port's two sides are
    as close as the reference's own, within 2e-2: decode and prefill round
    differently in bf16, and where that moves a top-1 routing choice the
    two differ by much more, in both packages (llama4's second row)."""
    jcfg, cfg = jcfgs.get_smoke(arch), tcfgs.get_smoke(arch)
    jparams = reference_params(arch)
    tokens = jax.random.randint(jax.random.key(6), (2, 17), 0, jcfg.vocab)
    extra = _reference_inputs(jcfg)[2]
    max_len = 16 + cfg.frontend_len + 8
    prefill = lambda p, t, e: jm.prefill(p, jcfg, t, max_len, extra_embeds=e)  # noqa: E731
    _, jst = reference_call(arch, "prefill", prefill, jparams, tokens[:, :16], extra)
    jdec, _ = reference_call(arch, "decode", lambda p, s, t: jm.decode_step(p, jcfg, s, t),
                             jparams, jst, tokens[:, 16:])
    jfull, _ = reference_call(arch, "prefill", prefill, jparams, tokens, extra)

    params = lm_params_from_numpy(_np(jparams), device="cpu")
    ttok, text = _t(tokens), None if extra is None else _t(extra)
    _, state = tm.prefill(params, cfg, ttok[:, :16], max_len, extra_embeds=text)
    dec, after = tm.decode_step(params, cfg, state, ttok[:, 16:])
    full, _ = tm.prefill(params, cfg, ttok, max_len, extra_embeds=text)
    _close(dec, jdec, "decode")
    _close(full, jfull, "longer prefill")
    gap, jgap = (dec - full).abs().numpy(), np.abs(np.asarray(jdec) - np.asarray(jfull))
    assert np.all(gap <= jgap + TOL), float((gap - jgap).max())
    print(f"{arch}: decode against prefill max |diff|: port {float(gap.max())!r}, "
          f"reference {float(jgap.max())!r}")
    assert after.pos == state.pos + 1 == 16 + cfg.frontend_len + 1
    # the state decoded from is left as it was
    again, _ = tm.decode_step(params, cfg, state, ttok[:, 16:])
    assert torch.equal(again, dec)
