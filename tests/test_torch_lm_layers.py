"""The LM layers of the PyTorch port (``repro_torch.models.layers``) against
the JAX reference (``repro.models.layers``) on the CPU, on the same inputs
made from a numpy seed; and the LM's configs and parameters.

The reference runs jitted and compiled with XLA's excess precision off
(``ref``), so that each of its bf16 ops rounds to bf16 as a PyTorch op does.
In float32 every layer is held within 1e-5 relative and 1e-5 absolute, in
bf16 within 2e-2, the bound of the reference's own smoke tests
(``tests/test_arch_smoke.py``).  The MoE routing (each copy's expert, its
slot, ``keep`` and the per-expert counts) is held exactly.

* Sizes: ``count_params`` and ``active_param_count`` equal the reference's
  for all ten full configs, and ``param_shapes`` has its shapes and dtypes
  (meta tensors: nothing is allocated).
* The registry (``ARCH_IDS``, ``get_config``, ``get_smoke``, ``SHAPES``,
  ``applicable``, ``microbatches_for``) equals the reference's.
* ``init_params`` keeps the reference's leaf rules; ``lm_params_from_numpy``
  carries a tree across bit for bit, bf16 included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

ARCHS = tuple(jcfgs.ARCH_IDS)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = tuple(TOL)


def _pair(arrays, dtype):
    """Each numpy array as a JAX array of ``dtype`` and the same bits as a
    CPU tensor (a dict of arrays gives two dicts)."""
    if isinstance(arrays, dict):
        j = {k: jnp.asarray(v, dtype) for k, v in arrays.items()}
        return j, lm_params_from_numpy({k: np.asarray(v) for k, v in j.items()}, "cpu")
    j = jnp.asarray(arrays, dtype)
    return j, lm_params_from_numpy({"a": np.asarray(j)}, "cpu")["a"]


def ref(fn, *args):
    """The reference's ``fn(*args)``, jitted and compiled with XLA's excess
    precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _close(got, want, dtype, what=""):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=what)
    err = float(np.abs(g - w).max())
    print(f"[{dtype} {what}] max |port - reference| {err!r}")
    return err


def _cfgs(arch, **over):
    """The reference's and the port's smoke config of ``arch``, with the
    same overrides."""
    return (dataclasses.replace(jget_smoke(arch), **over),
            dataclasses.replace(get_smoke(arch), **over))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    (jx, tx), (js, ts) = _pair(rng.normal(size=(2, 5, 32)) * 3, dtype), \
        _pair(1 + 0.1 * rng.normal(size=(32,)), dtype)
    _close(tl.rms_norm(tx, ts), ref(jl.rms_norm, jx, js), dtype, "rms_norm")
    assert tl.rms_norm(tx, ts).dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(dtype, theta):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.normal(size=(2, 7, 4, 16)), dtype)
    pos = rng.integers(0, 100, size=(2, 7)).astype(np.int32)
    got = tl.apply_rope(tx, torch.from_numpy(pos), theta)
    _close(got, ref(lambda x, p: jl.apply_rope(x, p, theta), jx, jnp.asarray(pos)), dtype,
           "apply_rope")
    np.testing.assert_allclose(tl.rope_freqs(16, theta).numpy(),
                               np.asarray(jl.rope_freqs(16, theta)), rtol=1e-6)


def _qkv(dtype, B=2, Lq=64, Lkv=64, H=4, KVH=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return (_pair(rng.normal(size=(B, Lq, H, hd)), dtype),
            _pair(rng.normal(size=(B, Lkv, KVH, hd)), dtype),
            _pair(rng.normal(size=(B, Lkv, KVH, hd)), dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["dense8", "dense16", "dense64", "skip8", "skip16",
                                  "offset", "not_causal", "uneven"])
def test_flash_attention(dtype, case):
    kw = dict(causal=True, q_chunk=8, kv_chunk=8)
    shape = {}
    if case.startswith("dense"):
        kw.update(q_chunk=int(case[5:]), kv_chunk=int(case[5:]))
    elif case.startswith("skip"):
        kw.update(q_chunk=int(case[4:]), kv_chunk=2 * int(case[4:]), causal_skip=True)
    elif case == "offset":      # 16 queries at positions 48..63 of a 64-key prefix
        shape, kw = dict(Lq=16), dict(kw, q_offset=48)
    elif case == "not_causal":
        kw.update(causal=False, kv_chunk=16)
    else:                       # chunks 12 -> 10 and 24 -> 20, the divisors of 40
        shape, kw = dict(Lq=40, Lkv=40), dict(kw, q_chunk=12, kv_chunk=24)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(dtype, **shape)
    got = tl.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype
    _close(got, ref(lambda q, k, v: jl.flash_attention(q, k, v, **kw), jq, jk, jv), dtype, case)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_on_a_padded_cache(dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(dtype, Lq=1, Lkv=40, seed=2)
    got = tl.decode_attention(tq, tk, tv, 33)
    _close(got, ref(lambda q, k, v: jl.decode_attention(q, k, v, 33), jq, jk, jv), dtype,
           "decode_attention")
    # rows past kv_len are never read
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, 33:], tv2[:, 33:] = 7.0, -5.0
    assert torch.equal(tl.decode_attention(tq, tk2, tv2, 33), got)


def _block(arch, dtype, **over):
    """Smoke config pair and block 0's parameters (the reference's init),
    as JAX arrays of ``dtype`` and the same bits as tensors."""
    jcfg, tcfg = _cfgs(arch, **over)
    params = jm.init_params(jax.random.key(3), jcfg)
    blk = {k: np.asarray(v[0], np.float32) for k, v in params["blocks"][0].items()}
    return jcfg, tcfg, _pair(blk, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,act", [("internlm2-1.8b", "swiglu"),
                                      ("nemotron-4-340b", "squared_relu"),
                                      ("musicgen-large", "gelu")])
def test_dense_ffn(dtype, arch, act):
    jcfg, tcfg, (jp, tp) = _block(arch, dtype)
    assert jcfg.act == act
    jx, tx = _pair(np.random.default_rng(4).normal(size=(2, 8, 64)), dtype)
    _close(tl.dense_ffn(tx, tp, tcfg), ref(lambda x, p: jl.dense_ffn(x, p, jcfg), jx, jp),
           dtype, act)


def _reference_route(xf, router, cfg, cap):
    """The reference's routing, ``repro/models/layers.py:275-288``: the
    expert of each routed copy, its slot and ``keep``."""
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ router.astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(flat_e), np.asarray(pos), np.asarray(pos < cap)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["dropfree", "drops", "drops_shared_sqrelu"])
def test_moe_ffn(dtype, case):
    over = dict(n_experts=4, top_k=2, capacity_factor=8.0)
    arch = "qwen3-moe-235b-a22b"
    if case != "dropfree":
        over["capacity_factor"] = 1.0
    if case == "drops_shared_sqrelu":
        arch, over["act"], over["n_shared_experts"] = "llama4-scout-17b-a16e", "squared_relu", 1
    jcfg, tcfg, (jp, tp) = _block(arch, dtype, **over)
    jx, tx = _pair(np.random.default_rng(6).normal(size=(2, 16, 64)), dtype)

    y, stats = tl.moe_ffn(tx, tp, tcfg)
    jy, jstats = ref(lambda x, p: jl.moe_ffn(x, p, jcfg), jx, jp)
    _close(y, jy, dtype, "y")
    cap = tl._capacity(tcfg, 32)
    assert cap == (16 if case != "dropfree" else 32)
    _, _, flat_e, pos, keep = tl._route(tx.reshape(32, 64), tp["router"], tcfg, cap)
    want_e, want_pos, want_keep = _reference_route(jx.reshape(32, 64), jp["router"], jcfg, cap)
    np.testing.assert_array_equal(flat_e.numpy(), want_e)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(torch.bincount(flat_e, minlength=4).numpy(),
                                  np.asarray(jnp.bincount(jnp.asarray(want_e), length=4)))
    assert (not keep.all()) == (case != "dropfree")
    for got, want in zip(stats, jstats):
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-6


def _ssd_inputs(dtype, L=16, H=4, P=8, S=6, seed=7, with_state=False):
    rng = np.random.default_rng(seed)
    jx, tx = _pair(rng.normal(size=(2, L, H, P)), dtype)
    jB, tB = _pair(rng.normal(size=(2, L, 1, S)), dtype)
    jC, tC = _pair(rng.normal(size=(2, L, 1, S)), dtype)
    dt = np.log1p(np.exp(rng.normal(size=(2, L, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(0, np.log(16), size=(H,))).astype(np.float32)
    st = rng.normal(size=(2, H, P, S)).astype(np.float32) if with_state else None
    j = (jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, None if st is None else jnp.asarray(st))
    t = (tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC,
         None if st is None else torch.from_numpy(st))
    return j, t


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [1, 8, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked(dtype, chunk, with_state):
    j, t = _ssd_inputs(dtype, with_state=with_state)
    y, st = tl.ssd_chunked(*t[:5], chunk=chunk, initial_state=t[5])
    jy, jst = ref(lambda *a: jl.ssd_chunked(*a[:5], chunk=chunk, initial_state=a[5]), *j)
    assert y.dtype == t[0].dtype and st.dtype == torch.float32
    _close(y, jy, dtype, "y")
    # the carried state is f32 on both sides, so bf16 inputs leave it close
    _close(st, jst, dtype, "state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_mixer_prefill_then_decode(dtype):
    jcfg, tcfg, (jp, tp) = _block("mamba2-130m", dtype)
    rng = np.random.default_rng(8)
    jx, tx = _pair(rng.normal(size=(2, 16, 64)), dtype)
    out, st = tl.mamba_mixer(tx, tp, tcfg, return_state=True)
    jout, jst = ref(lambda x, p: jl.mamba_mixer(x, p, jcfg, return_state=True), jx, jp)
    _close(out, jout, dtype, "prefill")
    for k in ("conv", "ssm"):
        _close(st[k], jst[k], dtype, k)
    assert tl.mamba_mixer(tx, tp, tcfg)[1] is None
    # decode one token from the reference's own state, carried across
    jstate = {k: np.asarray(v) for k, v in jst.items()}
    tstate = lm_params_from_numpy(jstate, "cpu")
    jx1, tx1 = _pair(rng.normal(size=(2, 1, 64)), dtype)
    out1, st1 = tl.mamba_mixer(tx1, tp, tcfg, state=tstate)
    jout1, jst1 = ref(lambda x, p, st: jl.mamba_mixer(x, p, jcfg, state=st), jx1, jp,
                      {k: jnp.asarray(v) for k, v in jstate.items()})
    _close(out1, jout1, dtype, "decode")
    for k in ("conv", "ssm"):
        _close(st1[k], jst1[k], dtype, "decode " + k)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_shapes_equal_reference(arch):
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert tm.count_params(tcfg) == jm.count_params(jcfg) == jcfg.param_count()
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    want, got = jm.param_shapes(jcfg), tm.param_shapes(tcfg)
    assert list(got) == list(want) and len(got["blocks"]) == len(want["blocks"])
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == want[name].dtype.name
        assert got[name].device.type == "meta"
    for g, w in zip(got["blocks"], want["blocks"]):
        assert list(g) == list(w)
        for k in w:
            assert tuple(g[k].shape) == w[k].shape, k
            assert str(g[k].dtype).split(".")[-1] == w[k].dtype.name, k


def test_registry_equals_reference():
    assert tcfgs.ARCH_IDS == jcfgs.ARCH_IDS
    assert [c.name for c in tcfgs.ALL] == [c.name for c in jcfgs.ALL]
    for arch in jcfgs.ARCH_IDS:
        for get in ("get_config", "get_smoke"):
            assert dataclasses.asdict(getattr(tcfgs, get)(arch)) == \
                dataclasses.asdict(getattr(jcfgs, get)(arch)), (get, arch)
        assert tcfgs.archs.smoke_variant(tcfgs.get_config(arch)) == tcfgs.get_smoke(arch)
    assert [dataclasses.asdict(s) for s in tcfgs.SHAPES] == \
        [dataclasses.asdict(s) for s in jcfgs.SHAPES]
    assert sorted(tcfgs.SHAPES_BY_NAME) == sorted(jcfgs.SHAPES_BY_NAME)
    for arch in jcfgs.ARCH_IDS:
        for tcell, jcell in zip(tcfgs.SHAPES, jcfgs.SHAPES):
            assert tcfgs.applicable(tcfgs.get_config(arch), tcell) == \
                jcfgs.applicable(jcfgs.get_config(arch), jcell)
            for shards in (1, 4, 16, 256):
                assert tcfgs.microbatches_for(tcfgs.get_config(arch), tcell, shards) == \
                    jcfgs.microbatches_for(jcfgs.get_config(arch), jcell, shards)
    with pytest.raises(KeyError, match="unknown arch"):
        tcfgs.get_config("nope")


@pytest.mark.parametrize("arch,dtype", [("jamba-v0.1-52b", "float32"),
                                        ("qwen3-14b", "bfloat16")])
def test_init_params_leaf_rules(arch, dtype):
    cfg = dataclasses.replace(tcfgs.get_smoke(arch), param_dtype=dtype, d_model=128)
    params = tm.init_params(0, cfg, device="cpu")
    shapes = tm.param_shapes(cfg)
    seen = set()
    for (name, leaf), (_, meta) in zip(tm._leaves(params), tm._leaves(shapes)):
        assert leaf.shape == meta.shape and leaf.dtype == getattr(torch, dtype), name
        assert leaf.device.type == "cpu"
        x = leaf.float()
        if "norm" in name or name == "D":
            assert torch.all(x == 1), name
        elif name in ("conv_b", "dt_bias"):
            assert torch.all(x == 0), name
        elif name == "A_log":
            a = torch.exp(leaf.float())
            assert torch.all((a >= 1) & (a < 16.01)) and a.std() > 1, name
        else:
            fan_in = leaf.shape[-2] if leaf.dim() > 1 else leaf.shape[0]
            sd = fan_in ** -0.5
            assert abs(float(x.mean())) < 0.1 * sd + 3 * sd / x.numel() ** 0.5, name
            assert abs(float(x.std()) * fan_in ** 0.5 - 1) < 0.1, name
        seen.add(name)
    assert {"norm1", "wq", "lm_head", "embed"} <= seen
    again = tm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    other = tm.init_params(1, cfg, device="cpu")
    for (_, a), (_, b), (_, c) in zip(tm._leaves(params), tm._leaves(again), tm._leaves(other)):
        assert torch.equal(a, b)
    assert not torch.equal(params["embed"], other["embed"])


def test_lm_params_from_numpy_bit_for_bit():
    cfg = dataclasses.replace(jcfgs.get_smoke("llama4-scout-17b-a16e"), param_dtype="bfloat16")
    ref = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0), cfg))
    ref["extra_f32"] = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = lm_params_from_numpy(ref, device="cpu")
    assert isinstance(got["blocks"], list) and len(got["blocks"]) == 1
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t, got, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert len(flat_got) == len(flat_ref) == 17
    for (pr, r), (pg, g) in zip(flat_ref, flat_got):
        assert str(pr) == str(pg)
        if r.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), r.view(np.int16))
        else:
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy().view(np.int32), r.view(np.int32))
