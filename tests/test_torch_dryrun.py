"""The all-to-all MoE, the walker and the dry run against the JAX reference,
on the CPU.

* ``moe_ffn_a2a`` on 4 gloo ranks (model axis 4, E = 8, k = 2,
  ``capacity_factor=1.0``, so that tokens drop) equals the reference's
  ``moe_ffn_a2a`` on 4 XLA host devices (a JAX child process: jax fixes its
  device count at start) within 1e-5 in f32, output and load-balance loss.
  The same ranks hold the loss and the gradients of dense, MoE (gather and
  a2a) and SSD smoke configs on a (2, 2) mesh against the plain
  single-process ones: in bf16 compute the loss within 2e-3 and the
  gradient norm within 2 %; in f32 compute the loss within 1e-5 and every
  leaf's gradient within 1e-4 of that leaf's max |g|.  The parameters are
  drawn onto the mesh leaf by leaf (``init_params(shardings=)``), equal to
  the plain draws: each rank draws only its own blocks, its local shards
  are ``distribute_tensor``'s slices of the whole draw bit for bit, and no
  tensor made during the draw (counted by a ``TorchDispatchMode``) has more
  elements than the rank's largest local shard.
* The walker's forward FLOPs of a prefill equal the reference's
  ``hlo_walk.analyze`` of the jitted prefill exactly at one attention tile
  (at more tiles the port skips the tiles wholly above the diagonal, which
  the reference computes and masks).
* A smoke dry-run cell on a fake 8-rank world makes a well-formed ``ok``
  record with the collectives it ran, and ``long_500k`` on a full-attention
  arch writes ``skip``.

Every process group a test makes is destroyed by its fixture or process.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.distributed import hlo_walk as jwalk  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ShapeCell, get_smoke  # noqa: E402
from repro_torch.distributed import hlo_walk  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_SETUP = """
import dataclasses
import numpy as np
def setup(get_smoke):
    cfg = dataclasses.replace(get_smoke("qwen3-moe-235b-a22b"), n_experts=8, top_k=2,
                              capacity_factor=1.0, moe_impl="a2a")
    rng = np.random.default_rng(0)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.standard_normal((d, E)).astype(np.float32) * d ** -0.5,
         "w_gate": rng.standard_normal((E, d, f)).astype(np.float32) * d ** -0.5,
         "w_up": rng.standard_normal((E, d, f)).astype(np.float32) * d ** -0.5,
         "w_down": rng.standard_normal((E, f, d)).astype(np.float32) * f ** -0.5}
    x = rng.standard_normal((4, 16, d)).astype(np.float32)
    return cfg, p, x
"""

_REFERENCE = _SETUP + """
import json
import jax
import jax.numpy as jnp
from repro.configs import get_smoke
from repro.distributed.ctx import activation_axes
from repro.launch.mesh import make_host_mesh
from repro.models import layers

cfg, p, x = setup(get_smoke)
pj = {k: jnp.asarray(v) for k, v in p.items()}
mesh = make_host_mesh(model_parallel=4)
with mesh, activation_axes(mesh):
    y, st = layers.moe_ffn_a2a(jnp.asarray(x), pj, cfg)
yg, sg = layers.moe_ffn(jnp.asarray(x), pj, cfg)
# the routed copies past each token shard's capacity, which a2a drops
T, k, E = x.shape[0] * x.shape[1], cfg.top_k, cfg.n_experts
idx = np.asarray(jax.lax.top_k(jax.nn.softmax(
    jnp.asarray(x.reshape(T, -1)) @ pj["router"], axis=-1), k)[1])
t_loc = T // 4
cap = max(4, int(cfg.capacity_factor * t_loc * k / E))
a2a_dropped = 0
for shard in range(4):
    seen = np.zeros(E, int)
    for e in idx[shard * t_loc:(shard + 1) * t_loc].reshape(-1):
        a2a_dropped += int(seen[e] >= cap)
        seen[e] += 1
print(json.dumps({"y": np.asarray(y).tolist(), "aux": float(st.aux_loss),
                  "y_gather": np.asarray(yg).tolist(),
                  "gather_dropped": float(sg.dropped_frac),
                  "a2a_dropped": a2a_dropped / (T * k)}))
"""

_WORKER = _SETUP + """
import json, sys
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke
from repro_torch.distributed import ctx, sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers, model as M
from repro_torch.tree import tree_leaves

from torch.distributed.tensor import distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _outputs


class _LargestOutput(TorchDispatchMode):
    # the most elements of any tensor with storage (not "meta": the shapes
    # of the leaves) that an op makes while the mode is on
    numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _outputs(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.numel = max(self.numel, t.numel())
        return out


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


rank, world, port = map(int, sys.argv[1:4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=world)
out = {}
try:
    cfg, p, x = setup(get_smoke)
    mesh = make_host_mesh(4, device_type="cpu")
    rules = {k: sharding.NamedSharding(mesh, (("model", None, None) if k != "router"
                                              else (None, None))) for k in p}
    pd = sharding.shard_tree({k: torch.from_numpy(v) for k, v in p.items()}, rules)
    xd = sharding.shard_leaf(torch.from_numpy(x), sharding.NamedSharding(mesh, ("data",)))
    with ctx.activation_axes(mesh):
        y, st = layers.moe_ffn_a2a(xd, pd, cfg)
    out["y"] = y.full_tensor().tolist()
    out["aux"] = float(st.aux_loss.full_tensor())
    out["dropped"] = float(st.dropped_frac.full_tensor())

    def names(tree, prefix=""):
        # leaf names in tree_leaves' order (sorted keys)
        if isinstance(tree, dict):
            return [n for k in sorted(tree) for n in names(tree[k], f"{prefix}{k}.")]
        if isinstance(tree, (list, tuple)):
            return [n for i, v in enumerate(tree) for n in names(v, f"{prefix}{i}.")]
        return [prefix[:-1]]

    def losses_and_grads(c, mesh):
        params = M.init_params(0, c, device="cpu")
        g = torch.Generator().manual_seed(1)
        tok = torch.randint(0, c.vocab, (4, 32), generator=g)
        lab = torch.randint(0, c.vocab, (4, 32), generator=g)
        batch = {"tokens": tok, "labels": lab}
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_()
        plain = dataclasses.replace(c, moe_impl="gather")
        l0 = M.loss_fn(params, plain, batch)[0]
        g0 = torch.autograd.grad(l0, leaves)
        # drawn leaf by leaf onto the mesh: the plain draws, placed; each
        # rank draws only its own blocks, so its local shards are those
        # slices of the whole draw bit for bit, and no tensor made during
        # the draw is larger than the rank's largest local shard
        psh = sharding.param_shardings(c, mesh)
        with _LargestOutput() as seen:
            pd = M.init_params(0, c, device="cpu", shardings=psh)
        dl = tree_leaves(pd)
        assert all(ctx.is_dtensor(t) and torch.equal(t.full_tensor(), w)
                   for t, w in zip(dl, leaves))
        for t, w in zip(dl, leaves):
            want = distribute_tensor(w.detach(), t.device_mesh, t.placements).to_local()
            assert torch.equal(_bits(t.to_local()), _bits(want)), (c.name, t.placements)
        largest = max(t.to_local().numel() for t in dl)
        assert 0 < seen.numel <= largest, (c.name, seen.numel, largest)
        out.setdefault("largest", []).append([seen.numel, largest, sum(w.numel() for w in leaves)])
        bd = sharding.shard_tree(batch, sharding.batch_shardings(c, mesh, False, batch=4))
        for t in dl:
            t.requires_grad_()
        with ctx.activation_axes(mesh):
            l1 = M.loss_fn(pd, c, bd)[0]
            g1 = torch.autograd.grad(l1, dl)
        return (float(l0), float(l1.full_tensor()), names(params), list(g0),
                [t.full_tensor() for t in g1])

    mesh2 = make_host_mesh(2, device_type="cpu")
    cases = [("internlm2-1.8b", "gather"), ("qwen3-moe-235b-a22b", "gather"),
             ("qwen3-moe-235b-a22b", "a2a"), ("mamba2-130m", "gather")]
    norm = lambda gs: float(sum(t.float().square().sum() for t in gs)) ** 0.5
    for arch, impl in cases:
        l0, l1, _, g0, g1 = losses_and_grads(
            dataclasses.replace(get_smoke(arch), moe_impl=impl), mesh2)
        out[f"{arch}/{impl}"] = [l0, l1, norm(g0), norm(g1)]
    # the same in f32: each leaf's gradient (max |mesh - plain|, max |plain|)
    M.COMPUTE = torch.float32
    M._cast_tree.__defaults__ = (torch.float32,)
    for arch, impl in cases:
        l0, l1, leaf_names, g0, g1 = losses_and_grads(
            dataclasses.replace(get_smoke(arch), moe_impl=impl), mesh2)
        out[f"f32/{arch}/{impl}"] = [l0, l1, {
            n: [float((b - a).abs().max()), float(a.abs().max())]
            for n, a, b in zip(leaf_names, g0, g1)}]
finally:
    dist.destroy_process_group()
if rank == 0:
    print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _four_ranks():
    """The reference child (4 XLA host devices) and the port's 4 gloo ranks,
    run side by side; each process ends its own process group."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE], env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    port = _free_port()
    env_t = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "4", str(port)],
                              env=env_t, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(4)]
    outs = []
    try:
        for proc in [ref] + ranks:
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for proc in [ref] + ranks:
            if proc.poll() is None:
                proc.kill()
    return (json.loads(outs[0].strip().splitlines()[-1]),
            json.loads(outs[1].strip().splitlines()[-1]))


def test_moe_a2a_equals_reference_on_four_ranks():
    """One test for the one set of processes (a module fixture would run
    once per test worker that takes one of its tests)."""
    want, got = _four_ranks()
    y, y_ref, y_gather = (np.asarray(v) for v in (got["y"], want["y"], want["y_gather"]))
    assert want["gather_dropped"] > 0.05            # tokens drop at this capacity,
    assert want["a2a_dropped"] > 0.05               # on both paths
    assert np.abs(y_ref - y_gather).max() > 1e-2    # so a2a is not the gather path
    assert np.abs(y - y_ref).max() <= 1e-5
    assert abs(got["aux"] - want["aux"]) <= 1e-5
    assert got["dropped"] == 0.0
    # the mesh's losses and gradients against the plain single-process ones
    for case in ("internlm2-1.8b/gather", "qwen3-moe-235b-a22b/gather",
                 "qwen3-moe-235b-a22b/a2a", "mamba2-130m/gather"):
        l0, l1, g0, g1 = got[case]
        assert np.isfinite([l0, l1, g0, g1]).all(), case
        assert abs(l1 - l0) <= 2e-3, case
        assert abs(g1 - g0) <= 2e-2 * g0, case
        # in f32, every leaf's gradient (the hand-set placements and the
        # custom gather / slice / sum collectives) within 1e-4 of its max
        l0, l1, leaves = got["f32/" + case]
        assert abs(l1 - l0) <= 1e-5, case
        for name, (err, gmax) in leaves.items():
            assert gmax > 0 and err <= 1e-4 * gmax, (case, name, err, gmax)
    # every sharded draw on rank 0: no tensor made passed its largest local shard
    assert len(got["largest"]) == 2 * 4
    assert all(0 < seen <= largest < total for seen, largest, total in got["largest"])
    assert {"blocks.0.A_log", "blocks.0.dt_bias", "blocks.0.norm1", "final_norm"} <= \
        set(got["f32/mamba2-130m/gather"][2])
    assert "blocks.0.router" in got["f32/qwen3-moe-235b-a22b/a2a"][2]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-235b-a22b", "mamba2-130m"])
def test_walker_prefill_flops_equal_reference(arch):
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tok = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    compiled = jax.jit(lambda p, t: jmodel.prefill(p, jcfg, t, 16)).lower(params, tok).compile()
    want = jwalk.analyze(compiled.as_text(), 1)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    got = hlo_walk.analyze(M.prefill, tp, cfg, torch.from_numpy(tok).long(), 16)
    assert got.flops == want.flops > 0
    assert got.bytes > 0 and got.peak_bytes > 0 and got.collective_wire_bytes == 0


def test_dryrun_cells_on_a_fake_world(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    dryrun.fake_world(8, "cpu")
    try:
        mesh = make_host_mesh(4, device_type="cpu")
        cell = ShapeCell("smoke_train", "train", 32, 8)
        record, cost = dryrun.trace_cell(get_smoke("qwen3-moe-235b-a22b"), cell, mesh)
    finally:
        dist.destroy_process_group()
    fp = tmp_path / "smoke.json"
    fp.write_text(json.dumps(record))
    rec = json.loads(fp.read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 8 and rec["n_microbatch"] >= 1
    assert rec["device_type"] == "cpu"
    assert {"memory", "hlo_walk", "collectives", "roofline", "trace_s"} <= set(rec)
    assert rec["memory"]["argument_size_in_bytes"] > 0 and rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["hlo_walk"]["flops"] > 0 and rec["collectives"]["ops"].get("all-gather", 0) > 0
    r = rec["roofline"]
    assert r["step_time_lower_bound_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"])

    out = tmp_path / "cells"
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "long_500k", "--mesh", "both",
                 "--out", str(out), "--device-type", "cpu"])
    for mesh_tag in ("single", "multi"):
        rec = json.loads((out / f"internlm2-1.8b__long_500k__{mesh_tag}.json").read_text())
        assert rec["status"] == "skip" and "full-attention" in rec["reason"]
        assert rec["device_type"] == "cpu"
    assert not dist.is_initialized()
