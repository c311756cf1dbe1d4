"""The port's distribution layer against the JAX reference, on the CPU.

* The sharding rules: every leaf of ``param_shardings`` (both ``flat_fsdp``
  values), ``opt_shardings``, ``batch_shardings`` and
  ``decode_state_shardings`` names the reference's ``PartitionSpec``, for
  the ten archs on meshes (16, 16), (2, 16, 16), (2, 4) and (1, 1); the
  reference evaluates on ``jax.sharding.AbstractMesh`` (no devices), the
  port on its ``AbstractMesh``.  Per-device parameter bytes equal the sum
  of the reference's ``shard_shape`` bytes.
* ``analysis``: the ring wire bytes, the roofline (given the reference's
  constants) and the model-flops estimate equal the reference's.
* ``ctx.constrain`` is the identity outside a mesh and picks the
  reference's spec on a fake (2, 4) world; a loss runs there on DTensor
  parameters for a dense, an MoE and an SSD smoke config.
* ``checkpoint.store.restore(shardings=)`` restores as DTensors, and a
  Trainer on a one-rank 1 x 1 mesh equals the unsharded one bit for bit.

Every process group a test makes is destroyed by its fixture.
"""
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.distributed import analysis as janalysis  # noqa: E402
from repro.distributed import ctx as jctx  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke  # noqa: E402
from repro_torch.distributed import analysis, ctx, sharding  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((1, 1), ("data", "model"))]


def _norm(spec):
    return tuple(spec)


def _specs(tree):
    return [_norm(tuple(s.spec)) for s in tree_leaves(tree)]


def _jspecs(tree):
    return [_norm(tuple(s.spec)) for s in jax.tree.leaves(tree)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_specs_equal_reference(arch, mesh):
    shape, names = mesh
    jm, pm = JAbstractMesh(shape, names), sharding.AbstractMesh(shape, names)
    jcfg, cfg = jget(arch), get_config(arch)
    for flat in (False, True):
        jp = jsharding.param_shardings(jcfg, jm, flat_fsdp=flat)
        pp = sharding.param_shardings(cfg, pm, flat_fsdp=flat)
        assert _specs(pp) == _jspecs(jp), flat
    jo = jsharding.opt_shardings(jp, jsharding.replicated(jm))
    po = sharding.opt_shardings(pp, sharding.replicated(pm))
    assert _specs(po) == _jspecs(jo)
    assert _norm(sharding.batch_spec(pm)) == _norm(tuple(jsharding.batch_spec(jm)))
    for fe in (False, True):
        for batch in (None, 1, 32, 256):
            jb = jsharding.batch_shardings(jcfg, jm, fe, batch=batch)
            pb = sharding.batch_shardings(cfg, pm, fe, batch=batch)
            assert {k: _norm(v.spec) for k, v in pb.items()} == \
                {k: _norm(tuple(v.spec)) for k, v in jb.items()}
    for batch in (1, 128):
        jd = jsharding.decode_state_shardings(jcfg, jm, batch)
        pd = sharding.decode_state_shardings(cfg, pm, batch)
        assert _specs(pd.caches) == _jspecs(jd.caches)
        assert _norm(pd.pos.spec) == _norm(tuple(jd.pos.spec)) == ()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_bytes_per_device_equal_reference(arch):
    jm, pm = JAbstractMesh((16, 16), ("data", "model")), sharding.AbstractMesh(
        (16, 16), ("data", "model"))
    jcfg, cfg = jget(arch), get_config(arch)
    want = sum(int(np.prod(sh.shard_shape(s.shape))) * s.dtype.itemsize
               for s, sh in zip(jax.tree.leaves(jmodel.param_shapes(jcfg)),
                                jax.tree.leaves(jsharding.param_shardings(jcfg, jm))))
    from repro_torch.models.model import param_shapes

    got = sum(int(np.prod(sh.shard_shape(t.shape))) * t.element_size()
              for t, sh in zip(tree_leaves(param_shapes(cfg)),
                               tree_leaves(sharding.param_shardings(cfg, pm))))
    assert got == want
    if arch == "internlm2-1.8b":
        assert got == 29_917_184


def test_wire_bytes_equal_reference():
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "send"):
        for g in (1, 2, 4, 16, 256, 512):
            for b in (0, 1, 4096, 123_456_789):
                assert analysis._wire_bytes(op, b, g) == janalysis._wire_bytes(op, b, g)


def test_roofline_and_model_flops_equal_reference():
    consts = dict(peak_flops=janalysis.PEAK_FLOPS, hbm_bw=janalysis.HBM_BW,
                  link_bw=janalysis.ICI_BW)
    for args in [(1e15, 3e12, 2e10, 256, 1e17), (4e12, 9e13, 0.0, 512, 3e15),
                 (0.0, 0.0, 0.0, 1, 0.0), (2e11, 1e9, 5e11, 8, 1e12)]:
        assert analysis.roofline(*args, **consts).as_dict() == \
            janalysis.roofline(*args).as_dict()
    for arch in ARCH_IDS:
        for cell, jcell in zip(SHAPES, JSHAPES):
            assert analysis.model_flops_estimate(get_config(arch), cell) == \
                janalysis.model_flops_estimate(jget(arch), jcell)
    # the card's constants, not the TPU's
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW) == (989e12, 3.35e12)
    assert (analysis.NVLINK_BW, analysis.NIC_BW) == (450e9, 50e9)
    assert analysis.link_bw(range(8)) == 450e9 and analysis.link_bw(range(16)) == 50e9


@pytest.fixture
def fake_mesh():
    """A (2, 4) ("data", "model") mesh on a fake world of 8 ranks."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_host_mesh

    fake_world(8, "cpu")
    try:
        yield make_host_mesh(4, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank():
    """A one-rank gloo world and its 1 x 1 host mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_constructors_need_a_fitting_world(fake_mesh):
    from repro_torch.launch.mesh import data_axes, make_host_mesh, make_production_mesh

    assert fake_mesh.mesh_dim_names == ("data", "model") and tuple(fake_mesh.mesh.shape) == (2, 4)
    assert data_axes(fake_mesh) == ("data",)
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError):
        make_host_mesh(3, device_type="cpu")
    assert data_axes(sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))) == \
        ("pod", "data")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cuda_meshes_are_refused_without_a_card(fake_mesh):
    """The meshes and the dry run default to device type cuda and never
    fall back to the CPU on their own."""
    from repro_torch.launch import dryrun, perf
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        make_host_mesh(4)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        dryrun.lower_cell("internlm2-1.8b", "train_4k", False)
    for main in (dryrun.main, perf.main):
        with pytest.raises(SystemExit):
            main(["--arch", "internlm2-1.8b", "--shape", "train_4k"] if main is dryrun.main
                 else ["--pair", "moe"])


def test_constrain_is_identity_outside_a_mesh(fake_mesh):
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert ctx.constrain(x, ("batch", None, "model")) is x
    assert ctx.constrain(None, ("batch",)) is None
    d = sharding.shard_leaf(x, sharding.NamedSharding(fake_mesh, ("data", None, None)))
    assert ctx.current_axes() is None
    assert ctx.constrain(d, ("batch", None, "model")) is d
    with ctx.activation_axes(fake_mesh):
        assert ctx.constrain(x, ("batch", None, "model")) is x       # a plain tensor
    assert ctx.current_axes() is None


def _reference_spec(shape, dims, mesh_shape, names, monkeypatch):
    """The spec the reference's ``constrain`` hands ``with_sharding_constraint``."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sh: seen.append(sh.spec) or x)
    with jctx.activation_axes(JAbstractMesh(mesh_shape, names)):
        jctx.constrain(jax.ShapeDtypeStruct(shape, np.float32), dims)
    return _norm(tuple(seen[0]))


@pytest.mark.parametrize("shape,dims", [
    ((4, 8, 12), ("batch", None, "model")),
    ((3, 8, 12), ("batch", None, "model")),       # batch does not divide: replicated
    ((4, 8, 6), ("batch", "model", None)),
    ((4, 8, 2, 16), ("batch", None, "model", None)),   # 2 heads over 4: replicated
    ((8, 5), (None, "model")),
])
def test_constrain_picks_reference_spec(fake_mesh, monkeypatch, shape, dims):
    want = _reference_spec(shape, dims, (2, 4), ("data", "model"), monkeypatch)
    x = torch.arange(float(np.prod(shape))).reshape(shape)
    d = sharding.shard_leaf(x, sharding.NamedSharding(fake_mesh, (None,) * len(shape)))
    with ctx.activation_axes(fake_mesh):
        assert _norm(ctx.spec_for(shape, dims)) == want
        out = ctx.constrain(d, dims)
    assert tuple(out.placements) == sharding.placements_for(fake_mesh, want)
    assert tuple(out.shape) == shape


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-235b-a22b", "mamba2-130m"])
def test_loss_runs_on_fake_world(fake_mesh, arch):
    from torch.distributed.tensor import DTensor

    from repro_torch.models import model as M

    cfg = get_smoke(arch)
    params = sharding.shard_tree(M.init_params(0, cfg, device="cpu"),
                                 sharding.param_shardings(cfg, fake_mesh))
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (4, 32), generator=g)
    batch = sharding.shard_tree({"tokens": tok, "labels": tok},
                                sharding.batch_shardings(cfg, fake_mesh, False, batch=4))
    with ctx.activation_axes(fake_mesh):
        loss, aux = M.loss_fn(params, cfg, batch)
    assert isinstance(loss, DTensor) and loss.shape == () and set(aux) == {"ce", "aux"}


def test_restore_onto_shardings_gives_dtensors(fake_mesh, tmp_path):
    """The reference's elastic restart: a checkpoint restored onto the
    parameter shardings of another mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import store
    from repro_torch.models import model as M

    cfg = get_smoke("qwen3-moe-235b-a22b")
    params = M.init_params(0, cfg, device="cpu")
    store.save(tmp_path, 3, params)
    sh = sharding.param_shardings(cfg, fake_mesh)
    got = store.restore(tmp_path, 3, M.param_shapes(cfg), shardings=sh)
    for t, want, s in zip(tree_leaves(got), tree_leaves(params), tree_leaves(sh)):
        assert isinstance(t, DTensor) and tuple(t.placements) == s.placements
        assert t.shape == want.shape and t.dtype == want.dtype
        # rank 0's shard: the leading block of every sharded dimension
        local = t.to_local()
        assert torch.equal(local, want[tuple(slice(0, n) for n in local.shape)])


def test_sharded_trainer_on_one_rank_equals_unsharded(one_rank, tmp_path):
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed import steps
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_smoke("internlm2-1.8b")
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, decay_steps=4, moment_dtype=cfg.moment_dtype)

    def run(name, mesh, psh=None, osh=None):
        tcfg = TrainerConfig(total_steps=2, ckpt_every=100, ckpt_dir=str(tmp_path / name),
                             log_every=1)
        tr = Trainer(cfg, tcfg, opt_cfg, mesh, steps.make_train_step(cfg, opt_cfg, 2),
                     psh, osh)
        data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
        try:
            state = tr.fit(tr.init_state(), iter(data))
        finally:
            data.close()
        leaves = [t.full_tensor() if hasattr(t, "full_tensor") else t
                  for t in tree_leaves((state.params, state.opt_state.mu, state.opt_state.nu))]
        return [m["loss"] for m in tr.metrics_log], leaves

    psh = sharding.param_shardings(cfg, one_rank)
    osh = sharding.opt_shardings(psh, sharding.replicated(one_rank))
    l0, p0 = run("plain", "cpu")
    l1, p1 = run("mesh", one_rank, psh, osh)
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    with pytest.raises(ValueError, match="DeviceMesh"):
        Trainer(cfg, TrainerConfig(), opt_cfg, "cpu", None, psh, None)
