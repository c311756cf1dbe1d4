"""The port's fault-tolerant trainer (``repro_torch.runtime.trainer``) and
its launcher (``repro_torch.launch.train``) against the JAX reference's
``Trainer`` on the CPU, at internlm2-1.8b's smoke config.

* Each package trains 6 steps with a checkpoint every 3 and a link
  failure drawn with probability 0.5 after each step; a restart resumes at
  step 6 with the saved parameters and optimizer state bit for bit.
* The link events and the re-arbitration rounds are the reference's: both
  draw from ``np.random.default_rng(seed)`` in the same order, and the
  port's interconnect equals the reference's (``test_torch_interconnect.py``).
* A checkpoint written by either package restores in the other (params and
  ``opt/``), and the port resumes the reference's step-3 checkpoint: its
  steps 4-6 land within 2 x (the sum of their learning rates) of the
  reference's parameters (an Adam step moves an entry by about lr; a
  gradient of the other sign, within bf16 rounding, moves it the other way).
* SIGTERM during ``fit`` saves at the next step boundary and stops.
* ``launch.train.main`` with ``--device cpu``.
"""
import dataclasses
import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.distributed import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.distributed import steps  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "internlm2-1.8b"
OPT = dict(warmup_steps=2, decay_steps=50)
TCFG = dict(total_steps=6, ckpt_every=3, log_every=1, pods=2, links_per_pod_pair=4,
            link_failure_prob_per_step=0.5, seed=0)
DATA = dict(seq_len=32, global_batch=4, seed=1)


def _bits(a):
    """A leaf's bytes as an integer array (bf16 and float alike)."""
    a = a.detach().cpu() if isinstance(a, torch.Tensor) else np.asarray(a)
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    return a.view(f"i{a.dtype.itemsize}") if a.dtype.kind == "f" else a


def _equal_trees(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def _port_trainer(ckpt_dir, **over):
    cfg = get_smoke(ARCH)
    opt_cfg = adamw.AdamWConfig(**OPT)
    tcfg = TrainerConfig(ckpt_dir=str(ckpt_dir), **dict(TCFG, **over))
    return Trainer(cfg, tcfg, opt_cfg, "cpu", steps.make_train_step(cfg, opt_cfg, 2), None,
                   None)


def _fabric(tr):
    return [dataclasses.asdict(link) for link in tr.fabric.links]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("port")
    tr = _port_trainer(d)
    tr.bringup_fabric()
    before = _fabric(tr)
    data = TokenPipeline(DataConfig(vocab=tr.cfg.vocab, **DATA))
    try:
        state = tr.fit(tr.init_state(), iter(data))
    finally:
        data.close()
    return d, tr, state, before


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    cfg = jsmoke(ARCH)
    mesh = make_host_mesh()
    opt_cfg = jadam.AdamWConfig(**OPT)
    params_sh = jsharding.param_shardings(cfg, mesh)
    opt_sh = jsharding.opt_shardings(params_sh, jsharding.replicated(mesh))
    step_fn = jax.jit(jsteps.make_train_step(cfg, opt_cfg, n_microbatch=2),
                      donate_argnums=(0, 1))
    tr = jtrainer.Trainer(cfg, jtrainer.TrainerConfig(ckpt_dir=str(d), **TCFG), opt_cfg, mesh,
                          step_fn, params_sh, opt_sh)
    before = [dataclasses.asdict(link) for link in tr.bringup_fabric().links]
    data = JTokenPipeline(JDataConfig(vocab=cfg.vocab, **DATA))
    try:
        state = tr.fit(tr.init_state(), iter(data))
    finally:
        data.close()
    return d, tr, jax.tree.map(np.asarray, (state.params, state.opt_state)), before


def test_trainer_checkpoints_and_resumes(port_run):
    d, tr, state, _ = port_run
    assert state.step == 6 and int(state.opt_state.step) == 6
    assert [m["step"] for m in tr.metrics_log] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in tr.metrics_log)
    assert len(tr.fabric.links) == 4
    assert sorted(p.name for p in d.iterdir() if p.name.startswith("step_")) == [
        "step_00000003", "step_00000006"]
    # "crash" and restart from the latest checkpoint: resumes at step 6
    tr2 = _port_trainer(d)
    state2 = tr2.init_state()
    assert state2.step == 6
    assert all(t.device.type == "cpu" for t in tree_leaves(state2.params))
    _equal_trees(state2.params, jax.tree.map(lambda t: t.numpy(), state.params))
    assert int(state2.opt_state.step) == 6
    _equal_trees(state2.opt_state, tuple(tree_leaves(state.opt_state)))


def test_link_events_and_rearbitration_equal_reference(port_run, ref_run):
    _, tr, _, before = port_run
    _, jtr, _, jbefore = ref_run
    assert before == jbefore
    assert tr.rearb_rounds == jtr.rearb_rounds
    assert _fabric(tr) == [dataclasses.asdict(link) for link in jtr.fabric.links]
    # the same draws, in the same order, from the same stream
    assert tr._rng.bit_generator.state == jtr._rng.bit_generator.state


def test_port_checkpoint_restores_in_reference(port_run):
    d, tr, state, _ = port_run
    jcfg = jsmoke(ARCH)
    abstract = jm.param_shapes(jcfg)
    params = jstore.restore(str(d), 6, abstract)
    opt = jstore.restore(str(d / "opt"), 6,
                         jax.eval_shape(lambda p: jadam.init(jadam.AdamWConfig(**OPT), p),
                                        abstract))
    assert isinstance(opt, jadam.OptState) and int(opt.step) == 6
    _equal_trees(state.params, params)
    _equal_trees(state.opt_state, opt)


def test_reference_checkpoint_resumes_in_port(ref_run, tmp_path):
    d, jtr, (jparams, jopt), _ = ref_run
    shutil.copytree(d, tmp_path / "ck")
    tr = _port_trainer(tmp_path / "ck")
    state = tr.init_state()
    assert state.step == 6 and isinstance(state.opt_state, adamw.OptState)
    _equal_trees(state.params, jparams)
    _equal_trees(state.opt_state, jopt)

    # resume the reference's step-3 checkpoint in the port for steps 4-6
    shutil.rmtree(tmp_path / "ck" / "step_00000006")
    shutil.rmtree(tmp_path / "ck" / "opt" / "step_00000006")
    tr = _port_trainer(tmp_path / "ck", ckpt_every=100, link_failure_prob_per_step=0.0)
    state = tr.init_state()
    assert state.step == 3
    data = TokenPipeline(DataConfig(vocab=tr.cfg.vocab, **DATA))
    try:
        batches = iter(data)
        for _ in range(3):
            next(batches)                      # the batches of steps 1-3
        state = tr.fit(state, batches)
    finally:
        data.close()
    assert state.step == 6
    lrs = [float(adamw.lr_at(tr.opt_cfg, s)) for s in (4, 5, 6)]
    for g, w in zip(tree_leaves(state.params), jax.tree.leaves(jparams)):
        assert float(np.abs(g.numpy() - w).max()) <= 2 * sum(lrs) + 1e-6
    losses = [m["loss"] for m in tr.metrics_log]
    want = [m["loss"] for m in jtr.metrics_log[3:]]
    np.testing.assert_allclose(losses, want, atol=2e-3)


def test_sigterm_saves_at_the_next_step_boundary(tmp_path):
    tr = _port_trainer(tmp_path, ckpt_every=100, link_failure_prob_per_step=0.0)
    data = TokenPipeline(DataConfig(vocab=tr.cfg.vocab, **DATA))
    before = signal.getsignal(signal.SIGTERM)

    def batches():
        for i, b in enumerate(iter(data)):
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    try:
        state = tr.fit(tr.init_state(), batches())
    finally:
        data.close()
    assert state.step == 2 and tr._emergency
    assert store.latest_step(tmp_path) == 2 and store.latest_step(tmp_path / "opt") == 2
    assert signal.getsignal(signal.SIGTERM) is before


def test_launch_train_main_on_cpu(tmp_path, capsys):
    state = launch_train.main(["--arch", "mamba2-130m", "--steps", "2", "--seq-len", "16",
                               "--global-batch", "2", "--microbatch", "2", "--ckpt",
                               str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert state.step == 2
    assert "arch=mamba2-130m-smoke" in out and "device=cpu" in out
    assert "optical fabric: 8 links" in out and "done at step 2" in out
    assert all(t.device.type == "cpu" for t in tree_leaves(state.params))
