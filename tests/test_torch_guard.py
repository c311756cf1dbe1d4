"""Guards of the PyTorch port (``repro_torch``): its import boundary, its
device rule, its kernel wrappers' refusal to fall back, and its build flags."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.wdm import WDM8_G200  # noqa: E402
from repro_torch.convert import units_from_numpy  # noqa: E402
from repro_torch.core import api, ideal  # noqa: E402
from repro_torch.core.sampling import SystemBatch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bitmask_match import (  # noqa: E402
    bottleneck_threshold,
    perfect_matching,
)
from repro_torch.kernels.feasibility import feasibility  # noqa: E402
from repro_torch.kernels.probe import masked_research  # noqa: E402
from repro_torch.kernels.table_build import build_tables  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.core.api, repro_torch.convert, repro_torch.configs.wdm\n"
        "import repro_torch.kernels._build, repro_torch.kernels.probe\n"
        "import repro_torch.core.protocol, repro_torch.core.temporal\n"
        "import repro_torch.core.sweep, repro_torch.core.prng\n"
        "import repro_torch.fabric, repro_torch.configs.fabric\n"
        "import repro_torch.checkpoint.store, repro_torch.optics\n"
        "import repro_torch.obs, repro_torch.obs.taxonomy, repro_torch.obs.manifest\n"
        "import repro_torch.obs.report, repro_torch.obs.smoke\n"
        "import repro_torch.launch, repro_torch.launch.mesh, repro_torch.configs\n"
        "import repro_torch.models.model, repro_torch.configs.archs, repro_torch.launch.serve\n"
        "import repro_torch.optim.adamw, repro_torch.optim.compression, repro_torch.tree\n"
        "import repro_torch.distributed.steps, repro_torch.data.pipeline\n"
        "import repro_torch.runtime.trainer, repro_torch.launch.train\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)", re.M)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_or_repro(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.make_units(WDM8_G200, 0, 2, 2)
    arrays = [np.zeros((2, 1), np.float32)] + [np.zeros((2, 8), np.float32)] * 4
    with pytest.raises(RuntimeError, match="CUDA"):
        units_from_numpy(*arrays)
    units = api.make_units(WDM8_G200, 0, 2, 2, device="cpu")
    assert all(u.device.type == "cpu" for u in units)
    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import model

    cfg = get_smoke("mamba2-130m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_numpy({"embed": np.zeros((4, 2), np.float32)})
    params = model.init_params(0, cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert lm_params_from_numpy({"a": [np.ones(2)]}, "cpu")["a"][0].device.type == "cpu"


def test_moe_a2a_waits_for_the_distribution_slice():
    """``moe_impl="a2a"`` (the reference's all-to-all dispatch, ported with
    the distribution slice) falls back to the gather MoE exactly where the
    reference does, outside a mesh context; under one it never falls back
    quietly: plain tensors, which have no mesh to split over, raise."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.distributed import ctx, sharding
    from repro_torch.models import layers, model

    assert hasattr(layers, "moe_ffn_a2a")
    cfg = dataclasses.replace(get_smoke("qwen3-moe-235b-a22b"), moe_impl="a2a")
    params = model.init_params(0, cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    gather = dataclasses.replace(cfg, moe_impl="gather")
    batch = {"tokens": tokens, "labels": tokens}
    assert torch.equal(model.loss_fn(params, cfg, batch)[0],
                       model.loss_fn(params, gather, batch)[0])
    assert torch.equal(model.prefill(params, cfg, tokens, 8)[0],
                       model.prefill(params, gather, tokens, 8)[0])
    with ctx.activation_axes(sharding.AbstractMesh((1, 2), ("data", "model"))):
        with pytest.raises(ValueError, match="DTensor"):
            model.loss_fn(params, cfg, batch)


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``Trainer`` without a device, ``launch.train`` without ``--device``,
    ``init_state`` and ``init_feedback`` of abstract shapes run on CUDA
    unless the caller names the CPU; there is no quiet fallback."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import steps
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim import adamw, compression
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_smoke("mamba2-130m")
    opt = adamw.AdamWConfig()
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path))
    step = steps.make_train_step(cfg, opt, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    late = Trainer(cfg, tcfg, opt, None, step, None, None)
    assert late.device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, tcfg, opt, None, step, None, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "mamba2-130m", "--steps", "1", "--ckpt", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        late.init_state()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compression.init_feedback(model.param_shapes(cfg))
    assert not any(tmp_path.iterdir())
    on_cpu = Trainer(cfg, tcfg, opt, "cpu", step, None, None)
    assert on_cpu.init_state().params["embed"].device.type == "cpu"


def test_shardings_wait_for_the_distribution_slice(tmp_path):
    """Parameter or optimizer shardings place tensors on a ``DeviceMesh``
    (the distribution slice): given with a device instead of a mesh they
    raise; the trainer never ignores them."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import steps
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_smoke("mamba2-130m")
    opt = adamw.AdamWConfig()
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path))
    step = steps.make_train_step(cfg, opt, 1)
    for shardings in (({"embed": "cpu"}, None), (None, {"mu": "cpu"})):
        with pytest.raises(ValueError, match="DeviceMesh"):
            Trainer(cfg, tcfg, opt, "cpu", step, *shardings)


def test_runtime_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The interconnect's bring-up, its handle-less re-arbitration and a
    campaign's restore run on CUDA unless the caller names the CPU."""
    from repro_torch.core import temporal
    from repro_torch.optics import interconnect

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interconnect.bringup(2, 1, WDM8_G200, tr_mean=4.6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interconnect.expected_failure_rates(WDM8_G200, 4.6, n=2)
    fab = interconnect.bringup(2, 1, WDM8_G200, tr_mean=4.6, device="cpu")
    assert fab.handle.system.laser.device.type == "cpu"
    legacy = interconnect.FabricState(
        links=[interconnect.LinkHealth(0, 1, 0, 8, 7, 0, "zero_lock")],
        scheme="vtrs_ssm", tr_mean=4.6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interconnect.rearbitrate(legacy, WDM8_G200)
    temporal.save_campaign(tmp_path, 1, fab.handle.state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        temporal.restore_campaign(tmp_path, 2, 8)
    step, state = temporal.restore_campaign(tmp_path, 2, 8, device="cpu")
    assert step == 1 and torch.equal(state.lock, fab.handle.state.lock)


def test_warm_repair_never_takes_a_plain_version():
    """Off the CPU, the interconnect's warm repair reaches the kernel
    wrappers, which launch or raise: there is no fallback."""
    from repro_torch.core.protocol import cold_state
    from repro_torch.optics.interconnect import _warm_repair

    build_tables.launches = masked_research.launches = 0
    sys_ = SystemBatch(*(torch.empty((4, 8), device="meta") for _ in range(4)))
    state = cold_state(4, 8, "meta")
    for visible in (None, torch.ones((4, 8), dtype=torch.bool, device="meta")):
        with pytest.raises(ValueError, match="CUDA"):
            _warm_repair(WDM8_G200, sys_, 4.6, state, visible)
    assert build_tables.launches == 0 and masked_research.launches == 0


def test_make_units_same_seed_same_units():
    a = api.make_units(WDM8_G200, 11, 3, 4, device="cpu")
    b = api.make_units(WDM8_G200, 11, 3, 4, device="cpu")
    c = api.make_units(WDM8_G200, 12, 3, 4, device="cpu")
    assert [tuple(u.shape) for u in a] == [(3, 1), (3, 8), (4, 8), (4, 8), (4, 8)]
    for x, y in zip(a, b):
        assert x.dtype == torch.float32 and torch.equal(x, y)
        assert float(x.abs().max()) <= 1.0
    assert not torch.equal(a.u_llv, c.u_llv)


def test_kernel_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is not on the CPU never reaches a plain version."""
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        feasibility(x, x, x, x, np.arange(8))
    with pytest.raises(ValueError, match="CUDA"):
        build_tables(x, x, x, x, max_alias=8, max_entries=24)
    with pytest.raises(ValueError, match="CUDA"):
        perfect_matching(torch.empty((4, 8), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        bottleneck_threshold(torch.empty((4, 8, 8), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        masked_research(torch.empty((4, 1, 24), dtype=torch.int32, device="meta"),
                        torch.empty((4, 8), dtype=torch.bool, device="meta"),
                        torch.empty((4, 1), dtype=torch.int32, device="meta"))
    from repro_torch.kernels.threefry import UNIFORM, threefry_draw

    with pytest.raises(ValueError, match="CUDA"):
        threefry_draw(torch.empty((4, 8), device="meta"), np.zeros(2, np.uint32), (4, 8),
                      mode=UNIFORM)
    assert feasibility.launches == 0 and build_tables.launches == 0
    assert perfect_matching.launches == 0 and bottleneck_threshold.launches == 0
    assert masked_research.launches == 0 and threefry_draw.launches == 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_matching_wrappers_refuse_more_than_64_lines(device):
    """N = 65 lines do not fit the kernels' one 64-bit word per ring."""
    with pytest.raises(ValueError, match=r"N must be in \[1, 64\]"):
        perfect_matching(torch.zeros((2, 65), dtype=torch.int64, device=device))
    with pytest.raises(ValueError, match=r"N must be in \[1, 64\]"):
        bottleneck_threshold(torch.zeros((2, 65, 65), device=device))
    assert perfect_matching.launches == 0 and bottleneck_threshold.launches == 0


def test_nvcc_command_line_targets_hopper_without_contraction():
    cmds = _build.compile_commands("nvcc", Path("out"))
    assert len(cmds) == len(_build.SOURCES) == 6
    for cmd in cmds + [_build.link_command("nvcc", Path("out"))]:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    for cmd in cmds:
        assert "--fmad=false" in cmd and "-prec-div=true" in cmd
    assert all((_build.CSRC / s).is_file() for s in _build.SOURCES)


def test_build_without_nvcc_raises_clearly(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


@pytest.mark.parametrize("name,policy,params", [
    ("seq_retry", "lta", {}), ("seq_retry_r2", "lta", {"n_rounds": 2}),
    ("protocol_lta", "lta", {}), ("protocol_ltd", "ltd", {}),
    ("protocol_lta_h2", "lta", {"depth": 2}),
])
def test_later_slice_schemes_raise_with_their_slice(name, policy, params):
    """Every scheme of the reference is registered now, with the
    reference's conditioning policy and parameters; none raises."""
    spec = api.scheme_spec(name)
    assert spec.policy == policy
    assert dict(spec.params) == params


def test_protocol_trace_waits_for_the_observability_slice():
    """The observability slice has landed: ``trace=`` appends an empty
    recorder on its tables' device where no ring has a peak to search."""
    from repro_torch.core.protocol import run_protocol
    from repro_torch.core.relation import chain_spec
    from repro_torch.core.search_table import SearchTables

    tables = SearchTables(delta=torch.zeros((1, 2, 6)),
                          wl=torch.full((1, 2, 6), -1, dtype=torch.int32),
                          n_valid=torch.zeros((1, 2), dtype=torch.int32))
    assign, buf = run_protocol(tables, chain_spec(np.arange(2)), trace=32)
    assert assign.wl.tolist() == [[-1, -1]]
    assert buf.ev.shape == (1, 32, 4) and buf.ev.device.type == "cpu"
    assert int(buf.n.sum()) == 0 and int(buf.counts.sum()) == 0


def test_unknown_scheme_and_lta_policy():
    with pytest.raises(ValueError, match="unknown scheme"):
        api.scheme_spec("nope")
    sys_ = SystemBatch(*(torch.ones((2, 4)) for _ in range(4)))
    lta = ideal.min_tr(sys_, "lta", np.arange(4))
    assert lta.shape == (2,) and lta.dtype == torch.float32
    assert api.registered_schemes() == (
        "seq", "rs_ssm", "vtrs_ssm", "seq_retry", "seq_retry_r1",
        "seq_retry_r2", "seq_retry_r4", "seq_retry_phys", "protocol_lta",
        "protocol_lta_h1", "protocol_lta_h2", "protocol_lta_h4", "protocol_ltd")


def test_scheme_registry_family_and_duplicates():
    seq = api.scheme_spec("seq").arbiter
    specs = api.register_scheme_family(
        "guardfam", lambda k: seq, {"a": {"k": 1}, "b": {"k": 2}})
    try:
        assert [s.name for s in specs] == ["guardfam_a", "guardfam_b"]
        assert specs[1].params == (("k", 2),)
        with pytest.raises(ValueError, match="already registered"):
            api.register_scheme("guardfam_a", seq)
        with pytest.raises(ValueError, match="policy"):
            api.register_scheme("guardfam_c", seq, policy="bogus")
    finally:
        for s in specs:
            api._SCHEME_REGISTRY.pop(s.name)
