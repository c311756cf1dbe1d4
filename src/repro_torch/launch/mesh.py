"""Device meshes: the 2-D (or 3-D) ``DeviceMesh``es of the LM stack and the
1-D mesh of the sweep paths.

``make_production_mesh`` and ``make_host_mesh`` are the reference's
``jax.make_mesh`` meshes as ``torch.distributed.device_mesh.DeviceMesh``es
with its axis names and shapes.  They use the default process group the
caller set up (``torch.distributed.init_process_group``: NCCL across cards,
``gloo`` across CPU processes, or the ``"fake"`` backend of the dry run):
no function here creates one, and one that does not fit raises.  Their
``device_type`` is ``"cuda"`` unless the caller names ``"cpu"``; without a
card ``"cuda"`` raises (a dry run's plan of redistributions depends on it).

The 1-D sweep mesh:

``sweep(SweepRequest(mesh=...))``, fabric ``bringup(mesh=...)`` and
``run_fabric_timeline(mesh=...)`` split their chunk axis over a ``SweepMesh``
(``core.sweep.chunked_map``): device d takes a contiguous block of whole
chunks, so the results are bit-identical to the unsharded path for every
mesh size.  A split across distinct cards has not been run or measured yet:
it has only been checked with placeholder meshes that repeat one device
(ROADMAP queue 2), so no throughput gain from more cards is claimed.

``make_sweep_mesh`` takes real CUDA devices.  A ``SweepMesh`` itself accepts
any sequence of devices, repeats included, as placeholders: ``SweepMesh((
torch.device("cuda:0"),) * 3)`` splits the chunks three ways on one card, and
``SweepMesh(("cpu",) * 4)`` four ways on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from ..core.sampling import resolve_device


@dataclasses.dataclass(frozen=True)
class SweepMesh:
    """Devices along the one mesh axis ``("sweep",)``, the chunk axis: the
    counterpart of a 1-D ``jax.sharding.Mesh``.  The axis names are fixed;
    ``check_mesh`` refuses a mesh-like object that names more."""

    devices: tuple
    axis_names: ClassVar[tuple] = ("sweep",)

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)


def _world() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs a process group: call "
            "torch.distributed.init_process_group first (the dry run "
            "initialises a 'fake' one of 256 or 512 ranks)")
    return dist.get_world_size()


def _device_type(device_type: str) -> str:
    """``device_type`` as given: ``"cuda"`` (the default of every mesh here)
    raises without a card, and nothing falls back to the CPU unless the
    caller names ``"cpu"``."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' needs a CUDA card; pass device_type='cpu' "
                           "for a CPU mesh")
    return device_type


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks), axes
    ("data", "model") or ("pod", "data", "model").

    When the world holds more ranks than the mesh needs (a 512-rank dry run
    building a single-pod mesh), the leading ranks are used; fewer raise.
    """
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = _world()
    dev = _device_type(device_type)
    if world == n:
        return init_device_mesh(dev, shape, mesh_dim_names=axes)
    if world > n:
        return DeviceMesh(dev, torch.arange(n).reshape(shape), mesh_dim_names=axes)
    raise RuntimeError(
        f"need {n} ranks for mesh {shape}, have {world} — run under "
        "repro_torch.launch.dryrun (a 'fake' world of 512 ranks)"
    )


def make_host_mesh(model_parallel: int = 1, *, device_type: str = "cuda"):
    """(world / model_parallel, model_parallel) mesh, axes ("data", "model"),
    over every rank of the process group (tests, examples, one card)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _world()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel={model_parallel}")
    return init_device_mesh(_device_type(device_type), (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh) -> tuple:
    """Mesh axes that shard the batch (pod + data when present)."""
    from ..distributed.ctx import mesh_axis_names

    return ("pod", "data") if "pod" in mesh_axis_names(mesh) else ("data",)


def make_sweep_mesh(n_devices: int | None = None) -> SweepMesh:
    """1-D ``("sweep",)`` mesh over the leading ``n_devices`` CUDA devices
    (all of them by default).  Raises without CUDA, and when fewer devices
    exist; it never gives a CPU mesh (build a ``SweepMesh`` for that)."""
    resolve_device()  # raises without CUDA
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise RuntimeError(f"need {n} devices for a sweep mesh, have {count}")
    if n < 1:
        raise ValueError(f"a sweep mesh needs at least one device, got {n}")
    return SweepMesh(tuple(torch.device("cuda", i) for i in range(n)))


def check_mesh(mesh) -> SweepMesh | None:
    """``mesh`` if it is a ``SweepMesh`` (or None).  A mesh-like object
    that names other axes (a 2-D ``jax.sharding.Mesh``, say) gets the
    reference's ``ValueError``; anything else a ``TypeError``."""
    if mesh is None or isinstance(mesh, SweepMesh):
        return mesh
    axes = tuple(getattr(mesh, "axis_names", ()))
    if len(axes) > 1:
        raise ValueError(f"sweep meshes are 1-D (the chunk axis); got axes {axes}")
    raise TypeError(
        f"mesh must be a SweepMesh (repro_torch.launch.make_sweep_mesh), "
        f"got {type(mesh).__name__}")
