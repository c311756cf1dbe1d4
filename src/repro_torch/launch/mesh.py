"""The 1-D device mesh of the multi-device paths.

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
