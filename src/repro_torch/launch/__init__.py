"""Launch helpers: the 1-D device mesh of the multi-device sweeps (``mesh``)
and the reserved serving entry point (``serve``)."""
from .mesh import SweepMesh, make_sweep_mesh  # noqa: F401
