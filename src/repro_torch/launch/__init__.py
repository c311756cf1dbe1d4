"""Launch helpers: the 1-D device mesh of the multi-device sweeps (``mesh``)."""
from .mesh import SweepMesh, make_sweep_mesh  # noqa: F401
