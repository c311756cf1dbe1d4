"""Launch helpers: the device meshes (``mesh``), the training launcher
(``train``), the reserved serving entry point (``serve``), the dry run
(``dryrun``) and its variant ladders (``perf``)."""
from .mesh import (  # noqa: F401
    SweepMesh,
    data_axes,
    make_host_mesh,
    make_production_mesh,
    make_sweep_mesh,
)
