"""PyTorch port of the wavelength-arbitration simulator (``repro``).

The modules mirror ``repro``'s layout and names.  Tensors follow the
reference layouts: core data is (T, N) or (T, N, E) with trials first.
Entry points run on CUDA unless the caller asks for ``device="cpu"``; the
hand-written CUDA kernels (``kernels.feasibility``, ``kernels.table_build``,
the ``match`` and ``bottleneck`` kernels of ``kernels.bitmask_match`` and the
``probe`` kernel of ``kernels.probe``) launch for CUDA tensors, and their
plain PyTorch versions run for CPU tensors.  The protocol engine
(``core.protocol``) carries the ``protocol_*`` schemes and temporal
re-arbitration (``core.temporal.run_timeline``).
"""

# The core package first: its sweep exports import the kernel wrappers, and
# the wrappers import core helpers, so core must start initializing first.
from . import core  # noqa: E402,F401
