"""PyTorch port of the wavelength-arbitration simulator (``repro``).

The modules mirror ``repro``'s layout and names.  Tensors follow the
reference layouts: core data is (T, N) or (T, N, E) with trials first.
Entry points run on CUDA unless the caller asks for ``device="cpu"``; the
hand-written CUDA kernels (``kernels.feasibility``, ``kernels.table_build``
and the ``match`` and ``bottleneck`` kernels of ``kernels.bitmask_match``)
launch for CUDA tensors, and their plain PyTorch versions run for CPU
tensors.
"""
