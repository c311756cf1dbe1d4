"""PyTorch port of the wavelength-arbitration simulator (``repro``).

The modules mirror ``repro``'s layout and names.  Tensors follow the
reference layouts: core data is (T, N) or (T, N, E) with trials first.
Entry points run on CUDA unless the caller asks for ``device="cpu"``; the
two hand-written CUDA kernels (``kernels.feasibility`` and
``kernels.table_build``) launch for CUDA tensors, and their plain PyTorch
versions run for CPU tensors.
"""
