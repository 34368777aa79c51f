"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

Layout per kernel family (mirroring ``repro/kernels``): ``kernel.py`` binds
and launches the CUDA kernel (``csrc/``), ``ref.py`` holds the plain PyTorch
version, ``ops.py`` is the public wrapper — the plain version for a tensor
on the CPU, the kernel for a tensor on a CUDA device.
"""
