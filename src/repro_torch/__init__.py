"""repro_torch — the GGArray port to PyTorch and CUDA (Hopper, sm_90a).

Mirrors the JAX package ``repro`` module for module: ``repro/core/ggarray.py``
becomes ``repro_torch/core/ggarray.py`` and so on.  Plain tensor code is
PyTorch; every Pallas kernel on the ported path is a hand-written CUDA C++
kernel under ``csrc/``, built by ``nvcc`` at its first launch
(``kernels/_build.py``).  Importing this package never builds or loads a
kernel, and it imports neither ``jax`` nor ``repro``.

Entry points (``runtime.TwoPhasePipeline``, ``core.ggarray.init``) run on
``cuda`` unless the caller passes ``device="cpu"``; without a card and without
``device="cpu"`` they raise (``device.resolve``).
"""

__version__ = "0.1.0"
