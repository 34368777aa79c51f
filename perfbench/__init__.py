"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one
command, ``python3 perfbench/run.py``, driven by ``BENCHMARK.json`` and the
data files beside it.  Nothing here imports JAX or the JAX package."""
