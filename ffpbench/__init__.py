"""ffpbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell (a configuration under a traffic mix) for one
run; see ``README.md``.  Nothing here imports JAX or the JAX package.
"""
