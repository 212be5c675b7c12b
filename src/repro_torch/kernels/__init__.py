"""Hand-written Hopper kernels, one package each: ``ref.py`` (plain
PyTorch), ``kernel.py`` (CUDA binding), ``ops.py`` (dispatch by device)."""
