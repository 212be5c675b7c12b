"""Fused RMSNorm: ``ref.py`` (plain PyTorch), ``kernel.py`` (the CUDA
kernel's binding), ``ops.py`` (dispatch by device)."""
