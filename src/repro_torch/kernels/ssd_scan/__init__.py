"""Mamba2 SSD chunked scan: ``ref.py`` (the O(S) recurrence), ``kernel.py``
(the CUDA kernel's binding), ``ops.py`` (dispatch by device)."""
