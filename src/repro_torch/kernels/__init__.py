"""Hand-written Hopper kernels, one package each: ``ref.py`` (plain
PyTorch), ``kernel.py`` (CUDA binding), ``ops.py`` (dispatch by device)."""
import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when autograd would record through ``kernel``.  The CUDA kernels
    compute forward passes only: their outputs have no ``grad_fn``, so a
    graph through them would be cut without a word.  Run them under
    ``torch.no_grad()`` or ``torch.inference_mode()``; the plain versions
    that ``ops.py`` runs on the CPU differentiate."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel has no backward: call it under "
            f"torch.no_grad() or torch.inference_mode(), or on the CPU")
