"""Plain PyTorch oracle for the blocked matmul kernel (the counterpart of
``repro/kernels/matmul/ref.py``)."""


def matmul_ref(a, b):
    import torch
    return torch.matmul(a.float(), b.float()).to(a.dtype)
