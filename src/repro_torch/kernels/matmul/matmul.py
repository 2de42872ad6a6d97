"""The blocked matmul: the Hopper kernel and its plain version.

The counterpart of ``repro/kernels/matmul/matmul.py`` — the paper's
reduction rewriting (Fig. 5): each output tile's float32 accumulator
stays on chip across the whole contraction and is written once, after
the last k step.  :func:`matmul` keeps the TPU function's contract — a
(M, K), b (K, N) of one element type (float32 or bfloat16), float32
accumulation, output in a's type — and drops its divisibility assert:
ragged edges are masked.

Tensors on the card launch ``csrc/matmul.cu`` (one launch a call: 128 ×
128 output tiles on the tensor cores, mma.sync 3×TF32 in float32, the
accumulator in registers until it is written); tensors on the CPU run
:func:`matmul_plain`.
"""

from __future__ import annotations

from ..common import (INT, META, PTR, CudaLibrary, dtype_code, meta_result,
                      on_card, stream_of)

# Output tile of csrc/matmul.cu (csrc/mma_gemm.cuh's 128 × 128 tile).
BM, BN = 128, 128

LIBRARY = CudaLibrary("matmul.cu", {
    "codo_matmul": [INT, PTR, PTR, PTR, INT, INT, INT, PTR],
})


def matmul_grid(M: int, N: int) -> tuple[int, int]:
    """The kernel's grid, (column tiles, row tiles): one block a BM × BN
    output tile, the last row and column of tiles masked."""
    return -(-N // BN), -(-M // BM)


def _check(a, b):
    import torch
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul wants a (M, K) and b (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a/b must share float32 or bfloat16, got {a.dtype}, "
                        f"{b.dtype}")


def matmul(a, b):
    """a (M, K) @ b (K, N) in a's type: the kernel on the card, the plain
    version on the CPU."""
    import torch
    _check(a, b)
    where = on_card(a, b)
    if where is META:
        return meta_result((a.shape[0], b.shape[1]), a.dtype, (a, b),
                           flops=2.0 * a.shape[0] * a.shape[1] * b.shape[1])
    if not where:
        return matmul_plain(a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul reads row-major a and b")
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        LIBRARY.launch("codo_matmul", dtype_code(a), a.data_ptr(),
                       b.data_ptr(), out.data_ptr(), M, N, K, stream_of(a))
    return out


def matmul_plain(a, b):
    """The kernel's function in plain PyTorch ops, float32 throughout."""
    _check(a, b)
    return (a.float() @ b.float()).to(a.dtype)


__all__ = ["BM", "BN", "LIBRARY", "matmul", "matmul_grid", "matmul_plain"]
