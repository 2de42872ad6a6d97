"""Fused matmul chain ``ew(a @ w1) @ w2``: the Hopper kernel and its plain
version.

The counterpart of the ``fused_matmul_chain`` half of
``repro/kernels/streamfuse/chain.py``.  Same contract: a (M, K), w1
(K, N1), w2 (N1, N2) of one element type (float32 or bfloat16), float32
accumulation, output in a's type, the intermediate never written to
device memory.  ``ew`` is data, not a closure: a sequence of ``(kind,
attrs)`` pairs over the elementwise kinds in :data:`EW_CODES`, applied in
order — which is how it reaches the CUDA kernel (op codes plus scalar
attributes).

Tensors on the card launch ``csrc/chain.cu``: the fused kernel over an
(M/64, N1-chunks) grid writing float32 partials, then a reduction over the
chunks in fixed order (two launches per call, deterministic).  Tensors on
the CPU run :func:`matmul_chain_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

from ..common import (INT, INT64, PTR, SMEM_PER_BLOCK, CudaLibrary,
                      dtype_code, on_card, stream_of)

# op code of each elementwise kind csrc/chain.cu replays, and the attrs
# that fill its two float slots.
EW_CODES = {"identity": (0, ()), "relu": (1, ()), "gelu": (2, ()),
            "scale": (3, ("s",)), "affine": (4, ("a", "b")),
            "divc": (5, ("c",)), "rdivc": (6, ("c",))}
_ATTR_DEFAULTS = {"a": 1.0, "b": 0.0}
MAX_EW = 8

# Tile constants of csrc/chain.cu.
_BM, _BN, _BKK = 64, 128, 8
_TARGET_BLOCKS = 4 * 132          # four 4-warp blocks per SM of an H100

LIBRARY = CudaLibrary("chain.cu", {
    "codo_matmul_chain": [INT, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT,
                          INT, PTR, PTR, PTR, PTR],
    "codo_matmul_chain_reduce": [INT, PTR, PTR, INT, INT64, PTR],
})


def ew_codes(ew: Sequence[tuple[str, dict]]) -> tuple[list[int], list[float],
                                                       list[float]]:
    """(op codes, first attrs, second attrs) of an ``ew`` tail."""
    if len(ew) > MAX_EW:
        raise ValueError(f"the chain kernel replays at most {MAX_EW} "
                         f"elementwise ops, got {len(ew)}")
    ops, a, b = [], [], []
    for kind, attrs in ew:
        if kind not in EW_CODES:
            raise ValueError(f"elementwise kind {kind!r} is not one the chain "
                             f"kernel replays ({sorted(EW_CODES)})")
        code, names = EW_CODES[kind]
        vals = [float(attrs.get(n, _ATTR_DEFAULTS.get(n))) for n in names]
        vals += [0.0] * (2 - len(vals))
        ops.append(code)
        a.append(vals[0])
        b.append(vals[1])
    return ops, a, b


def apply_ew_plain(h, ew: Sequence[tuple[str, dict]]):
    """The tail in plain PyTorch ops, mirroring the op registry's bodies."""
    import torch
    for kind, attrs in ew:
        if kind == "relu":
            h = torch.relu(h)
        elif kind == "gelu":
            h = torch.nn.functional.gelu(h, approximate="tanh")
        elif kind == "scale":
            h = h * float(attrs["s"])
        elif kind == "affine":
            a, b = float(attrs.get("a", 1.0)), float(attrs.get("b", 0.0))
            h = (h if a == 1.0 else (-h if a == -1.0 else a * h)) + b
        elif kind == "divc":
            h = h / float(attrs["c"])
        elif kind == "rdivc":
            h = float(attrs["c"]) / h
        elif kind != "identity":
            raise ValueError(f"unknown elementwise kind {kind!r}")
    return h


def chunk_columns(M: int, N1: int) -> int:
    """Columns of h one block owns (a multiple of 128): enough N1 chunks
    that the grid reaches four blocks per SM, no more than needed, and a
    slice small enough that two blocks share an SM's shared memory."""
    n_m = -(-M // _BM)
    n_max = -(-N1 // _BN)
    chunks = min(n_max, max(1, -(-_TARGET_BLOCKS // n_m)))
    cols = -(-N1 // chunks)
    bn1 = _BN * -(-cols // _BN)
    while bn1 > _BN and smem_bytes(bn1) > SMEM_PER_BLOCK // 2:
        bn1 -= _BN
    return bn1


def smem_bytes(bn1: int) -> int:
    """The h slice plus two buffers each of the a and weight tiles."""
    return 4 * (_BM * bn1 + 2 * _BKK * _BM + 2 * _BKK * _BN)


def _check(a, w1, w2):
    import torch
    if a.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError("fused_matmul_chain wants 2-D a, w1, w2")
    if a.shape[1] != w1.shape[0] or w1.shape[1] != w2.shape[0]:
        raise ValueError(f"shapes do not chain: {tuple(a.shape)} @ "
                         f"{tuple(w1.shape)} @ {tuple(w2.shape)}")
    if not (a.dtype == w1.dtype == w2.dtype) or a.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"a/w1/w2 must share float32 or bfloat16, got "
                        f"{a.dtype}, {w1.dtype}, {w2.dtype}")


def fused_matmul_chain(a, w1, w2, *, ew: Sequence[tuple[str, dict]] = ()):
    """``ew(a @ w1) @ w2`` as one fused kernel plus a deterministic
    reduction (tensors on the card), or its plain version (on the CPU)."""
    import torch
    _check(a, w1, w2)
    if not on_card(a, w1, w2):
        return matmul_chain_plain(a, w1, w2, ew=ew)
    ops, ea, eb = ew_codes(ew)
    if not (a.is_contiguous() and w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError("fused_matmul_chain reads row-major a/w1/w2; got "
                         f"strides {a.stride()}, {w1.stride()}, {w2.stride()}")
    M, K = a.shape
    N1, N2 = w2.shape
    bn1 = chunk_columns(M, N1)
    chunks = -(-N1 // bn1)
    partial = torch.empty((chunks, M, N2), dtype=torch.float32,
                          device=a.device)
    out = torch.empty((M, N2), dtype=a.dtype, device=a.device)
    n = max(len(ops), 1)
    c_ops = (ctypes.c_int * n)(*ops)
    c_a = (ctypes.c_float * n)(*ea)
    c_b = (ctypes.c_float * n)(*eb)
    code, stream = dtype_code(a), stream_of(a)
    with torch.cuda.device(a.device):
        LIBRARY.launch("codo_matmul_chain", code, a.data_ptr(), w1.data_ptr(),
                       w2.data_ptr(), partial.data_ptr(), M, K, N1, N2, bn1,
                       len(ops), c_ops, c_a, c_b, stream)
        LIBRARY.launch("codo_matmul_chain_reduce", code, partial.data_ptr(),
                       out.data_ptr(), chunks, M * N2, stream)
    return out


def matmul_chain_plain(a, w1, w2, *, ew: Sequence[tuple[str, dict]] = ()):
    """The kernel's function in plain PyTorch ops, float32 throughout."""
    _check(a, w1, w2)
    h = apply_ew_plain(a.float() @ w1.float(), ew)
    return (h @ w2.float()).to(a.dtype)


__all__ = ["EW_CODES", "LIBRARY", "apply_ew_plain", "chunk_columns",
           "ew_codes", "fused_matmul_chain", "matmul_chain_plain"]
