"""Streaming flash attention: the Hopper kernel and its plain version.

The counterpart of ``repro/kernels/flashattn/flashattn.py``.
:func:`flash_attention` keeps the TPU function's contract — q (B, Hq, Sq,
hd), k/v (B, Hkv, Sk, hd), GQA by ``h // (Hq / Hkv)``, causal and
sliding-window masks at −1e30, output ``acc / max(l, 1e-30)`` in q's type,
float32 accumulation — and adds ``scale`` (default ``1/sqrt(hd)``) so a
routed chain passes its own constant instead of pre-scaling q.  Operands
may be strided views; nothing is copied.

Tensors on the card launch ``csrc/flashattn.cu``: the attention kernel
over (query tiles, heads, key splits), then a kernel that combines the
splits in a fixed order (two launches per call).  Tensors on the CPU run
:func:`flash_attention_plain`, the same arithmetic in plain PyTorch ops.
"""

from __future__ import annotations

import ctypes
import math

from ..common import (FLOAT, INT, PTR, CudaLibrary, dtype_code, on_card,
                      smem_ok, stream_of)

NEG_INF = -1e30

# Tile constants of csrc/flashattn.cu.
_BQ, _BK, _DK, _KPAD, _BKV = 16, 64, 64, 68, 8
_MAX_HD = 1024                    # 16 accumulator columns a thread
_TARGET_BLOCKS = 2 * 132          # two blocks per SM of an H100

LIBRARY = CudaLibrary("flashattn.cu", {
    "codo_flash_attention": [INT, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                             INT, INT, PTR, FLOAT, INT, INT, INT, INT, PTR],
    "codo_flash_combine": [INT, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR,
                           PTR],
})


def smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one block: the q tile (BQ × hd padded to
    64), the K or V chunk, the probability tile and the row corrections."""
    hdp = -(-hd // _DK) * _DK
    return 4 * (_BQ * hdp + max(_BK * _KPAD, _BKV * hdp) + _BQ * _BK + _BQ)


def tiling_ok(hd: int) -> bool:
    """Whether the kernel's tiling exists for head dim ``hd``."""
    return hd <= _MAX_HD and smem_ok(smem_bytes(hd))


def key_splits(Sq: int, Sk: int, BH: int) -> tuple[int, int]:
    """(splits, tiles per split) of the key axis: enough splits that the
    grid reaches two blocks per SM, no more than there are key tiles."""
    tiles = -(-Sk // _BK)
    blocks = -(-Sq // _BQ) * BH
    splits = min(tiles, max(1, -(-_TARGET_BLOCKS // blocks)))
    per = -(-tiles // splits)
    return -(-tiles // per), per


def _check(q, k, v):
    import torch
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants 4-D q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v must be (B={B}, Hkv, Sk, hd={hd}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd).  Returns (B, Hq, Sq, hd)."""
    import torch
    _check(q, k, v)
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    if not on_card(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if not tiling_ok(hd):
        raise ValueError(f"flash_attention takes hd <= {_MAX_HD}, got {hd}")
    splits, per = key_splits(Sq, Sk, B * Hq)
    part_o = torch.empty((splits, B * Hq, Sq, hd), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((splits, B * Hq, Sq, 2), dtype=torch.float32,
                          device=q.device)
    o = torch.empty((B, Hq, Sq, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    o_strides = (ctypes.c_longlong * 4)(*o.stride())
    code, stream = dtype_code(q), stream_of(q)
    with torch.cuda.device(q.device):
        LIBRARY.launch("codo_flash_attention", code, q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), part_o.data_ptr(),
                       part_ml.data_ptr(), B, Hq, Hkv, Sq, Sk, hd, strides,
                       scale, int(bool(causal)), int(window), splits, per,
                       stream)
        LIBRARY.launch("codo_flash_combine", code, part_o.data_ptr(),
                       part_ml.data_ptr(), o.data_ptr(), splits, B * Hq, Hq,
                       Sq, hd, o_strides, stream)
    return o


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None):
    """The kernel's function in plain PyTorch ops: whole-row softmax in
    float32 with the kernel's masking and denominator guard."""
    import torch
    _check(q, k, v)
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    G = Hq // Hkv
    kf, vf = k.float(), v.float()
    if G > 1:
        kf, vf = kf.repeat_interleave(G, dim=1), vf.repeat_interleave(G, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) * scale
    if causal or window:
        qp = torch.arange(Sq, device=q.device)[:, None]
        kp = torch.arange(Sk, device=q.device)[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qp >= kp
        if window:
            mask &= (qp - kp) < window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = (p @ vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.to(q.dtype)
