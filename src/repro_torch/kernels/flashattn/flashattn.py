"""Streaming flash attention: the Hopper kernel and its plain version.

The counterpart of ``repro/kernels/flashattn/flashattn.py``.
:func:`flash_attention` keeps the TPU function's contract — q (B, Hq, Sq,
hd), k/v (B, Hkv, Sk, hd), GQA by ``h // (Hq / Hkv)``, causal and
sliding-window masks at −1e30, output ``acc / max(l, 1e-30)`` in q's type,
float32 accumulation — and adds ``scale`` (default ``1/sqrt(hd)``) so a
routed chain passes its own constant instead of pre-scaling q.  Operands
may be strided views; nothing is copied.

Tensors on the card launch ``csrc/flashattn.cu``: the attention kernel
over (query tiles of 64 rows × cluster ranks, heads, key splits) on TF32
tensor cores (3×TF32 for float32), whose blocks split hd above 256 across
a cluster of ceil(hd / 256); with one key split it writes the output (one
launch), else a second kernel combines the splits in a fixed order (two
launches, :func:`flash_launches`).  Tensors on the CPU run
:func:`flash_attention_plain`, the same arithmetic in plain PyTorch ops.
"""

from __future__ import annotations

import ctypes
import functools
import math

from ..common import (FLOAT, INT, META, NUM_SMS, PTR, SMEM_PER_SM,
                      CudaLibrary, dtype_code, meta_result, on_card, smem_ok,
                      stream_of)

NEG_INF = -1e30

# Tile constants of csrc/flashattn.cu: 64 query rows and 64-key tiles a
# block; the head-dim columns a block holds, the least of these that
# covers hd, and above 256 a cluster of ceil(hd / 256) blocks.
_MQ, _MK = 64, 64
_HEAD_COLUMNS = (32, 64, 128, 256)
_MAX_HD = 1024
_XCH = 4 * 8 * 32 * 4             # floats of the score tile a cluster sums

LIBRARY = CudaLibrary("flashattn.cu", {
    "codo_flash_attention": [INT, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT,
                             INT, INT, INT, INT, INT, PTR, FLOAT, INT, INT,
                             INT, INT, PTR],
    "codo_flash_combine": [INT, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR,
                           PTR],
})


def head_columns(hd: int) -> int:
    """Head-dim columns one block holds (32, 64, 128 or 256)."""
    return next((n for n in _HEAD_COLUMNS if hd <= n), _HEAD_COLUMNS[-1])


def cluster_size(hd: int) -> int:
    """Blocks sharing one q tile: 1 up to hd = 256, else ceil(hd / 256),
    each with 256 head-dim columns."""
    return -(-hd // _HEAD_COLUMNS[-1])


def tile_strides(hd: int, itemsize: int = 4) -> tuple[int, int]:
    """Shared-memory row strides (elements) of csrc/flashattn.cu's tiles:
    the q, K and V tiles row by row, and a K tile stored by d; each row 16
    bytes longer than its data, so every row starts 16-byte aligned for
    cp.async."""
    pad = 16 // itemsize
    return head_columns(hd) + pad, _MK + pad


def smem_bytes(hd: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one block: the q tile and two K/V tile
    buffers (a buffer also holds a K tile stored by d), and at 256 columns
    the score tile the cluster exchanges."""
    n = head_columns(hd)
    ld, kt_ld = tile_strides(hd, itemsize)
    buf = max(_MQ * ld, n * kt_ld)
    xch = 4 * _XCH if n == 256 else 0
    return itemsize * (_MQ * ld + 2 * buf) + xch


@functools.lru_cache(maxsize=None)
def tiling_ok(hd: int) -> bool:
    """Whether the kernel's tiling exists for head dim ``hd``."""
    return 0 < hd <= _MAX_HD and smem_ok(smem_bytes(hd))


@functools.lru_cache(maxsize=1024)
def key_splits(Sq: int, Sk: int, BH: int, hd: int) -> tuple[int, int]:
    """(splits, tiles per split) of the key axis.  One split when the grid
    fills the card's resident blocks; else the split count, at most the
    key tiles, that takes the fewest rounds of resident blocks times the
    tiles a block walks plus one for its set-up (the fewest splits among
    equals).  A cluster of c blocks needs c SMs of one GPC, so clusters
    fill about 7/8 of the card."""
    tiles = -(-Sk // _MK)
    c = cluster_size(hd)
    groups = -(-Sq // _MQ) * BH                 # blocks, or clusters of c
    per_sm = max(1, min(4, SMEM_PER_SM // (smem_bytes(hd) + 1024)))
    slots = per_sm * NUM_SMS // c
    if c > 1:
        slots = slots * 7 // 8
    if groups >= slots:
        return 1, tiles
    best = None
    for want in range(1, tiles + 1):
        per = -(-tiles // want)
        splits = -(-tiles // per)
        cost = -(-groups * splits // slots) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def flash_launches(Sq: int, Sk: int, BH: int, hd: int) -> int:
    """Kernel launches of one :func:`flash_attention` call: the attention
    kernel alone with one key split (it writes the output), else with the
    combine."""
    return 1 if key_splits(Sq, Sk, BH, hd)[0] == 1 else 2


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
    where = on_card(q, k, v)
    if where is META:                       # q·kᵀ and p·v; one exp a score
        return meta_result(q.shape, q.dtype, (q, k, v),
                           flops=4.0 * B * Hq * Sq * Sk * hd,
                           transcendentals=float(B * Hq * Sq * Sk))
    if not where:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if not tiling_ok(hd):
        raise ValueError(f"flash_attention takes hd <= {_MAX_HD}, got {hd}")
    splits, per = key_splits(Sq, Sk, B * Hq, hd)
    o = torch.empty((B, Hq, Sq, hd), dtype=q.dtype, device=q.device)
    code, stream = dtype_code(q), stream_of(q)
    if splits > 1:
        part_o = torch.empty((splits, B * Hq, Sq, hd), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((splits, B * Hq, Sq, 2), dtype=torch.float32,
                              device=q.device)
        parts = part_o.data_ptr(), part_ml.data_ptr()
    else:
        parts = None, None
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    o_strides = (ctypes.c_longlong * 4)(*o.stride())
    with torch.cuda.device(q.device):
        LIBRARY.launch("codo_flash_attention", code, q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), *parts, o.data_ptr(),
                       o_strides, B, Hq, Hkv, Sq, Sk, hd, strides, scale,
                       int(bool(causal)), int(window), splits, per, stream)
        if splits > 1:
            LIBRARY.launch("codo_flash_combine", code, *parts, o.data_ptr(),
                           splits, B * Hq, Hq, Sq, hd, o_strides, stream)
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
