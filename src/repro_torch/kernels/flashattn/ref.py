"""Plain PyTorch oracle for the flash-attention kernel (the counterpart of
``repro/kernels/flashattn/ref.py``: einsum over grouped heads, masked
softmax)."""

from __future__ import annotations

import math


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd)."""
    import torch
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, hd).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    s = s / math.sqrt(hd)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    s = torch.where(mask[None, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, hd).to(q.dtype)
