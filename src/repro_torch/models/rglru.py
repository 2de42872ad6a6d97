"""RG-LRU recurrent blocks (RecurrentGemma / Griffin, arXiv:2402.19427).

The port's copy of ``repro/models/rglru.py``.  The Real-Gated Linear
Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    log a_t = -c * softplus(Λ) * r_t      (per-channel decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Training and prefill run the recurrence over time through the port's
``rglru_scan`` kernel (:func:`repro_torch.kernels.rglru.ops.rglru`: the
CUDA kernel for tensors on the card, its plain version on the CPU), where
the reference runs an associative scan in jnp.  That form is
differentiable: training's backward runs the reverse recurrence through
the same kernel, one more launch (``rglru_scan_backward``).  Decode is a
single-step update with O(1) state.  ``rglru_block_fn`` is the gated recurrence core
in the dataflow-frontend vocabulary, so the ``rglru_scan`` op reaches the
same kernel through routing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import (Params, _device, _normal, apply_norm, dense_init,
                     linear, norm_init)

_C = 8.0


def init_rglru_block(g, cfg: ArchConfig) -> Params:
    d = cfg.d_model
    dt = cfg.tdtype
    return {
        "norm": norm_init(d, cfg.norm, dt, device=_device(g)),
        "in_x": dense_init(g, d, d, dt),      # recurrent branch
        "in_y": dense_init(g, d, d, dt),      # gate branch (GeLU)
        "conv": _normal(g, (4, d), 0.2, dt),
        "w_a": dense_init(g, d, d, dt),
        "w_i": dense_init(g, d, d, dt),
        "lam": torch.full((d,), 2.0, dtype=torch.float32,
                          device=_device(g)),  # softplus(2) ~ healthy decay
        "out": dense_init(g, d, d, dt),
    }


def _gates(p: Params, x):
    r = torch.sigmoid(linear(p["w_a"], x).float())
    i = torch.sigmoid(linear(p["w_i"], x).float())
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * x.float()
    return a, b


def _conv1d(p: Params, x):
    w = p["conv"]
    cw = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    return sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(cw))


def rglru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t over axis 1, through the ``rglru_scan``
    kernel (its plain version on the CPU); with ``h0``, plus a_s·h0 where
    a_s is the running product of a."""
    from ..kernels.rglru.ops import rglru
    from ..kernels.rglru.rglru import chunk_length
    a, b = a.contiguous(), b.contiguous()
    h = rglru(a, b, chunk=chunk_length(*a.shape))
    if h0 is not None:
        h = h + torch.cumprod(a, dim=1) * h0[:, None, :]
    return h


def rglru_block_train(p: Params, xin, cfg: ArchConfig):
    h = apply_norm(p["norm"], xin, cfg.norm)
    gate = F.gelu(linear(p["in_y"], h), approximate="tanh")
    x = linear(p["in_x"], h)
    x = _conv1d(p, x)
    a, b = _gates(p, x)
    y = rglru_scan(a, b).to(xin.dtype)
    y = y * gate
    return xin + linear(p["out"], y)


def init_rglru_cache(cfg: ArchConfig, batch: int, layers: int,
                     device=None) -> Params:
    """A stacked decode state on ``device`` (the card when it is None)."""
    from ..api import resolve_device
    device = resolve_device(device)
    d = cfg.d_model
    return {
        "h": torch.zeros((layers, batch, d), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((layers, batch, 3, d), dtype=cfg.tdtype,
                            device=device),
    }


def rglru_block_decode(p: Params, xin, cfg: ArchConfig, *, h_state,
                       conv_buf):
    """xin: (B, 1, D); h_state: (B, D); conv_buf: (B, cw-1, D)."""
    h = apply_norm(p["norm"], xin, cfg.norm)
    gate = F.gelu(linear(p["in_y"], h), approximate="tanh")
    x = linear(p["in_x"], h)[:, 0]                        # (B, D)
    hist = torch.cat([conv_buf, x[:, None]], dim=1)
    x = torch.einsum("bcd,cd->bd", hist.float(),
                     p["conv"].float()).to(xin.dtype)
    conv_buf = hist[:, 1:]
    a, b = _gates(p, x[:, None])
    hnew = a[:, 0] * h_state + b[:, 0]
    y = (hnew.to(xin.dtype) * gate[:, 0])[:, None]
    return xin + linear(p["out"], y), hnew, conv_buf


# --------------------------------------------------------------------------
# CODO traced form: the gated recurrence core as a dataflow-frontend
# function, so the ``rglru_scan`` op reaches the chunked-scan kernel
# through routing.
# --------------------------------------------------------------------------


def rglru_block_fn(a, gate, x):
    """Gated linear-recurrence block over ``(B, S, D)`` operands:
    ``h = scan(a, gate*x)`` with a residual skip."""
    from ..core import frontend as F
    b = F.mul(gate, x)
    h = F.rglru_scan(a, b)
    return F.add(h, x)
