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

Inside a sharded step (``distributed/spmd.py``) the channels are split
over ``model``: ``in_x``, ``in_y``, ``conv``, ``w_a``, ``w_i`` and
``out`` arrive as :class:`~repro_torch.distributed.spmd.Shards`.  Each
model position computes its channels' gate, input and conv; the conv
output is gathered over ``model`` (``w_a`` / ``w_i`` are dense D x D with
their outputs split), each position takes its gates with its channels of
``lam`` and runs the scan (the ``rglru_scan`` kernel at D / n channels),
and ``out``'s partial outputs are summed over ``model``.  The decode
writes each position's channels of the state and conv buffer in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distributed.collectives import group_all_gather, group_psum
from ..distributed.spmd import per_position
from .layers import (Params, _Fan, _device, _normal, _part, _split,
                     apply_norm, dense_init, linear, linear_part, norm_init,
                     row_linear)

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


def _gates(p: Params, x, x_all=None):
    """The decay ``a`` and input ``b`` of the channels of ``x``; the gates
    read ``x_all`` (every channel, gathered over ``model``: a tensor or
    the ``_Fan`` the positions share) where ``x`` holds a position's
    channels only."""
    if x_all is None:
        r, i = linear(p["w_a"], x), linear(p["w_i"], x)
    else:
        r, i = linear_part(p["w_a"], x_all), linear_part(p["w_i"], x_all)
    r, i = torch.sigmoid(r.float()), torch.sigmoid(i.float())
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * x.float()
    return a, b


def _recur(p: Params, x, gate, x_all=None):
    """The RG-LRU over a sequence of ``x``'s channels (the gates reading
    ``x_all`` where ``x`` holds a position's channels), times the GeLU
    ``gate``."""
    a, b = _gates(p, x, x_all)
    return rglru_scan(a, b).to(gate.dtype) * gate


def _recur_step(p: Params, x, gate, h, x_all=None):
    """:func:`_recur` for one token: x (B, channels) after the conv, ``h``
    their state.  Returns (y (B, 1, channels), the new state)."""
    a, b = _gates(p, x[:, None], None if x_all is None else x_all[:, None])
    hnew = a[:, 0] * h + b[:, 0]
    return (hnew.to(gate.dtype) * gate[:, 0])[:, None], hnew


def _conv_step(buf, x, w, dtype):
    """One token ``x`` (B, channels) through the causal conv ``w`` after
    the history ``buf``: (the conv output in ``dtype``, the next
    history)."""
    hist = torch.cat([buf, x[:, None]], dim=1)
    return (torch.einsum("bcd,cd->bd", hist.float(), w.float()).to(dtype),
            hist[:, 1:])


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


def _channel_part(p: Params, m: int, n: int) -> Params:
    """Model position ``m``'s block parameters: its shards and its
    channels of ``lam``."""
    pm = _part(p, m)
    d = p["lam"].shape[0] // n
    return {**pm, "lam": p["lam"][m * d:(m + 1) * d]}


def _rglru_train_tp(p: Params, xin, cfg: ArchConfig):
    n = p["in_x"]["w"].n
    take = _Fan(apply_norm(p["norm"], xin, cfg.norm), n)

    def branch(m):
        pm = _part(p, m)
        gate = F.gelu(linear_part(pm["in_y"], take), approximate="tanh")
        return gate, _conv1d(pm, linear_part(pm["in_x"], take))

    gx = per_position(n, branch, xin)
    take_all = _Fan(group_all_gather([x for _, x in gx], -1), n)

    def scan(m):
        gate, x = gx[m]
        return _recur(_channel_part(p, m, n), x, gate, take_all)

    return xin + row_linear([_part(p, m)["out"] for m in range(n)],
                            per_position(n, scan, xin), xin.dtype)


def rglru_block_train(p: Params, xin, cfg: ArchConfig):
    if _split(p["in_x"]["w"]):
        return _rglru_train_tp(p, xin, cfg)
    h = apply_norm(p["norm"], xin, cfg.norm)
    gate = F.gelu(linear(p["in_y"], h), approximate="tanh")
    x = _conv1d(p, linear(p["in_x"], h))
    return xin + linear(p["out"], _recur(p, x, gate))


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


def _rglru_decode_tp(p: Params, xin, cfg: ArchConfig, *, h_state,
                     conv_buf):
    n = p["in_x"]["w"].n
    h = apply_norm(p["norm"], xin, cfg.norm)

    def branch(m):
        pm = _part(p, m)
        gate = F.gelu(linear_part(pm["in_y"], h), approximate="tanh")
        x, hist = _conv_step(conv_buf.parts[m],
                             linear_part(pm["in_x"], h)[:, 0], pm["conv"],
                             xin.dtype)
        conv_buf.parts[m].copy_(hist)
        return gate, x

    gx = per_position(n, branch, xin)
    x_all = group_all_gather([x for _, x in gx], -1)

    def step(m):
        gate, x = gx[m]
        y, hnew = _recur_step(_channel_part(p, m, n), x, gate,
                              h_state.parts[m], x_all)
        h_state.parts[m].copy_(hnew)
        return y

    return (xin + row_linear([_part(p, m)["out"] for m in range(n)],
                             per_position(n, step, xin), xin.dtype),
            h_state, conv_buf)


def rglru_block_decode(p: Params, xin, cfg: ArchConfig, *, h_state,
                       conv_buf):
    """xin: (B, 1, D); h_state: (B, D); conv_buf: (B, cw-1, D)."""
    if _split(p["in_x"]["w"]):
        return _rglru_decode_tp(p, xin, cfg, h_state=h_state,
                                conv_buf=conv_buf)
    h = apply_norm(p["norm"], xin, cfg.norm)
    gate = F.gelu(linear(p["in_y"], h), approximate="tanh")
    x, conv_buf = _conv_step(conv_buf, linear(p["in_x"], h)[:, 0],
                             p["conv"], xin.dtype)
    y, hnew = _recur_step(p, x, gate, h_state)
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
