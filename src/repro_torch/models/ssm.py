"""Mamba-2 SSD (state-space duality) blocks — arXiv:2405.21060.

The port's copy of ``repro/models/ssm.py``.  The chunked SSD algorithm
splits the recurrence over time into intra-chunk (dense, matmul-shaped)
and inter-chunk (a tiny scan over per-chunk states).  The inter-chunk
scan runs through the port's ``ssd_chunk_scan`` kernel
(:func:`repro_torch.kernels.ssd.ops.ssd_states`: the CUDA kernel for
tensors on the card, its plain version on the CPU), where the reference
runs a ``lax.scan``; the last state is folded after it.  That form is
differentiable: training's backward runs the reverse scan through the
same kernel, one more launch (``ssd_chunk_scan_backward``).

Shapes follow the minimal reference implementation:
  x: (B, S, H, P)   heads H = expand·d_model / P
  dt: (B, S, H)     per-head step size (softplus of a projection)
  B, C: (B, S, N)   shared across heads (G = 1 group)
  A: (H,)           negative decay rates

``ssd_block_fn`` is the inter-chunk recurrence in the dataflow-frontend
vocabulary, so the ``ssd_scan`` op reaches the same kernel through
routing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import (Params, _device, _normal, apply_norm, dense_init,
                     linear, norm_init)


def _segsum(a):
    """Lower-triangular pairwise cumulative sums: out[i,j] = sum_{j<k<=i}
    a_k, and -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -math.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Returns (y, final_state).  final_state: (B, H, P, N)."""
    from ..kernels.ssd.ops import ssd_states
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    nc = s // chunk
    if s % chunk:
        raise ValueError(f"the chunk {chunk} must divide the sequence {s}")

    a = dt * A[None, None, :]                     # (b, s, h) log-decay
    # x joins float32 operands in the einsums below: promoted, as jnp.einsum
    # promotes it
    xc = x.reshape(b, nc, chunk, h, p).to(torch.promote_types(x.dtype,
                                                              dt.dtype))
    ac = a.reshape(b, nc, chunk, h)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, n)
    Cc = Cm.reshape(b, nc, chunk, n)

    # The reference's many-operand einsums are written as elementwise
    # products and one two-operand contraction each: torch contracts a
    # many-operand einsum pairwise in its own order, and at (2, 2048) on
    # Mamba-2 780M's widths that order built a 12 GiB (b,nc,h,q,k,p)
    # intermediate.

    # intra-chunk (diagonal blocks): attention-like with decay kernel
    L = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))          # (b,nc,h,q,q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)        # (b,nc,q,q)
    kern = scores[:, :, None] * L * dtc.permute(0, 1, 3, 2)[:, :, :, None]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", kern, xc)

    # end-of-chunk states
    cs = ac.cumsum(2)
    decay_states = torch.exp(cs[:, :, -1:, :] - cs)         # (b,nc,q,h)
    states = torch.einsum("bckn,bckhp->bchpn", Bc,
                          xc * (decay_states * dtc)[..., None])  # (b,nc,h,p,n)

    # inter-chunk recurrence over nc states: the ssd_chunk_scan kernel
    # over (nc, b·h, p, n) states and (nc, b·h, 1, 1) decays
    chunk_decay = torch.exp(ac.sum(2))                      # (b, nc, h)
    st = states.permute(1, 0, 2, 3, 4).float().reshape(
        nc, b * h, p, n).contiguous()
    dec = chunk_decay.permute(1, 0, 2).float().reshape(
        nc, b * h, 1, 1).contiguous()
    hprev = ssd_states(st, dec)                             # carried in
    hlast = (hprev[-1] * dec[-1] + st[-1]).reshape(b, h, p, n)
    hprevs = hprev.reshape(nc, b, h, p, n).permute(1, 0, 2, 3, 4)

    # contribution of carried-in state to each position
    state_decay = torch.exp(cs)                             # (b,nc,q,h)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc,
                         hprevs.to(Cc.dtype)) * state_decay[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), hlast


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token recurrence.  state: (B,H,P,N); x: (B,H,P); dt: (B,H);
    B/C: (B,N)."""
    dec = torch.exp(dt * A[None, :])                        # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, x, Bm)
    state = state * dec[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, state.to(Cm.dtype))
    return y.to(x.dtype), state


# --------------------------------------------------------------------------
# Block (norm -> in_proj -> conv1d -> SSD -> gate -> out_proj)
# --------------------------------------------------------------------------


def init_ssm_block(g, cfg: ArchConfig) -> Params:
    s = cfg.ssm
    d = cfg.d_model
    d_in = d * s.expand
    nheads = d_in // s.head_dim
    dt_ = cfg.tdtype
    dev = _device(g)
    return {
        "norm": norm_init(d, cfg.norm, dt_, device=dev),
        # projects to [z (gate), x, B, C, dt]
        "in_proj": dense_init(g, d, 2 * d_in + 2 * s.d_state + nheads, dt_),
        "conv": _normal(g, (s.conv_width, d_in + 2 * s.d_state), 0.2, dt_),
        "A_log": torch.zeros((nheads,), dtype=torch.float32, device=dev)
        + math.log(1.0),
        "D": torch.ones((nheads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(g, d_in, d, dt_),
    }


def _split_proj(cfg: ArchConfig, proj):
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    nheads = d_in // s.head_dim
    z, xbc, dt = torch.tensor_split(proj, [d_in, 2 * d_in + 2 * s.d_state],
                                    dim=-1)
    return z, xbc, dt, d_in, nheads


def ssm_block_train(p: Params, xin, cfg: ArchConfig):
    s = cfg.ssm
    Bsz, S, _ = xin.shape
    h = apply_norm(p["norm"], xin, cfg.norm)
    z, xbc, dtp, d_in, nheads = _split_proj(cfg, linear(p["in_proj"], h))
    # causal depthwise conv over (x, B, C)
    w = p["conv"]
    pad = F.pad(xbc, (0, 0, s.conv_width - 1, 0))
    conv = sum(pad[:, i:i + S, :] * w[i][None, None, :]
               for i in range(s.conv_width))
    conv = F.silu(conv)
    x, Bm, Cm = torch.tensor_split(conv, [d_in, d_in + s.d_state], dim=-1)
    x = x.reshape(Bsz, S, nheads, s.head_dim)
    dt = F.softplus(dtp.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, _ = ssd_chunked(x, dt, A, Bm.float(), Cm.float(), min(s.chunk, S))
    y = y + x * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(Bsz, S, d_in) * F.silu(z)
    return xin + linear(p["out_proj"], y)


def init_ssm_cache(cfg: ArchConfig, batch: int, layers: int,
                   device=None) -> Params:
    """A stacked decode state on ``device`` (the card when it is None)."""
    from ..api import resolve_device
    device = resolve_device(device)
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    nheads = d_in // s.head_dim
    return {
        "state": torch.zeros((layers, batch, nheads, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((layers, batch, s.conv_width - 1,
                             d_in + 2 * s.d_state), dtype=cfg.tdtype,
                            device=device),
    }


def ssm_block_decode(p: Params, xin, cfg: ArchConfig, *, state, conv_buf):
    """xin: (B, 1, D).  Returns (y, state, conv_buf)."""
    s = cfg.ssm
    Bsz = xin.shape[0]
    h = apply_norm(p["norm"], xin, cfg.norm)
    z, xbc, dtp, d_in, nheads = _split_proj(cfg, linear(p["in_proj"], h))
    xbc = xbc[:, 0]                                   # (B, d_in+2N)
    hist = torch.cat([conv_buf, xbc[:, None]], dim=1)  # (B, cw, *)
    conv = torch.einsum("bcw,cw->bw", hist.float(), p["conv"].float())
    conv = F.silu(conv).to(xin.dtype)
    conv_buf = hist[:, 1:]
    x, Bm, Cm = torch.tensor_split(conv, [d_in, d_in + s.d_state], dim=-1)
    x = x.reshape(Bsz, nheads, s.head_dim)
    dt = F.softplus(dtp[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssd_decode_step(state, x.float(), dt, A, Bm.float(),
                               Cm.float())
    y = y + x.float() * p["D"][None, :, None]
    y = y.reshape(Bsz, 1, d_in).to(xin.dtype) * F.silu(z)
    return xin + linear(p["out_proj"], y), state, conv_buf


# --------------------------------------------------------------------------
# CODO traced form: the SSD inter-chunk state recurrence as a
# dataflow-frontend function, so the ``ssd_scan`` op reaches the
# chunked-scan kernel through routing.
# --------------------------------------------------------------------------


def ssd_block_fn(states, decay):
    """Inter-chunk SSD recurrence over per-chunk end ``states
    (nc, BH, P, N)`` and scalar ``decay (nc, BH, 1, 1)``; returns the
    carried-in states combined with the locals (residual form)."""
    from ..core import frontend as F
    prev = F.ssd_scan(states, decay)
    return F.add(prev, states)
