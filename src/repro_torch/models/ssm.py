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

Inside a sharded step (``distributed/spmd.py``) the heads are split over
``model``: ``out_proj``'s rows arrive as
:class:`~repro_torch.distributed.spmd.Shards`, ``in_proj`` and ``conv``
whole (the reference's specs split their packed z|x|B|C|dt columns at
the middle, not by head).  Each model position projects its heads' z, x
and dt columns and the whole B and C (one group), runs the SSD (the
``ssd_chunk_scan`` kernel at its heads), and ``out_proj``'s partial
outputs are summed over ``model`` in float32 and rounded once.  The
decode advances each position's conv-cache columns where they lie,
gathers the conv outputs over ``model``, and updates each position's
heads of the state in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distributed.collectives import group_all_gather
from ..distributed.spmd import per_position
from .layers import (Params, _Fan, _device, _normal, _part, _split,
                     apply_norm, dense_init, linear, linear_part, norm_init,
                     row_linear)


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


def _columns(w, ranges):
    """``w``'s columns in the ``(start, stop)`` ranges, in order."""
    return torch.cat([w[:, a:b] for a, b in ranges], dim=1)


def _conv_silu(xbc, w):
    """The causal depthwise conv of ``w`` (cw, columns) over time, then
    SiLU."""
    S, cw = xbc.shape[1], w.shape[0]
    pad = F.pad(xbc, (0, 0, cw - 1, 0))
    return F.silu(sum(pad[:, i:i + S, :] * w[i][None, None, :]
                      for i in range(cw)))


def _ssd_gated(p: Params, cfg: ArchConfig, x, z, dtp, Bm, Cm, heads):
    """The SSD of the heads ``heads`` over a sequence — x (B, S, heads ·
    P) after the conv, their gate z and dt projection, B and C float32 —
    with the D skip, gated by SiLU(z): the block's output before
    ``out_proj``."""
    s = cfg.ssm
    Bsz, S = x.shape[:2]
    x = x.reshape(Bsz, S, -1, s.head_dim)
    dt = F.softplus(dtp.float() + p["dt_bias"][heads])
    A = -torch.exp(p["A_log"][heads])
    y, _ = ssd_chunked(x, dt, A, Bm, Cm, min(s.chunk, S))
    y = y + x * p["D"][heads][None, None, :, None].to(x.dtype)
    return y.reshape(Bsz, S, -1) * F.silu(z)


def _ssm_train_tp(p: Params, xin, cfg: ArchConfig):
    """:func:`ssm_block_train` on a unit's shards: each position projects
    its heads' z, x and dt columns and the whole B and C (one group),
    runs the SSD over its heads, and ``out_proj``'s partial outputs are
    summed over ``model``."""
    s = cfg.ssm
    n = p["out_proj"]["w"].n
    d_in, N = cfg.d_model * s.expand, s.d_state
    dm, hm = d_in // n, d_in // s.head_dim // n
    w_in, w_conv = p["in_proj"]["w"], p["conv"]
    take = _Fan(apply_norm(p["norm"], xin, cfg.norm), n)
    dt0 = 2 * d_in + 2 * N

    def one(m):
        cols = [(m * dm, (m + 1) * dm), (d_in + m * dm, d_in + (m + 1) * dm),
                (2 * d_in, dt0), (dt0 + m * hm, dt0 + (m + 1) * hm)]
        z, x, bc, dtp = torch.tensor_split(
            linear_part({"w": _columns(w_in, cols)}, take),
            [dm, 2 * dm, 2 * dm + 2 * N], dim=-1)
        x = _conv_silu(x, w_conv[:, m * dm:(m + 1) * dm])
        bc = _conv_silu(bc, w_conv[:, d_in:]).float()
        return _ssd_gated(p, cfg, x, z, dtp, bc[..., :N], bc[..., N:],
                          slice(m * hm, (m + 1) * hm))

    return xin + row_linear([_part(p, m)["out_proj"] for m in range(n)],
                            per_position(n, one, xin), xin.dtype)


def ssm_block_train(p: Params, xin, cfg: ArchConfig):
    if _split(p["out_proj"]["w"]):
        return _ssm_train_tp(p, xin, cfg)
    s = cfg.ssm
    h = apply_norm(p["norm"], xin, cfg.norm)
    z, xbc, dtp, d_in, _ = _split_proj(cfg, linear(p["in_proj"], h))
    conv = _conv_silu(xbc, p["conv"])
    x, Bm, Cm = torch.tensor_split(conv, [d_in, d_in + s.d_state], dim=-1)
    y = _ssd_gated(p, cfg, x, z, dtp, Bm.float(), Cm.float(), slice(None))
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


def _ssd_step_gated(p: Params, cfg: ArchConfig, x, z, dtp, Bm, Cm, state,
                    heads):
    """:func:`_ssd_gated` for one token: x (B, heads · P) after the conv,
    ``state`` those heads' (B, heads, P, N).  Returns (y, state)."""
    s = cfg.ssm
    Bsz = x.shape[0]
    x = x.reshape(Bsz, -1, s.head_dim)
    dt = F.softplus(dtp.float() + p["dt_bias"][heads])
    A = -torch.exp(p["A_log"][heads])
    y, state = ssd_decode_step(state, x.float(), dt, A, Bm, Cm)
    y = y + x.float() * p["D"][heads][None, :, None]
    return y.reshape(Bsz, 1, -1).to(x.dtype) * F.silu(z), state


def _ssm_decode_tp(p: Params, xin, cfg: ArchConfig, *, state, conv_buf):
    """:func:`ssm_block_decode` on a unit's shards, the state (heads) and
    the conv buffer (packed x|B|C columns) split over ``model`` and written
    in place where they lie."""
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    N = s.d_state
    h = apply_norm(p["norm"], xin, cfg.norm)
    w_in = p["in_proj"]["w"]
    cc = conv_buf.parts[0].shape[-1]

    def advance(m):
        # the position's conv-buffer columns: its slice of x|B|C
        xbc = linear_part({"w": w_in[:, d_in + m * cc:d_in + (m + 1) * cc]},
                          h[:, 0])
        hist = torch.cat([conv_buf.parts[m], xbc[:, None]], dim=1)
        conv = torch.einsum("bcw,cw->bw", hist.float(),
                            p["conv"][:, m * cc:(m + 1) * cc].float())
        conv_buf.parts[m].copy_(hist[:, 1:])
        return F.silu(conv).to(xin.dtype)

    conv = group_all_gather(per_position(conv_buf.n, advance, xin), -1)
    n = state.n
    dm, hm = d_in // n, d_in // s.head_dim // n
    Bm, Cm = conv[:, d_in:d_in + N].float(), conv[:, d_in + N:].float()
    dt0 = 2 * d_in + 2 * N

    def one(m):
        z = linear_part({"w": w_in[:, m * dm:(m + 1) * dm]}, h)
        dtp = linear_part({"w": w_in[:, dt0 + m * hm:dt0 + (m + 1) * hm]},
                          h[:, 0])
        y, st = _ssd_step_gated(p, cfg, conv[:, m * dm:(m + 1) * dm], z, dtp,
                                Bm, Cm, state.parts[m],
                                slice(m * hm, (m + 1) * hm))
        state.parts[m].copy_(st)
        return y

    return (xin + row_linear([_part(p, m)["out_proj"] for m in range(n)],
                             per_position(n, one, xin), xin.dtype), state,
            conv_buf)


def ssm_block_decode(p: Params, xin, cfg: ArchConfig, *, state, conv_buf):
    """xin: (B, 1, D).  Returns (y, state, conv_buf)."""
    if _split(p["out_proj"]["w"]):
        return _ssm_decode_tp(p, xin, cfg, state=state, conv_buf=conv_buf)
    s = cfg.ssm
    h = apply_norm(p["norm"], xin, cfg.norm)
    z, xbc, dtp, d_in, _ = _split_proj(cfg, linear(p["in_proj"], h))
    xbc = xbc[:, 0]                                   # (B, d_in+2N)
    hist = torch.cat([conv_buf, xbc[:, None]], dim=1)  # (B, cw, *)
    conv = torch.einsum("bcw,cw->bw", hist.float(), p["conv"].float())
    conv = F.silu(conv).to(xin.dtype)
    conv_buf = hist[:, 1:]
    x, Bm, Cm = torch.tensor_split(conv, [d_in, d_in + s.d_state], dim=-1)
    y, state = _ssd_step_gated(p, cfg, x, z, dtp[:, 0], Bm.float(),
                               Cm.float(), state, slice(None))
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
