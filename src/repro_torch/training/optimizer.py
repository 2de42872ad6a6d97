"""AdamW + LR schedule + global-norm clipping (no external deps).

The port's copy of ``repro/training/optimizer.py``, on nests of dicts of
tensors.  Optimizer moments are float32 regardless of the parameter dtype
(bfloat16 parameters, float32 state, float32 update math); ``step`` is an
int32 tensor on the parameters' device.  Nothing here reads a value on
the host: the schedule is ``torch.where`` on the device, so a train step
that calls :func:`adamw_update` can be captured into a CUDA graph.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..models.layers import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(step, oc: OptConfig):
    """The warmup-cosine learning rate at ``step`` (an int32 tensor), a
    float32 tensor on its device."""
    warm = oc.lr * (step + 1) / max(oc.warmup_steps, 1)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = oc.lr * (oc.min_lr_frac + (1 - oc.min_lr_frac)
                   * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < oc.warmup_steps, warm, cos)


def adamw_init(params: Any) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_scale(norm, max_norm: float):
    """The factor that clips a gradient of global norm ``norm`` to
    ``max_norm`` (1 when it is shorter)."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float):
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _update_rule(state: dict, oc: OptConfig):
    """The new step counter, the schedule's lr, and the per-leaf rule
    ``(p, g32, m, v) -> (p2, m2, v2)`` of one AdamW update."""
    step = state["step"] + 1
    lr = lr_at(step, oc)
    b1c = 1.0 - oc.b1 ** step.float()
    b2c = 1.0 - oc.b2 ** step.float()

    def upd(p, g, m, v):
        m2 = oc.b1 * m + (1 - oc.b1) * g
        v2 = oc.b2 * v + (1 - oc.b2) * g * g
        mh, vh = m2 / b1c, v2 / b2c
        delta = mh / (torch.sqrt(vh) + oc.eps) + oc.weight_decay * p.float()
        p2 = p.float() - lr * delta
        return p2.to(p.dtype), m2, v2

    return step, lr, upd


def adamw_update(grads: Any, state: dict, params: Any, oc: OptConfig):
    """Returns (new_params, new_state, metrics)."""
    grads32, gnorm = clip_by_global_norm(grads, oc.clip_norm)
    step, lr, upd = _update_rule(state, oc)
    out = tree_map(upd, params, grads32, state["m"], state["v"])
    pick = [tree_map(lambda t, i=i: t[i], out) for i in range(3)]
    return pick[0], {"m": pick[1], "v": pick[2], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


def adamw_update_(grads: Any, state: dict, params: Any, oc: OptConfig, *,
                  norm=None):
    """:func:`adamw_update` written into ``params`` and ``state`` in place,
    one leaf at a time (so one leaf's float32 temporaries are alive at a
    time, not the whole tree's), with the same arithmetic.  ``norm`` is
    the gradient's global norm where the caller has it: a sharded step
    passes its whole gradient's and hands in only its shards' slices.
    Returns the metrics."""
    if norm is None:
        norm = global_norm(grads)
    scale = clip_scale(norm, oc.clip_norm)
    step, lr, upd = _update_rule(state, oc)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        p2, m2, v2 = upd(p, g.float() * scale, m, v)
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
    state["step"].copy_(step)
    return {"grad_norm": norm, "lr": lr}


__all__ = ["OptConfig", "adamw_init", "adamw_update", "adamw_update_",
           "clip_by_global_norm", "clip_scale", "global_norm", "lr_at"]
