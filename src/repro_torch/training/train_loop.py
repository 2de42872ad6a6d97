"""Training step construction + fault-tolerant training driver.

The port's copy of ``repro/training/train_loop.py``.
``build_train_step(cfg, oc, ...)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)`` with

* per-group remat (activation checkpointing, ``models/transformer.py``),
* optional gradient accumulation over microbatches (gradients summed in
  float32, as the reference's ``lax.scan`` sums them),
* gradients by ``torch.autograd.grad`` over the parameter leaves; the
  scans' backwards run through their kernels
  (``kernels/{rglru,ssd}``: one reverse launch each).

Where the reference runs the step under ``jax.jit(..., donate_argnums=(0,
1))``, :func:`train` runs it through :class:`TrainStep`: a
:class:`~repro_torch.core.capture.CapturedProgram` of one step whose
parameters, optimizer state and batch buffers are bound where they lie
(never copied), and which writes the parameters and state in place.  On
the card its first call runs eagerly and then captures the step into a
CUDA graph; every later call copies the batch into its buffers and
replays.  A step that cannot be captured raises
:class:`~repro_torch.core.capture.CaptureError` and never runs eagerly
instead; ``jit=False`` asks for the eager step.  On the CPU the step runs
eagerly.

``train(...)`` is the driver: heartbeat/straggler monitoring, async
checkpointing (layout ``{"params", "opt"}``), simulated-failure injection
for tests, and restart (:func:`resume`).  ``train_compiled`` /
``resume_compiled`` drive a pipeline-compiled
:class:`~repro_torch.api.CompiledTrainStep` the same way.  The
reference's ``jit_train_step`` (GSPMD shardings over a mesh) and the
compressed gradient all-reduce wait for the sharded train step
(``ROADMAP.md``, Queue 1 item 7b).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models import transformer as tf
from ..models.layers import (tree_from_paths, tree_leaves, tree_map,
                             tree_paths)
from .optimizer import OptConfig, adamw_init, adamw_update, adamw_update_

_ITEM_7B = "ROADMAP.md, Queue 1 item 7b (the sharded train step)"


def _unflatten(tree: Any, leaves) -> Any:
    """``tree`` with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def value_and_grad(loss_of: Callable, params: Any, batch: dict):
    """``(loss, grads)`` of ``loss_of(params, batch)`` by
    ``torch.autograd.grad`` over the parameter leaves; a leaf the loss
    does not reach gets a zero gradient (as ``jax.grad`` gives)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss = loss_of(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(params, grads)


def build_train_step(cfg: ArchConfig, oc: OptConfig | None = None, *,
                     accum: int = 1, remat: bool = True,
                     compress_grads: bool = False,
                     dp_axes: tuple[str, ...] = (),
                     in_place: bool = False) -> Callable:
    """The function the trainer executes: ``(params, opt_state, batch) ->
    (params, opt_state, metrics)``.  With ``in_place`` it writes the new
    parameters and optimizer state into the ones it is given
    (:func:`~repro_torch.training.optimizer.adamw_update_`, the same
    arithmetic) and returns those."""
    oc = oc or OptConfig()
    if compress_grads and dp_axes:
        raise NotImplementedError(
            f"compress_grads over dp_axes={dp_axes} is an all-reduce inside "
            f"the sharded train step, which waits for {_ITEM_7B}")

    def loss_of(params, batch):
        return tf.loss_fn(params, batch, cfg, remat=remat)

    def train_step(params, opt_state, batch):
        if accum > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses = []
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                loss, g = value_and_grad(loss_of, params, mb)
                grads = tree_map(lambda a, b: a + b, grads, g)
                losses.append(loss)
            grads = tree_map(lambda g: g / accum, grads)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(loss_of, params, batch)

        if in_place:
            metrics = adamw_update_(grads, opt_state, params, oc)
        else:
            params, opt_state, metrics = adamw_update(grads, opt_state,
                                                      params, oc)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def jit_train_step(cfg: ArchConfig, mesh, params_or_shapes, batch_like,
                   oc: OptConfig | None = None, **kw):
    """The reference's step with GSPMD shardings over ``mesh``: not yet."""
    raise NotImplementedError(f"jit_train_step over a mesh waits for "
                              f"{_ITEM_7B}")


# --------------------------------------------------------------------------
# The step runner (the reference's jax.jit with donated params and state)
# --------------------------------------------------------------------------


class TrainStep:
    """The train step of ``cfg`` bound to ``params`` and ``opt_state`` (on
    one device): ``step(batch)`` copies the batch (numpy arrays or
    tensors) into its device buffers, writes the parameters and optimizer
    state in place, and returns the metrics (0-d tensors ``loss``,
    ``grad_norm``, ``lr``).  It is a
    :class:`~repro_torch.core.capture.CapturedProgram` of one step,
    ``train_step``, whose every env entry is bound: captured where it lies
    and never copied.  ``jit=False`` runs the step eagerly."""

    OUTPUTS = ("loss", "grad_norm", "lr")

    def __init__(self, cfg: ArchConfig, params, opt_state,
                 oc: OptConfig | None = None, *, remat: bool = True,
                 accum: int = 1, jit: bool = True):
        self.cfg = cfg
        self.params, self.opt_state = params, opt_state
        self.device = opt_state["step"].device
        self.jit = jit
        self.fn = build_train_step(cfg, oc, accum=accum, remat=remat,
                                   in_place=True)
        self.batch: dict | None = None
        self.env: dict = {}
        self.program = None

    def _bind(self, batch: dict) -> None:
        from ..core.capture import CapturedProgram
        self.batch = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v)
            # float inputs (frames, patch embeddings) in the model's dtype
            dtype = self.cfg.tdtype if t.is_floating_point() else t.dtype
            self.batch[k] = torch.empty(t.shape, dtype=dtype,
                                        device=self.device)
        params, opt, bufs = self.params, self.opt_state, self.batch
        self.env = {**tree_paths(params, "params"),
                    **tree_paths(opt, "opt"), **tree_paths(bufs, "batch")}
        fn = self.fn

        def train_step(scope):
            _, _, metrics = fn(tree_from_paths(params, scope, "params"),
                               tree_from_paths(opt, scope, "opt"),
                               tree_from_paths(bufs, scope, "batch"))
            return metrics

        self.program = CapturedProgram([("train_step", train_step)],
                                       list(self.OUTPUTS), bound=self.env)

    def __call__(self, batch: dict) -> dict:
        from ..core.capture import run_steps
        if self.batch is None or any(
                k not in self.batch
                or tuple(self.batch[k].shape) != tuple(v.shape)
                for k, v in batch.items()) or len(batch) != len(self.batch):
            self._bind(batch)
        for k, v in batch.items():
            self.batch[k].copy_(torch.as_tensor(
                v if isinstance(v, torch.Tensor) else np.asarray(v)))
        if not self.jit:
            return run_steps(self.program.steps, self.program.outputs,
                             self.env)
        return self.program(self.env)


# --------------------------------------------------------------------------
# Fault-tolerant driver
# --------------------------------------------------------------------------


@dataclass
class TrainReport:
    steps_done: int = 0
    restarts: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    straggler_flags: int = 0
    checkpoints: list = field(default_factory=list)


class StepTimeMonitor:
    """EWMA step-time tracker; flags stragglers (steps ≥ k× the mean)."""

    def __init__(self, k: float = 3.0, alpha: float = 0.2):
        self.k, self.alpha, self.mean = k, alpha, None
        self.flags = 0

    def observe(self, dt: float) -> bool:
        if self.mean is None:
            self.mean = dt
            return False
        slow = dt > self.k * self.mean
        if slow:
            self.flags += 1
        self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
        return slow


class Heartbeat:
    """Deadline monitor: ``beat()`` every step; ``expired()`` signals a
    hang (on real fleets this triggers the coordinator's restart path)."""

    def __init__(self, timeout_s: float = 300.0):
        self.timeout_s = timeout_s
        self.last = time.monotonic()

    def beat(self) -> None:
        self.last = time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() - self.last > self.timeout_s


class SimulatedFailure(RuntimeError):
    pass


def _init_params(cfg: ArchConfig, seed: int, device):
    from ..api import resolve_device
    device = resolve_device(device)
    return tf.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device=device)


def train(cfg: ArchConfig, *, steps: int, batch_fn: Callable[[int], dict],
          checkpointer=None, checkpoint_every: int = 50,
          oc: OptConfig | None = None, seed: int = 0, mesh=None,
          fail_at: int | None = None, params=None, opt_state=None,
          start_step: int = 0, remat: bool = True, device=None,
          jit: bool = True) -> tuple[Any, Any, TrainReport]:
    """Training driver with checkpoint/restart semantics, on ``device``
    (the card unless it says otherwise; the parameters' device when they
    are given).  ``params`` and ``opt_state`` are written in place (the
    reference donates them) and returned.

    ``fail_at`` injects a simulated failure (raises) after that step — the
    restart path calls :func:`resume`, which restores the latest
    checkpoint and calls ``train`` again.  ``batch_fn(step)`` returns the
    batch as numpy arrays (or tensors); the step copies it to the device.
    """
    if mesh is not None:
        raise NotImplementedError(f"train on a mesh waits for {_ITEM_7B}")
    oc = oc or OptConfig()
    report = TrainReport()
    if params is None:
        params = _init_params(cfg, seed, device)
    if opt_state is None:
        opt_state = adamw_init(params)

    runner = TrainStep(cfg, params, opt_state, oc, remat=remat, jit=jit)
    monitor, hb = StepTimeMonitor(), Heartbeat()

    for step in range(start_step, steps):
        t0 = time.perf_counter()
        batch = batch_fn(step)
        metrics = runner(batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        hb.beat()
        if monitor.observe(dt):
            report.straggler_flags += 1
        report.losses.append(loss)
        report.step_times.append(dt)
        report.steps_done = step + 1
        if checkpointer is not None and (step + 1) % checkpoint_every == 0:
            checkpointer.save(step + 1, {"params": params, "opt": opt_state})
            report.checkpoints.append(step + 1)
        if fail_at is not None and step + 1 >= fail_at:
            raise SimulatedFailure(f"injected failure at step {step + 1}")
    return params, opt_state, report


def _like(cfg: ArchConfig, device) -> dict:
    """The ``{"params", "opt"}`` tree of ``cfg`` on ``device``, values
    unset: the structure, devices and dtypes a restore fills."""
    from ..api import resolve_device
    device = resolve_device(device)
    params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device=device),
                      tf.param_shapes(cfg))
    return {"params": params, "opt": adamw_init(params)}


def resume(cfg: ArchConfig, checkpointer, *, steps: int, batch_fn,
           seed: int = 0, shardings=None, device=None, **kw):
    """Restore the latest checkpoint onto ``device`` and continue (the
    restart path).  Restoring onto another mesh (``shardings``) waits for
    the sharded train step."""
    step, state = checkpointer.restore_latest(_like(cfg, device), shardings)
    return train(cfg, steps=steps, batch_fn=batch_fn,
                 checkpointer=checkpointer, params=state["params"],
                 opt_state=state["opt"], start_step=step, seed=seed, **kw)


# --------------------------------------------------------------------------
# Compiled driver (graph-level autodiff)
# --------------------------------------------------------------------------


def train_compiled(step, *, steps: int, batch_fn: Callable[[int], tuple],
                   checkpointer=None, checkpoint_every: int = 50,
                   params=None, opt_state=None, start_step: int = 0,
                   fail_at: int | None = None, verify_every: int = 0,
                   jit: bool = True) -> tuple[Any, Any, TrainReport]:
    """The :func:`train` driver over a
    :class:`~repro_torch.api.CompiledTrainStep` — forward, backward and
    AdamW update all run as pipeline-compiled dataflow graphs (captured
    into CUDA graphs on the card with ``jit=True``).

    Semantics match :func:`train`: same :class:`TrainReport`, the same
    straggler/heartbeat monitors, the same ``fail_at`` injection and
    checkpoint format (``{"params", "opt"}`` with ``optimizer``-layout
    opt state), so :func:`resume_compiled` restores checkpoints written
    by either package's driver.  ``batch_fn(step)`` returns the positional
    input arrays of the loss graph (e.g. ``(x, target)``).
    ``verify_every=N`` checks the compiled loss and gradients against
    ``torch.autograd`` through the source graph every N steps.
    """
    report = TrainReport()
    if params is None:
        params = step.init_params()
    if opt_state is None:
        opt_state = step.init_opt_state(params)
    monitor, hb = StepTimeMonitor(), Heartbeat()

    for i in range(start_step, steps):
        t0 = time.perf_counter()
        batch = batch_fn(i)
        if verify_every and i % verify_every == 0:
            step.verify(*batch, params=params)
        params, opt_state, metrics = step.step(params, opt_state, *batch,
                                               jit=jit)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        hb.beat()
        if monitor.observe(dt):
            report.straggler_flags += 1
        report.losses.append(loss)
        report.step_times.append(dt)
        report.steps_done = i + 1
        if checkpointer is not None and (i + 1) % checkpoint_every == 0:
            checkpointer.save(i + 1, {"params": params, "opt": opt_state})
            report.checkpoints.append(i + 1)
        if fail_at is not None and i + 1 >= fail_at:
            raise SimulatedFailure(f"injected failure at step {i + 1}")
    return params, opt_state, report


def resume_compiled(step, checkpointer, *, steps: int, batch_fn, **kw):
    """Restore the latest checkpoint and continue on the compiled step
    (the restart path of :func:`train_compiled`)."""
    like = {"params": step.init_params()}
    like["opt"] = step.init_opt_state(like["params"])
    at, state = checkpointer.restore_latest(like, None)
    return train_compiled(step, steps=steps, batch_fn=batch_fn,
                          checkpointer=checkpointer, params=state["params"],
                          opt_state=state["opt"], start_step=at, **kw)


__all__ = ["Heartbeat", "SimulatedFailure", "StepTimeMonitor", "TrainReport",
           "TrainStep", "build_train_step", "jit_train_step", "resume",
           "resume_compiled", "train", "train_compiled", "value_and_grad"]
