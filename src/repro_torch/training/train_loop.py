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
:class:`~repro_torch.api.CompiledTrainStep` the same way.

On a mesh, :func:`jit_train_step` is the reference's step with its in and
out shardings (parameters and AdamW state by ``param_specs``, the batch by
``batch_specs``): a :class:`ShardedTrainStep` run by the lockstep executor
of :mod:`~repro_torch.distributed.spmd`.  It gathers the parameters over
the data axes (the leaves split over ``model`` stay split: each model
position computes its heads, columns, experts and vocab slice), takes
the gradient of Σ nll·mask over each data-parallel block of the batch
divided by the whole batch's Σ mask (the sums and counts reduced across
the positions before the division, as the token-weighted mean needs),
sums the blocks' gradients in float32 in position order, clips by the
norm of that whole gradient (each element counted once), and writes
every position's AdamW update of its own shards in place.  A model
position's gradient is its own part's; a leaf every position reads whole
(norms, ``lam``, ``A_log``, the router) gathers its gradient from every
position's use, the sum over ``model``.  ``train``
runs it when the parameters it is given are placed on a mesh (``resume``
with ``shardings`` places them), and checkpoints gathered leaves.
``build_train_step(compress_grads=True, dp_axes=...)`` all-reduces the
gradients in int8 (:func:`~repro_torch.distributed.compression.
compressed_allreduce`) for a step run inside ``shard_map``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..distributed import compression, spmd
from ..distributed.sharding import (PlacedArray, as_shardings, batch_specs,
                                    param_shardings, param_specs, place,
                                    replicated)
from ..models import transformer as tf
from ..models.layers import (tree_from_paths, tree_leaves, tree_map,
                             tree_paths)
from .optimizer import (OptConfig, adamw_init, adamw_update, adamw_update_,
                        global_norm)


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


def unit_value_and_grad(loss_of: Callable, unit: Any, batch: dict):
    """:func:`value_and_grad` over a compute unit's parameters
    (:func:`~repro_torch.distributed.spmd.unit_params`): the gradient of
    every part of a leaf split over ``model``, in the unit tree's form."""
    live = spmd.unit_map(lambda p: p.detach().requires_grad_(True), unit)
    leaves = spmd.unit_leaves(live)
    with torch.enable_grad():
        loss = loss_of(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), spmd.unit_map(lambda _: next(it), unit)


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

        if compress_grads and dp_axes:
            # as in the reference, the updated state is AdamW's {"m", "v",
            # "step"}: the error feedback is returned by the all-reduce
            grads, compressed = compression.compressed_allreduce(
                grads, opt_state, dp_axes)
            if not in_place:
                opt_state = compressed

        if in_place:
            metrics = adamw_update_(grads, opt_state, params, oc)
        else:
            params, opt_state, metrics = adamw_update(grads, opt_state,
                                                      params, oc)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def train_state_shardings(params_or_shapes: Any, mesh, cfg: ArchConfig
                          ) -> dict:
    """The ``{"params", "opt"}`` checkpoint tree's shardings on ``mesh``:
    parameters, m and v by ``param_specs``, the step counter replicated
    (the reference's ``jit_train_step`` in / out shardings)."""
    ps = param_shardings(params_or_shapes, mesh, cfg)
    return {"params": ps, "opt": {"m": ps, "v": ps,
                                  "step": replicated(mesh)}}


def _placed(tree) -> bool:
    leaves = tree_leaves(tree) if tree is not None else []
    return bool(leaves) and all(isinstance(x, PlacedArray) for x in leaves)


class ShardedTrainStep:
    """The train step of ``cfg`` on ``mesh`` with the reference's in and
    out shardings: ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  Parameters and AdamW state are placed by ``param_specs``
    (``{"m", "v": pspecs, "step": P()}``), leaves given unplaced or placed
    otherwise are placed first (``jax.jit``'s in_shardings); the batch
    (numpy arrays or tensors, the global batch) is copied into the step's
    buffers, split by ``batch_specs``.  With ``donate`` every position's
    shards are written in place and returned; without, the state is copied
    first and the step runs eagerly.  The metrics are 0-d tensors
    (``loss``, ``grad_norm``, ``lr``) on the mesh's first device.

    Each data-parallel block of the batch (:func:`~repro_torch.
    distributed.spmd.compute_blocks`) runs the model once, each model
    position computing its part; see the module docstring for the
    reduction.  On a 1 x 1 mesh the step is the unsharded step bit for
    bit."""

    OUTPUTS = ("loss", "grad_norm", "lr")

    def __init__(self, cfg: ArchConfig, mesh, pspecs, bspecs,
                 oc: OptConfig | None = None, *, accum: int = 1,
                 remat: bool = True, donate: bool = True, jit: bool = True):
        self.cfg, self.mesh = cfg, mesh
        self.oc = oc or OptConfig()
        self.accum, self.remat, self.donate = accum, remat, donate
        self.pshard = as_shardings(pspecs, mesh)
        self.oshard = {"m": self.pshard, "v": self.pshard,
                       "step": replicated(mesh)}
        self.bshard = as_shardings(bspecs, mesh)
        self.bufs: dict | None = None
        self._cur = None
        # undonated state is copied each call: nothing to bind, so eager
        self.runner = spmd.LockstepStep(mesh, "train_step", self._body,
                                        list(self.OUTPUTS),
                                        jit=jit and donate)

    # --------------------------------------------------------------- batch
    def _load_batch(self, batch: dict) -> dict:
        """The batch copied into this step's placed buffers (allocated
        again when a key or shape changes): float inputs in the model's
        dtype."""
        full = spmd.whole_batch(batch, self.cfg.tdtype)
        if self.bufs is None or self.bufs.keys() != full.keys() or any(
                self.bufs[k].shape != tuple(t.shape) for k, t in full.items()):
            self.bufs = place(full, {k: self.bshard[k] for k in full})
        else:
            for k, t in full.items():
                spmd.write_blocks(self.bufs[k], t)
        return self.bufs

    # ---------------------------------------------------------------- body
    def _body(self) -> dict:
        params, opt, bufs = self._cur
        cfg, accum, mesh = self.cfg, self.accum, self.mesh
        if mesh.distributed:
            # a rank reads its own blocks' rows; every rank counts the
            # whole batch's tokens
            labels = bufs["labels"].gather()

            def rows_of(r0, r1):
                return {k: spmd.block_rows(v, r0, r1)
                        for k, v in bufs.items()}
        else:
            batch = {k: v.gather() for k, v in bufs.items()}
            labels = batch["labels"]

            def rows_of(r0, r1):
                return {k: v[r0:r1] for k, v in batch.items()}
        rows = bufs["tokens"].shape[0] // accum
        # each microbatch's whole token count, reduced before dividing
        cnts = [torch.clamp((labels[i * rows:(i + 1) * rows] >= 0)
                            .float().sum(), min=1.0) for i in range(accum)]
        blocks = spmd.compute_blocks(rows, bufs["tokens"].sharding.parts(0),
                                     bufs["tokens"].shape[1] + cfg.n_patches,
                                     spmd.moe_chunk(cfg))

        def grad(unit, r0, r1):
            cnt = cnts[r0 // rows]

            def loss_of(p, b):
                return tf.loss_sums(p, b, cfg, remat=self.remat)[0] / cnt

            loss, g = unit_value_and_grad(loss_of, unit, rows_of(r0, r1))
            return {"loss": loss, "grads": g}

        out = spmd.over_blocks(
            params, [(i * rows + r0, i * rows + r1) for i in range(accum)
                     for r0, r1 in blocks], grad, "sum",
            split=tf.tp_split(cfg, mesh.shape.get("model", 1)),
            microbatches=accum)
        loss, acc = out["loss"], out["grads"]
        if accum > 1:
            acc = spmd.unit_map(lambda g: g / accum, acc)
            loss = loss / accum
        # every distinct block of every leaf this process holds updated
        # once, on the first of its positions that holds it, then copied
        # to the others that hold it
        views, held = [], []
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(acc),
                              tree_leaves(opt["m"]), tree_leaves(opt["v"])):
            holders: dict = {}
            for q in p.local_shards():
                holders.setdefault(p.sharding.block(q, p.ndim), []).append(q)
            for qs in holders.values():
                q0 = qs[0]
                views.append((p.shards[q0], spmd.local_grad(p, g, q0),
                              m.shards[q0], v.shards[q0]))
                held.append([(p.shards[q], m.shards[q], v.shards[q])
                             for q in qs[1:]])
        steps = list(opt["step"].local_shards().values())
        col = [dict(enumerate(x[j] for x in views)) for j in range(4)]
        metrics = adamw_update_(col[1], {"m": col[2], "v": col[3],
                                         "step": steps[0]},
                                col[0], self.oc, norm=global_norm(dict(
                                    enumerate(spmd.unit_leaves(acc)))))
        for (p0, _, m0, v0), others in zip(views, held):
            for p_, m_, v_ in others:
                p_.copy_(p0)
                m_.copy_(m0)
                v_.copy_(v0)
        for s_ in steps[1:]:
            s_.copy_(steps[0])
        metrics["loss"] = loss
        return metrics

    def __call__(self, params, opt_state, batch: dict):
        params = place(params, self.pshard)
        opt_state = place({k: opt_state[k] for k in ("m", "v", "step")},
                          self.oshard)
        if not self.donate:
            params, opt_state = _copy_placed(params), _copy_placed(opt_state)
        bufs = self._load_batch(batch)
        self._cur = (params, opt_state, bufs)
        env = spmd.shard_env({"params": params, "opt": opt_state,
                              "batch": bufs}, "")
        try:
            metrics = self.runner(env)
        finally:
            self._cur = None
        return params, opt_state, metrics


def _copy_placed(tree):
    return tree_map(lambda a: PlacedArray(
        a.sharding, a.shape,
        [None if s is None else s.clone() for s in a.shards]), tree)


def jit_train_step(cfg: ArchConfig, mesh, params_or_shapes, batch_like,
                   oc: OptConfig | None = None, *, accum: int = 1,
                   remat: bool = True, donate: bool = True,
                   jit: bool = True) -> ShardedTrainStep:
    """The train step with explicit in / out shardings over ``mesh`` (the
    reference's ``jit_train_step``): parameters and AdamW state by
    ``param_specs``, the batch by ``batch_specs``; state donated.  On the
    card it is captured into one CUDA graph (``jit=False``: eager)."""
    pspecs = param_specs(params_or_shapes, mesh, cfg)
    bspecs = batch_specs(batch_like, mesh)
    return ShardedTrainStep(cfg, mesh, pspecs, bspecs, oc, accum=accum,
                            remat=remat, donate=donate, jit=jit)


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

    ``mesh`` is accepted and not read, as in the reference: parameters
    placed on a mesh (:func:`~repro_torch.distributed.sharding.place`,
    ``resume(shardings=...)``) run the sharded step
    (:class:`ShardedTrainStep`) over their placement, its state written in
    place, and checkpoints store the gathered leaves.
    """
    del mesh
    oc = oc or OptConfig()
    report = TrainReport()
    if params is None:
        params = _init_params(cfg, seed, device)
    if _placed(params):
        first = tree_leaves(params)[0].sharding.mesh
        if opt_state is None:
            opt_state = place(adamw_init(tree_map(lambda a: a.gather(),
                                                  params)),
                              train_state_shardings(params, first, cfg)["opt"])
        runner = _MeshRunner(cfg, first, params, opt_state, oc, remat, jit)
    else:
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


class _MeshRunner:
    """``train``'s runner over placed state: the :class:`ShardedTrainStep`
    of the placement's specs, built at the first batch."""

    def __init__(self, cfg, mesh, params, opt_state, oc, remat, jit):
        self.cfg, self.mesh, self.oc = cfg, mesh, oc
        self.params, self.opt_state = params, opt_state
        self.remat, self.jit = remat, jit
        self.step = None

    def __call__(self, batch: dict) -> dict:
        if self.step is None:
            pspecs = tree_map(lambda a: a.sharding.spec, self.params)
            self.step = ShardedTrainStep(
                self.cfg, self.mesh, pspecs, batch_specs(batch, self.mesh),
                self.oc, remat=self.remat, jit=self.jit)
        _, _, metrics = self.step(self.params, self.opt_state, batch)
        return metrics


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
    restart path).  With ``shardings`` (a ``{"params", "opt"}`` tree of
    :class:`~repro_torch.distributed.sharding.NamedSharding`, e.g.
    :func:`train_state_shardings`) each leaf is placed by its sharding and
    training continues on that mesh — a smaller one after losing hosts is
    the elastic restart."""
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


__all__ = ["Heartbeat", "ShardedTrainStep", "SimulatedFailure",
           "StepTimeMonitor", "TrainReport", "TrainStep", "build_train_step",
           "jit_train_step", "resume", "resume_compiled", "train",
           "train_compiled", "train_state_shardings", "value_and_grad"]
