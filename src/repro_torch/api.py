"""repro_torch.api — the ``codo_torch`` frontend: one callable from
function to design, running on PyTorch tensors.

The counterpart of ``repro/api.py`` (``import codo_torch`` works too, via
the ``src/codo_torch.py`` alias):

.. code-block:: python

    import codo_torch

    def model(x):
        h = codo_torch.F.fc(x, 512, relu=True)
        return codo_torch.F.fc(h, 512) + x

    program = codo_torch.compile(model, (64, 512))     # trace -> codo_opt
    y = program(x_tensor)                              # lower + execute
    program.export("design.json", weights=True)        # portable artifact
    same = codo_torch.load("design.json")              # on the card again

``compile`` traces the function, runs the six-pass ``codo_opt`` pipeline
(the reference's own code) and wraps the result in a
:class:`CompiledProgram` bound to a device: CUDA unless the caller asks
for the CPU.  There is no silent fallback — with no card present
``compile(..., device=None)`` raises.

Calling convention (the reference's): positional values bind to the
traced function's parameters in order; keyword values override any input
or weight buffer by name.  Values may be tensors or numpy arrays; every
value becomes a tensor at its buffer's declared dtype on the program's
device.  Unbound weights fall back to the shape-keyed
:func:`~repro_torch.core.frontend.weight_init`; bind real parameters with
:meth:`CompiledProgram.bind`, or carry a reference run's numpy weights
across with :func:`params_from_numpy`.

``compile(fn, *specs, grad=True)`` differentiates a scalar-loss function
instead and returns a :class:`CompiledTrainStep`: forward, backward and
AdamW-update graphs, each through the same pipeline, running on the
program's device (:func:`train_state_from_numpy` carries a reference
run's parameters and optimizer state across).  ``wrt=`` names the buffers
to differentiate: weights by default, or inputs of a function that has
none (a recurrence block's operands); the other inputs are then passed
by name to ``step``.

``export`` writes the reference's schema-1.5 JSON artifact
(:mod:`repro_torch.core.artifact`) of a program or a train step, with its
weights if asked; :func:`load` reads an artifact written by either
package back onto a device.  Provenance records a traced function under
its reference counterpart's module (``repro.…``), so the two packages'
exports of one model diff clean; the ``generator`` field tells them apart.

``autotune`` (or ``compile(..., autotune=True)``) times every matched
chain routed and generic on the program's device and records the winners
in the tuning database, which the routing gate then prefers to its
prediction (:mod:`repro_torch.core.tuning`).

``compile(..., mesh=)`` (or :meth:`CompiledProgram.shard`) partitions the
design across a mesh (:mod:`repro_torch.distributed.partition`); calls
then run the sharded lowering, one process driving every position in
lockstep as the reference's ``shard_map`` does (README, "PyTorch / H100
port").
A :class:`~repro_torch.launch.mesh.Mesh` names the positions' devices
(``make_debug_mesh`` puts them all on one device); a pure-data
:class:`~repro_torch.distributed.plan.MeshSpec` is placed at the first
lowering, on the CPU for a CPU program and on one card a position
otherwise.  Inside ranks (one process a card, :mod:`repro_torch.launch.
ranks`) the mesh is a :func:`~repro_torch.launch.mesh.rank_mesh`: each
rank runs its own positions and gets the whole outputs, and ``verify()``
checks them on every rank.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.core import frontend
from repro_torch.core.autodiff import TrainGraphs, build_train_graphs
from repro_torch.core.compiler import (CodoOptions, CompiledDataflow, _UNSET,
                                       codo_opt)
from repro_torch.core.graph import DataflowGraph
from repro_torch.core.ops import full_f32_convolutions

F = frontend
ShapedBuffer = frontend.ShapedBuffer
buffer = frontend.buffer
trace = frontend.trace
TraceError = frontend.TraceError


def resolve_device(device=None):
    """The program's ``torch.device``: CUDA when ``device`` is None — and
    then a card must be present — else the device asked for."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("codo_torch programs run on a CUDA device and "
                               "none is available; pass device='cpu' to run "
                               "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(dtype):
    """The torch dtype of a numpy dtype (a buffer's declared type)."""
    import torch
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _as_buffer_tensor(buf, value, device):
    """``value`` as a tensor at ``buf``'s declared dtype on ``device``
    (numpy float64 input becomes float32 where the buffer says so)."""
    import torch
    if not isinstance(value, torch.Tensor):
        value = np.asarray(value)
    return torch.as_tensor(value, dtype=torch_dtype(buf.dtype), device=device)


def params_from_numpy(arrays: dict[str, Any], graph: DataflowGraph,
                      device) -> dict[str, Any]:
    """Named numpy values (as the reference's ``CompiledProgram.bind``
    takes them) as tensors at each buffer's declared dtype on ``device`` —
    how a reference run's parameters carry across to the port."""
    out = {}
    for name, value in arrays.items():
        buf = graph.buffers.get(name)
        if buf is None or buf.kind not in ("weight", "input"):
            raise KeyError(f"no bindable buffer {name!r} in {graph.name}")
        if tuple(np.shape(value)) != tuple(buf.shape):
            raise ValueError(f"buffer {name!r} expects shape "
                             f"{tuple(buf.shape)}, got {tuple(np.shape(value))}")
        out[name] = _as_buffer_tensor(buf, value, device)
    return out


class CompiledProgram:
    """A compiled dataflow design with a function calling convention, on
    one device.

    Wraps the :class:`~repro_torch.core.compiler.CompiledDataflow` the
    pipeline produced plus the trace's io contract.  Lowering happens
    lazily on first call and is memoized by the lowering cache, keyed on
    the design's structural hash and the routing state of its backend.
    """

    def __init__(self, source: DataflowGraph, compiled: CompiledDataflow,
                 input_names: Sequence[str], output_names: Sequence[str],
                 device):
        self.source = source                  # pre-pass graph (the oracle)
        self.compiled = compiled
        self.input_names = list(input_names)
        self.output_names = list(output_names)
        self.device = device
        self.origin: str | None = None        # trace provenance (v1.5)
        self._provenance: dict | None = None  # as loaded from an artifact
        self._bindings: dict[str, Any] = {}
        self._sharding = None                 # ShardingPlan | None
        self._mesh = None                     # the plan's Mesh, once placed
        self._lowered = None
        self._lowered_key: tuple | None = None

    # ---- introspection ---------------------------------------------------
    @property
    def graph(self) -> DataflowGraph:
        """The optimized (post-pass) graph."""
        return self.compiled.graph

    @property
    def diagnostics(self):
        return self.compiled.diagnostics

    @property
    def cost(self):
        """Modeled :class:`~repro_torch.core.costmodel.GraphCost`."""
        return self.compiled.final

    @property
    def speedup(self) -> float:
        return self.compiled.speedup

    @property
    def fifo_fraction(self) -> float:
        return self.compiled.fifo_fraction

    @property
    def cache_hit(self) -> bool:
        return self.compiled.cache_hit

    @property
    def compile_seconds(self) -> float:
        return self.compiled.compile_seconds

    @property
    def schedule_report(self):
        return self.compiled.schedule_report

    def report(self) -> str:
        return self.compiled.report()

    def __repr__(self) -> str:
        ins = ", ".join(self.input_names)
        outs = ", ".join(self.output_names)
        return (f"CompiledProgram({self.graph.name}: ({ins}) -> ({outs}) "
                f"on {self.device}, speedup {self.speedup:.1f}x, "
                f"{'cache hit' if self.cache_hit else 'compiled'})")

    # ---- parameters ------------------------------------------------------
    def _bindable(self, name: str):
        buf = self.graph.buffers.get(name)
        if buf is None or buf.kind not in ("weight", "input"):
            known = sorted(b.name for b in self.graph.buffers.values()
                           if b.kind in ("weight", "input"))
            raise KeyError(f"no bindable buffer {name!r} (intermediates are "
                           f"produced by the design and cannot be "
                           f"overridden); inputs/weights: {known}")
        return buf

    def _tensor(self, buf, value):
        shape = tuple(getattr(value, "shape", np.shape(value)))
        if shape != tuple(buf.shape):
            raise ValueError(f"buffer {buf.name!r} expects shape "
                             f"{tuple(buf.shape)}, got {shape}")
        return _as_buffer_tensor(buf, value, self.device)

    def bind(self, **values) -> "CompiledProgram":
        """Attach concrete values for weight (or input) buffers by name."""
        for name, value in values.items():
            self._bindings[name] = self._tensor(self._bindable(name), value)
        return self

    # ---- sharding --------------------------------------------------------
    @property
    def sharding(self):
        """The :class:`~repro_torch.distributed.plan.ShardingPlan`, or None
        for a single-device program."""
        return self._sharding

    @property
    def mesh(self):
        """The :class:`~repro_torch.launch.mesh.Mesh` a sharded program
        runs on (placed at the first lowering when the plan came with a
        pure-data mesh), or None."""
        return self._mesh

    def shard(self, mesh, strategy: str = "auto") -> "CompiledProgram":
        """Partition this design across ``mesh`` — a
        :class:`~repro_torch.launch.mesh.Mesh`, whose devices must be of
        the program's device type, or a pure-data
        :class:`~repro_torch.distributed.plan.MeshSpec`, placed at the
        first lowering (every position on the CPU for a CPU program, one
        card a position otherwise).  The plan enters the lowering memo key
        and travels in the v1.4 artifact; later calls run the sharded
        lowering.  ``shard(None)`` reverts to the single-device program."""
        from repro_torch.distributed.partition import partition
        from repro_torch.launch.mesh import Mesh
        if mesh is None:
            self._sharding = self._mesh = None
        else:
            placed = mesh if isinstance(mesh, Mesh) else None
            if placed is not None:
                wrong = [str(d) for d in placed.distinct_devices
                         if d.type != self.device.type]
                if wrong:
                    raise ValueError(
                        f"mesh positions on {wrong} differ from the "
                        f"program's device {self.device}: compile on that "
                        f"device, or build the mesh on {self.device}")
            self._sharding = partition(self.compiled, mesh, strategy)
            self._mesh = placed
        self._lowered = None
        return self

    # ---- execution -------------------------------------------------------
    def lower(self, jit: bool = True):
        """The lowered step runner (memoized per ``jit`` flag and sharding
        plan): captured into a CUDA graph per input signature on the card
        when ``jit``, eager otherwise (:func:`~repro_torch.core.lowering.
        lower`)."""
        plan = self._sharding
        key = (bool(jit), plan.digest() if plan is not None else "")
        if self._lowered is None or self._lowered_key != key:
            from repro_torch.core.lowering import lower, place_sharding
            if plan is not None and self._mesh is None:
                self._mesh = place_sharding(plan, device=self.device)
            self._lowered = lower(self.compiled, jit=jit, device=self.device,
                                  sharding=plan, mesh=self._mesh)
            self._lowered_key = key
        return self._lowered

    def make_env(self, *values, **named) -> dict[str, Any]:
        """The full execution environment for one call: positional values
        mapped onto the traced inputs, keyword overrides, bound weights,
        and shape-keyed defaults for the rest — all tensors on the
        program's device."""
        if len(values) > len(self.input_names):
            raise TypeError(f"{self.graph.name} takes {len(self.input_names)} "
                            f"positional inputs {self.input_names}, "
                            f"got {len(values)}")
        env = dict(self._bindings)
        for name, value in zip(self.input_names, values):
            env[name] = self._tensor(self.graph.buffers[name], value)
        for name, value in named.items():
            env[name] = self._tensor(self._bindable(name), value)
        missing = [n for n in self.input_names if n not in env]
        if missing:
            raise TypeError(f"missing inputs {missing} "
                            f"(signature: {self.input_names})")
        for b in self.graph.weights():
            if b.name not in env:
                env[b.name] = _as_buffer_tensor(
                    b, frontend.weight_init(b.shape, b.dtype), self.device)
        return env

    def __call__(self, *values, jit: bool = True, **named):
        """Run the compiled design.  Returns one tensor per traced output
        (a bare tensor for single-output programs, a tuple otherwise)."""
        out = self.lower(jit=jit)(self.make_env(*values, **named))
        vals = tuple(out[n] for n in self.output_names)
        return vals[0] if len(vals) == 1 else vals

    def verify(self, *values, rtol: float | None = None,
               atol: float | None = None, **named) -> None:
        """Check the lowered design against the un-optimized oracle (the
        source graph executed task by task, on the same device) on these
        inputs.  The default band is the reference's: 1e-5, widened for a
        sharded program (verified through its multi-device lowering) to
        the fp-reassociation band of ``lowering.verify_sharding``, rtol
        1e-4 / atol 5e-5.  A caller on the card states its own where the
        kernels sum in another order."""
        from repro_torch.core.lowering import assert_outputs_close
        sharded = self._sharding is not None
        rtol = (1e-4 if sharded else 1e-5) if rtol is None else rtol
        atol = (5e-5 if sharded else 1e-5) if atol is None else atol
        env = self.make_env(*values, **named)
        assert_outputs_close(self.lower(jit=False)(env),
                             self.source.execute(env),
                             rtol=rtol, atol=atol,
                             what="diverged after lowering")

    # ---- autodiff --------------------------------------------------------
    def value_and_grad(self, *, opt=None, wrt=None) -> "CompiledTrainStep":
        """Differentiate this program's source graph and compile the
        forward/backward/update triple through the same pass pipeline —
        the method form of ``compile(fn, ..., grad=True)``."""
        return _compile_train_step(self.source, self.device,
                                   options=self.compiled.options, opt=opt,
                                   wrt=wrt, origin=self.origin)

    # ---- artifacts -------------------------------------------------------
    def export(self, path: str | None = None, *,
               weights: "bool | dict | None" = None, sidecar: bool = False):
        """Write (or return) the schema-1.5 JSON artifact of this design
        (``docs/artifact_format.md``), which either package's ``load``
        reads.  ``weights=True`` embeds every weight buffer's value —
        bound tensors first, the shape-keyed initializer for the rest — so
        the artifact is a self-contained served model; a dict ships
        specific values, and ``sidecar=True`` writes them to
        ``<path>.weights.npz`` instead of base64 in the JSON.  A design
        not lowered yet records the routing its device's gate decides.  A
        sharded program also writes its plan into the v1.4 ``sharding``
        section (the mesh's shape, never its devices)."""
        from repro_torch.core.artifact import export_artifact
        from repro_torch.core.costmodel import routing_backend
        if weights is True:
            weights = {b.name: (self._bindings[b.name]
                                if b.name in self._bindings
                                else frontend.weight_init(b.shape, b.dtype))
                       for b in self.graph.weights()}
        return export_artifact(self.compiled, path, weights=weights,
                               weights_sidecar=sidecar,
                               sharding=self._sharding,
                               provenance=self.provenance(),
                               backend=routing_backend(self.device))

    def provenance(self) -> dict:
        """The v1.5 ``provenance`` section: the pre-pass source graph's
        structural hash and the trace origin (a loaded program returns the
        section its artifact stored)."""
        if self._provenance is not None:
            return dict(self._provenance)
        return {"source_structural_hash": self.source.structural_hash(),
                "origin": self.origin or f"graph:{self.source.name}"}

    # ---- autotuning ------------------------------------------------------
    def autotune(self, *, repeats: int = 5, warmup: int = 2, seed: int = 0,
                 save_path: str | None = None, db=None) -> list:
        """Measure routed-vs-generic for every pattern-matched chain of
        this design on the program's device and persist the winners in the
        tuning database (``db``, the process default when ``None``) —
        later :meth:`lower`/calls route on the measurement instead of the
        prediction (the default database's digest is in the lowering memo
        key, so the switch is automatic; a private ``db`` only collects
        records).  Returns the new
        :class:`~repro_torch.core.tuning.TuningRecord`\\ s."""
        from repro_torch.core.tuning import autotune_compiled
        records = autotune_compiled(self.compiled, device=self.device, db=db,
                                    repeats=repeats, warmup=warmup, seed=seed,
                                    save_path=save_path)
        self._lowered = None            # re-route against the measurements
        return records


def _io_from_graph(graph: DataflowGraph) -> tuple[list[str], list[str]]:
    return ([b.name for b in graph.inputs()],
            [b.name for b in graph.outputs()])


class CompiledTrainStep:
    """A training step compiled end to end through the pass pipeline, on
    one device.

    Three linked :class:`CompiledProgram`\\ s — ``forward`` (loss +
    residuals), ``backward`` (cotangent walk, built by
    :mod:`repro_torch.core.autodiff`), ``update`` (AdamW + global-norm
    clip + warmup-cosine schedule as registry ops) — each through fusion,
    violation elimination, cost-gated kernel routing and the compile
    cache.  The backward's matmul → gradient-epilogue chains route to the
    ``streamfuse.mmgrad`` kernel when the cost gate approves (or under
    ``CODO_FORCE_PALLAS=1``).

    Every value lives on the program's device: residuals pass from the
    forward to the backward as tensors, optimizer state is tensors, and
    :meth:`step` returns its metrics as 0-d tensors without a host sync.
    """

    def __init__(self, source: DataflowGraph, graphs: TrainGraphs,
                 forward: CompiledProgram, backward: CompiledProgram,
                 update: CompiledProgram):
        self.source = source            # pre-pass loss graph (the oracle)
        self.graphs = graphs
        self.forward = forward
        self.backward = backward
        self.update = update
        self.device = forward.device
        self.input_names = [b.name for b in source.inputs()]
        self.param_names = list(graphs.params)
        self.origin: str | None = None
        self._provenance: dict | None = None
        self._initial_params: dict | None = None   # artifact-carried weights

    # ---- state -----------------------------------------------------------
    def init_params(self) -> dict:
        """Initial parameters as tensors on the device: the weights the
        artifact this step was loaded from carries, else the deterministic
        shape-keyed ``weight_init``."""
        if self._initial_params is not None:
            return params_from_numpy(self._initial_params, self.source,
                                     self.device)
        names = set(self.param_names)
        return {b.name: _as_buffer_tensor(
                    b, frontend.weight_init(b.shape, b.dtype), self.device)
                for b in self.source.weights() if b.name in names}

    def init_opt_state(self, params: dict | None = None) -> dict:
        """Fresh AdamW state, zeros on the device, in the reference's
        format: ``{"m": {...}, "v": {...}, "step": int32 scalar}``."""
        import torch
        shapes = {w: tuple(self.source.buffers[w].shape)
                  for w in self.param_names}
        if params is not None:
            shapes = {w: tuple(params[w].shape) for w in self.param_names}

        def zeros():
            return {w: torch.zeros(s, dtype=torch.float32, device=self.device)
                    for w, s in shapes.items()}

        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32, device=self.device)}

    # ---- execution -------------------------------------------------------
    def value_and_grad(self, *arrays, params: dict | None = None,
                       jit: bool = True, **named):
        """Run the compiled forward and backward graphs; returns ``(loss,
        grads)``: the (1, 1) loss tensor and the gradients keyed by
        parameter name.  ``jit`` as for :meth:`CompiledProgram.lower`."""
        import torch
        g = self.graphs
        params = dict(params) if params is not None else self.init_params()
        fenv = self.forward.make_env(*arrays, **params, **named)
        fouts = self.forward.lower(jit=jit)(fenv)
        benv = {g.seeds[g.loss]: torch.ones((1, 1), dtype=torch.float32,
                                            device=self.device)}
        for r in g.residuals:
            benv[r] = fouts[r] if r in fouts else fenv[r]
        bouts = self.backward.lower(jit=jit)(self.backward.make_env(**benv))
        grads = {w: bouts[g.grads[w]] for w in self.param_names}
        return fouts[g.loss], grads

    def step(self, params: dict, opt_state: dict, *arrays,
             jit: bool = True, **named):
        """One full training step: forward, backward, AdamW update.
        Returns ``(new_params, new_opt_state, metrics)``; metrics carries
        0-d tensors ``loss``, ``grad_norm`` and ``lr``.  No host sync."""
        import torch
        loss, grads = self.value_and_grad(*arrays, params=params, jit=jit,
                                          **named)
        step = torch.as_tensor(opt_state["step"], device=self.device)
        uenv = {"step": step.to(torch.float32).reshape(1, 1)}
        for w in self.param_names:
            uenv[w] = params[w]
            uenv[f"grad_{w}"] = grads[w]
            uenv[f"m_{w}"] = opt_state["m"][w]
            uenv[f"v_{w}"] = opt_state["v"][w]
        uouts = self.update.lower(jit=jit)(self.update.make_env(**uenv))
        new_params = {w: uouts[f"new_{w}"] for w in self.param_names}
        new_state = {"m": {w: uouts[f"new_m_{w}"] for w in self.param_names},
                     "v": {w: uouts[f"new_v_{w}"] for w in self.param_names},
                     "step": uouts["new_step"].reshape(()).to(torch.int32)}
        metrics = {"loss": loss.reshape(()),
                   "grad_norm": uouts["grad_norm"].reshape(()),
                   "lr": uouts["lr"].reshape(())}
        return new_params, new_state, metrics

    def verify(self, *arrays, params: dict | None = None,
               rtol: float = 2e-3, atol: float = 1e-4, **named) -> dict:
        """Check the compiled loss and gradients against
        ``torch.autograd.grad`` through the source graph executed task by
        task (the oracle), on the same device, within the reference's
        band.  Returns ``{"loss" or parameter: (max abs error, max abs
        oracle value)}``, so a caller can hold each tensor to a band of its
        own scale."""
        import torch
        g = self.graphs
        params = dict(params) if params is not None else self.init_params()
        loss, grads = self.value_and_grad(*arrays, params=params, **named)
        env = self.forward.make_env(*arrays, **params, **named)
        leaves = [env[w].detach().clone().requires_grad_(True)
                  for w in self.param_names]
        env.update(zip(self.param_names, leaves))
        ref_loss = self.source.execute(env)[g.loss].reshape(())
        # The oracle's conv gradients in full float32, as its conv2d body
        # runs: autograd's backward convolutions read cuDNN's TF32 flag.
        with full_f32_convolutions():
            ref_grads = torch.autograd.grad(ref_loss, leaves,
                                            allow_unused=True)
        pairs = {"loss": (_host(loss).reshape(()), _host(ref_loss))}
        for w, leaf, ref in zip(self.param_names, leaves, ref_grads):
            pairs[w] = (_host(grads[w]),
                        _host(torch.zeros_like(leaf) if ref is None else ref))
        for name, (got, want) in pairs.items():
            what = name if name == "loss" else f"grad {name}"
            np.testing.assert_allclose(
                got, want, rtol=rtol, atol=atol,
                err_msg=f"{what} diverged from torch.autograd through the "
                        f"oracle")
        return {name: (float(np.abs(got - want).max()),
                       float(np.abs(want).max()))
                for name, (got, want) in pairs.items()}

    # ---- introspection and tooling ---------------------------------------
    def report(self) -> str:
        lines = [f"train step {self.source.name}: "
                 f"{len(self.param_names)} params, "
                 f"{len(self.graphs.residuals)} residuals"]
        for tag, p in (("forward", self.forward), ("backward", self.backward),
                       ("update", self.update)):
            lines.append(f"-- {tag} " + "-" * max(1, 60 - len(tag)))
            lines.append(p.report())
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"<CompiledTrainStep {self.source.name} "
                f"params={len(self.param_names)} on {self.device} "
                f"fwd={len(self.forward.graph.tasks)}t "
                f"bwd={len(self.backward.graph.tasks)}t "
                f"upd={len(self.update.graph.tasks)}t>")

    def autotune(self, **kw) -> list:
        """Autotune all three phases' routed chains (see
        :meth:`CompiledProgram.autotune`)."""
        records = []
        for p in (self.forward, self.backward, self.update):
            records += p.autotune(**kw)
        return records

    # ---- artifacts -------------------------------------------------------
    def provenance(self) -> dict:
        if self._provenance is not None:
            return dict(self._provenance)
        return {"source_structural_hash": self.source.structural_hash(),
                "origin": self.origin or f"graph:{self.source.name}"}

    def export(self, path: str | None = None, *,
               weights: "bool | dict | None" = None):
        """Write (or return) the v1.5 train-step artifact (``kind:
        "train_step"``): the three phases' artifacts and the linking
        ``train`` section, which either package's ``load`` turns back into
        an executable step.  ``weights=True`` embeds :meth:`init_params`
        in the forward phase."""
        from repro_torch.core.artifact import export_train_step_artifact
        from repro_torch.core.costmodel import routing_backend
        g = self.graphs
        if weights is True:
            weights = self.init_params()
        train = {"loss": g.loss, "seeds": dict(g.seeds),
                 "residuals": list(g.residuals), "grads": dict(g.grads),
                 "params": list(g.params), "opt": dict(g.opt)}
        return export_train_step_artifact(
            {"forward": self.forward.compiled,
             "backward": self.backward.compiled,
             "update": self.update.compiled},
            train, path, weights=weights, provenance=self.provenance(),
            backend=routing_backend(self.device))


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _compile_train_step(source: DataflowGraph, device, *, options=None,
                        cache=_UNSET, opt=None, wrt=None,
                        origin: str | None = None,
                        **codo_kwargs) -> CompiledTrainStep:
    graphs = build_train_graphs(source, oc=opt, wrt=wrt)
    progs = []
    for phase in (graphs.forward, graphs.backward, graphs.update):
        compiled = codo_opt(phase, options, cache=cache, **codo_kwargs)
        progs.append(CompiledProgram(phase, compiled, *_io_from_graph(phase),
                                     device))
    step = CompiledTrainStep(source, graphs, *progs)
    step.origin = origin or f"graph:{source.name}"
    return step


def _trace_origin(fn, source: DataflowGraph) -> str:
    """``traced:<module>.<qualname>`` of a traced function, a function of
    this package under its reference counterpart's module (``repro.…``):
    the two packages' exports of one model then carry one origin."""
    module = getattr(fn, "__module__", "?")
    if module == "repro_torch" or module.startswith("repro_torch."):
        module = "repro" + module[len("repro_torch"):]
    return f"traced:{module}.{getattr(fn, '__qualname__', source.name)}"


def train_state_from_numpy(params: dict[str, Any], opt_state: dict,
                           step: CompiledTrainStep):
    """A reference run's numpy parameters and its ``{"m", "v", "step"}``
    AdamW state as the port's: tensors on the step's device, parameters at
    their declared dtype, moments float32, the counter an int32 scalar.
    Returns ``(params, opt_state)``, ready for
    :meth:`CompiledTrainStep.step`, which then takes the reference's step
    from the same state."""
    import torch
    device = step.device
    missing = sorted(set(step.param_names) - set(params))
    if missing:
        raise KeyError(f"parameters missing: {missing}")
    out = params_from_numpy(params, step.source, device)

    def moments(key):
        got = {}
        for w in step.param_names:
            value = np.asarray(opt_state[key][w], np.float32)
            if value.shape != tuple(out[w].shape):
                raise ValueError(f"{key}[{w!r}] has shape {value.shape}, "
                                 f"the parameter {tuple(out[w].shape)}")
            got[w] = torch.as_tensor(value, device=device)
        return got

    counter = np.asarray(opt_state["step"]).astype(np.int32).reshape(())
    return out, {"m": moments("m"), "v": moments("v"),
                 "step": torch.as_tensor(counter, device=device)}


def compile(fn: Callable | DataflowGraph, *specs,  # noqa: A001 — the API name
            device=None, options: CodoOptions | None = None,
            name: str | None = None, cache=_UNSET, autotune: bool = False,
            mesh=None, sharding_strategy: str = "auto", grad: bool = False,
            opt=None, wrt=None,
            **codo_kwargs) -> "CompiledProgram | CompiledTrainStep":
    """Trace ``fn`` over ``specs`` (shape tuples / :func:`buffer` protos)
    and compile it through the ``codo_opt`` pipeline for ``device``
    (CUDA when ``None``; see :func:`resolve_device`).

    ``fn`` may also be a ready :class:`DataflowGraph` (then ``specs`` must
    be empty).  ``options`` defaults to the full opt5 pipeline;
    ``cache=None`` disables memoization for this call.  ``autotune=True``
    measures the design's matched chains on the device before returning
    (:meth:`CompiledProgram.autotune`).  Extra keyword arguments are
    forwarded to :func:`~repro_torch.core.compiler.codo_opt`.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh` or a
    :class:`~repro_torch.distributed.plan.MeshSpec`) makes the result a
    multi-device program (:meth:`CompiledProgram.shard`): the partitioner
    runs after the single-device pipeline, and ``sharding_strategy``
    picks the placement — ``"auto"`` prices every feasible candidate, or
    force one of ``replicate``/``dp``/``tp``/``dp_tp``.
    """
    device = resolve_device(device)
    if isinstance(fn, DataflowGraph):
        if specs:
            raise TraceError("compile(graph) takes no input specs — the "
                             "graph already declares its buffers")
        source, ins, outs = fn, *_io_from_graph(fn)
        if name is not None and name != source.name:
            raise TraceError(f"compile(graph, name={name!r}) cannot rename "
                             f"graph {source.name!r}")
        origin = f"graph:{source.name}"
    else:
        source, ins, outs = frontend.trace_io(fn, *specs, name=name)
        origin = _trace_origin(fn, source)
    if grad:
        if mesh is not None:
            raise TraceError("grad=True does not compose with mesh= yet — "
                             "shard the phases individually")
        step = _compile_train_step(source, device, options=options,
                                   cache=cache, opt=opt, wrt=wrt,
                                   origin=origin, **codo_kwargs)
        if autotune:
            step.autotune()
        return step
    if opt is not None or wrt is not None:
        raise TraceError("opt=/wrt= only apply with grad=True")
    compiled = codo_opt(source, options, cache=cache, **codo_kwargs)
    program = CompiledProgram(source, compiled, ins, outs, device)
    program.origin = origin
    if mesh is not None:
        program.shard(mesh, sharding_strategy)
    if autotune:
        program.autotune()
    return program


def load(path, *, device=None) -> "CompiledProgram | CompiledTrainStep":
    """Reconstruct a program from an artifact (a path or a parsed
    document) written by either package, on ``device`` (CUDA unless the
    caller asks for the CPU; see :func:`resolve_device`).  No recompile:
    op kinds resolve against this package's registry.  Weight payloads
    are hash-checked and bound as tensors on the device.  A train-step
    artifact (``kind: "train_step"``) gives a :class:`CompiledTrainStep`
    whose ``init_params`` are the weights it carries.  An artifact with a
    v1.4 ``sharding`` section restores its plan as it was; the plan is
    placed at the first lowering (``mesh_from_spec`` on the card, which
    raises on a host with too few cards: re-shard onto a debug mesh with
    ``program.shard(make_debug_mesh(...), program.sharding.strategy)``,
    which gives the same plan and digest)."""
    from repro_torch.core.artifact import (TRAIN_STEP_KIND, artifact_weights,
                                           import_artifact, load_artifact)
    from repro_torch.core.costmodel import routing_backend
    device = resolve_device(device)
    doc = load_artifact(path)
    if doc.get("kind") == TRAIN_STEP_KIND:
        return _load_train_step(doc, device)
    compiled = import_artifact(doc, backend=routing_backend(device))
    # The artifact carries the optimized graph only; it is its own oracle.
    program = CompiledProgram(compiled.graph, compiled,
                              *_io_from_graph(compiled.graph), device)
    # The stored provenance (the post-pass graph's hash is not the pre-pass
    # source's) travels on, so a re-export round-trips the section.
    program._provenance = doc.get("provenance")
    program._sharding = getattr(compiled, "sharding_plan", None)
    base_dir = None if isinstance(path, dict) else Path(path).parent
    bound = artifact_weights(doc, base_dir=base_dir)
    if bound:
        program.bind(**bound)
    return program


def _load_train_step(doc: dict, device) -> CompiledTrainStep:
    from repro_torch.core.artifact import import_train_step
    from repro_torch.core.costmodel import routing_backend
    phases, train, weights = import_train_step(
        doc, backend=routing_backend(device))
    graphs = TrainGraphs(
        forward=phases["forward"].graph, backward=phases["backward"].graph,
        update=phases["update"].graph, loss=train["loss"],
        seeds=dict(train["seeds"]), residuals=list(train["residuals"]),
        grads=dict(train["grads"]), params=list(train["params"]),
        opt=dict(train["opt"]))
    progs = [CompiledProgram(c.graph, c, *_io_from_graph(c.graph), device)
             for c in (phases["forward"], phases["backward"],
                       phases["update"])]
    step = CompiledTrainStep(phases["forward"].graph, graphs, *progs)
    step._provenance = doc.get("provenance")
    if weights:
        step._initial_params = weights
    return step


# --------------------------------------------------------------------------
# Smoke CLI:  python -m repro_torch.api gemm --cache-dir .codo_cache --run
# A cold and a warm invocation print `cache_hit=False` / `cache_hit=True`
# with the same `key=` (the design's structural hash), as the reference's
# `python -m repro.api` does, so one grep checks both packages.
# --------------------------------------------------------------------------

# The band ``--run`` verifies within on the card, where the kernels sum
# in another order than the oracle (the sharded band of
# ``lowering.verify_sharding``); on the CPU the reference's own.
CARD_VERIFY = dict(rtol=1e-4, atol=5e-5)


def main(argv=None) -> int:
    from repro_torch.models.dataflow_models import KERNEL_BENCHES
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="Compile one Table II kernel through codo_torch.compile().")
    ap.add_argument("workload", choices=sorted(KERNEL_BENCHES),
                    help="traced kernel workload to compile")
    ap.add_argument("--opt", default="opt5",
                    help="CodoOptions preset (default opt5)")
    ap.add_argument("--cache-dir", default="",
                    help="disk compile-cache dir (cold/warm smoke)")
    ap.add_argument("--run", action="store_true",
                    help="also execute the design on random inputs and "
                         "verify against the oracle on the device")
    ap.add_argument("--export", default="", metavar="PATH",
                    help="export the design as a JSON artifact")
    ap.add_argument("--device", default=None,
                    help="device of the program (default: the card; 'cpu' "
                         "to run on the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.core.cache import CompileCache
    cache = (CompileCache(disk_dir=args.cache_dir) if args.cache_dir
             else _UNSET)
    graph = KERNEL_BENCHES[args.workload]()
    program = compile(graph, device=args.device,
                      options=CodoOptions.preset(args.opt), cache=cache)
    print(program.report())
    print(f"codo_torch.compile({args.workload}): "
          f"cache_hit={program.cache_hit} "
          f"speedup={program.speedup:.1f}x "
          f"key={program.graph.structural_hash()[:12]}")
    if args.run:
        from repro_torch.models.dataflow_models import random_inputs
        env = random_inputs(program.source)
        band = CARD_VERIFY if program.device.type == "cuda" else {}
        program.verify(**env, **band)
        print(f"numerics verified against the oracle on "
              f"{sorted(n for n in env)} on {program.device} ✓")
    if args.export:
        program.export(args.export)
        print(f"artifact exported to {args.export}")
    return 0


__all__ = ["CodoOptions", "CompiledProgram", "CompiledTrainStep", "F",
           "ShapedBuffer", "TraceError", "buffer", "compile", "load", "main",
           "params_from_numpy", "resolve_device", "trace",
           "train_state_from_numpy"]


if __name__ == "__main__":
    raise SystemExit(main())
