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

Not ported yet, each raising :class:`NotImplementedError` with its
``ROADMAP.md`` item: ``grad=`` (Queue 1 item 5), artifacts —
``export``/``load`` (item 6), ``autotune=`` (item 9), ``mesh=`` (item 11).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.core import frontend
from repro_torch.core.compiler import (CodoOptions, CompiledDataflow, _UNSET,
                                       codo_opt)
from repro_torch.core.graph import DataflowGraph

F = frontend
ShapedBuffer = frontend.ShapedBuffer
buffer = frontend.buffer
trace = frontend.trace
TraceError = frontend.TraceError


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch package "
                               f"yet (ROADMAP.md, Queue 1 {item})")


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
        self._bindings: dict[str, Any] = {}
        self._lowered = None

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

    # ---- execution -------------------------------------------------------
    def lower(self):
        """The lowered step runner (memoized)."""
        if self._lowered is None:
            from repro_torch.core.lowering import lower
            self._lowered = lower(self.compiled, device=self.device)
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

    def __call__(self, *values, **named):
        """Run the compiled design.  Returns one tensor per traced output
        (a bare tensor for single-output programs, a tuple otherwise)."""
        out = self.lower()(self.make_env(*values, **named))
        vals = tuple(out[n] for n in self.output_names)
        return vals[0] if len(vals) == 1 else vals

    def verify(self, *values, rtol: float = 1e-5, atol: float = 1e-5,
               **named) -> None:
        """Check the lowered design against the un-optimized oracle (the
        source graph executed task by task, on the same device) on these
        inputs.  The default band is the reference's; a caller on the card
        states its own where the kernels sum in another order."""
        from repro_torch.core.lowering import assert_outputs_close
        env = self.make_env(*values, **named)
        assert_outputs_close(self.lower()(env), self.source.execute(env),
                             rtol=rtol, atol=atol,
                             what="diverged after lowering")

    # ---- not ported yet --------------------------------------------------
    def autotune(self, **_kw):
        raise _not_ported("autotune", "item 9")

    def export(self, *_a, **_kw):
        raise _not_ported("artifact export", "item 6")


def _io_from_graph(graph: DataflowGraph) -> tuple[list[str], list[str]]:
    return ([b.name for b in graph.inputs()],
            [b.name for b in graph.outputs()])


def compile(fn: Callable | DataflowGraph, *specs,  # noqa: A001 — the API name
            device=None, options: CodoOptions | None = None,
            name: str | None = None, cache=_UNSET, autotune: bool = False,
            mesh=None, grad: bool = False, **codo_kwargs) -> CompiledProgram:
    """Trace ``fn`` over ``specs`` (shape tuples / :func:`buffer` protos)
    and compile it through the ``codo_opt`` pipeline for ``device``
    (CUDA when ``None``; see :func:`resolve_device`).

    ``fn`` may also be a ready :class:`DataflowGraph` (then ``specs`` must
    be empty).  ``options`` defaults to the full opt5 pipeline;
    ``cache=None`` disables memoization for this call.  Extra keyword
    arguments are forwarded to :func:`~repro_torch.core.compiler.codo_opt`.
    """
    if grad:
        raise _not_ported("grad=True (the compiled train step)", "item 5")
    if mesh is not None:
        raise _not_ported("mesh= (sharded programs)", "item 11")
    if autotune:
        raise _not_ported("autotune=True", "item 9")
    device = resolve_device(device)
    if isinstance(fn, DataflowGraph):
        if specs:
            raise TraceError("compile(graph) takes no input specs — the "
                             "graph already declares its buffers")
        source, ins, outs = fn, *_io_from_graph(fn)
        if name is not None and name != source.name:
            raise TraceError(f"compile(graph, name={name!r}) cannot rename "
                             f"graph {source.name!r}")
    else:
        source, ins, outs = frontend.trace_io(fn, *specs, name=name)
    compiled = codo_opt(source, options, cache=cache, **codo_kwargs)
    return CompiledProgram(source, compiled, ins, outs, device)


def load(path) -> CompiledProgram:
    """Reconstruct a program from an exported artifact — not ported yet."""
    raise _not_ported("artifact load", "item 6")


__all__ = ["CodoOptions", "CompiledProgram", "F", "ShapedBuffer",
           "TraceError", "buffer", "compile", "load", "params_from_numpy",
           "resolve_device", "trace"]
