"""Declarative op registry: ``Task`` numerics as data, not closures.

The PyTorch counterpart of ``repro/core/ops.py``: the same ``OpSpec``
records, registry, epochs and VJP table, with a torch body for each of the
reference's 47 kinds — every forward kind (identity, dup, fused, zeros,
fill_interior, pad2d, conv2d, relu, gelu, add, vadd, scale, affine, divc,
rdivc, div, mul, const, softmax, matmul, mv, transpose, maxpool2d, mean,
reshape, concat, split, slice, rglru_scan, ssd_scan), every gradient kind
the VJP rules emit (mean_all, bcast, outer, relu_grad, gelu_grad,
softmax_grad, conv2d_input_grad, conv2d_weight_grad, maxpool2d_grad,
slice_grad, mean_grad, rglru_scan_grad, ssd_scan_grad) and the
optimizer kinds (sumsq, clip_scale, lr_sched, adamw_step).  A kind
neither registry holds raises :class:`UnknownOpError` naming it.  Every
body runs on the device its operands are on.  No body writes in place:
``dup`` and ``identity`` alias their input, ``transpose``, ``bcast``,
``split``, ``slice`` and ``mean_grad`` return views.  ``conv2d`` and its
two gradients run in full float32 whatever
``torch.backends.cudnn.allow_tf32`` says.

Historically every :class:`~repro.core.graph.Task` carried its numeric
semantics as an opaque Python closure (``fn(env) -> {buf: array}``).  That
worked, but closures are not picklable, so

* on-disk compile-cache entries came back *stripped* — a cold-restart hit
  could be costed and verified but never lowered or executed, and
* the batch ablation driver was confined to thread pools — a ``Task``
  could not cross a process boundary.

This module replaces closures with an :class:`OpSpec` — a plain-data
record of *which* op a task computes (operand buffer names, output buffer
names, and attributes like stride/padding/axis) — plus a registry that
materializes the matching torch implementation on demand.  ``Task.fn`` is
now a derived property: tasks that carry a spec re-derive their callable
after a pickle round-trip, in any process.

OpSpec fields
-------------

``kind``
    Registry key naming the implementation (``"conv2d"``, ``"matmul"``,
    ``"relu"``, ...).  Distinct from ``Task.op``, which is the *pattern
    class* the passes reason about (a ``"conv2d"`` and a ``"dwconv2d"``
    spec are both ``op="conv"`` tasks).
``ins``
    Operand buffer names, positional.  ``env[ins[i]]`` is the i-th input
    array at execution time.
``outs``
    Output buffer names.  The implementation returns ``{out: array}`` for
    every name in ``outs``.
``attrs``
    Plain-data attributes (ints, floats, bools, strings, tuples thereof):
    stride, padding, reduction axes, scale factors...  Attributes are part
    of :meth:`signature` and therefore of
    ``DataflowGraph.structural_signature()`` — a semantic constant that
    lives in an attr automatically keys the compile cache, so two graphs
    differing only in, say, a scale factor never collide.
``parts``
    Sub-specs for the composite ``"fused"`` kind (the coarse pass merges
    multi-producer violations by fusing producers; the fused node's
    semantics are the parts run in sequence).

Pickling contract
-----------------

An ``OpSpec`` must contain only plain data: strings, numbers, bools, and
(nested) tuples/dicts of those, plus child ``OpSpec`` records in
``parts``.  Never close over arrays, modules, or callables — the whole
point is that ``pickle.dumps(spec)`` round-trips across interpreters and
that :meth:`signature` is a stable content address.  Implementations
(registered callables) stay in *code*, keyed by ``kind``: unpickling a
spec in a fresh process finds the implementation in the registry of that
process, so ships of spec'd graphs between processes only require both
sides to import the same version of this module.

Registering a new op
--------------------

.. code-block:: python

    from repro_torch.core.ops import OpSpec, register_op

    @register_op("axpy")
    def _axpy(spec, env):
        a = spec.attrs.get("a", 1.0)
        x, y = (env[b] for b in spec.ins)
        return {spec.outs[0]: a * x + y}

    # builders then attach: Task(..., spec=OpSpec("axpy", (x, y), (out,),
    #                                             {"a": 2.0}))

Implementations take ``(spec, env)`` and return a dict mapping *every*
name in ``spec.outs`` to its tensor.  torch imports belong *inside* the
implementation body — graph construction and the whole compile pipeline
stay importable without pulling in torch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable

# --------------------------------------------------------------------------
# Spec
# --------------------------------------------------------------------------


class UnknownOpError(KeyError):
    """Raised when a spec names a kind with no registered implementation."""


def _plain(value: Any) -> Any:
    """Canonical plain-data view of an attr value (lists -> tuples)."""
    if isinstance(value, (list, tuple)):
        return tuple(_plain(v) for v in value)
    return value


@dataclass
class OpSpec:
    """Declarative numeric semantics of one task — see the module docstring
    for the field-by-field contract."""

    kind: str
    ins: tuple[str, ...] = ()
    outs: tuple[str, ...] = ()
    attrs: dict[str, Any] = field(default_factory=dict)
    parts: tuple["OpSpec", ...] = ()

    def __post_init__(self):
        self.ins = tuple(self.ins)
        self.outs = tuple(self.outs)
        self.parts = tuple(self.parts)
        self.attrs = {k: _plain(v) for k, v in dict(self.attrs).items()}

    # ---- data plumbing ---------------------------------------------------
    def renamed(self, alias: dict[str, str]) -> "OpSpec":
        """Pure-data buffer rename: every operand/output name found in
        ``alias`` maps old -> new, recursively through ``parts``.  This is
        the declarative replacement for ``retarget_fn``'s env-aliasing
        closure shim."""
        return OpSpec(
            self.kind,
            tuple(alias.get(b, b) for b in self.ins),
            tuple(alias.get(b, b) for b in self.outs),
            dict(self.attrs),
            tuple(p.renamed(alias) for p in self.parts),
        )

    def copy(self) -> "OpSpec":
        return dataclasses.replace(
            self, attrs=dict(self.attrs),
            parts=tuple(p.copy() for p in self.parts))

    def buffers(self) -> set[str]:
        out = set(self.ins) | set(self.outs)
        for p in self.parts:
            out |= p.buffers()
        return out

    # ---- content addressing ----------------------------------------------
    def signature(self) -> tuple:
        """Canonical nested-tuple view: feeds
        ``DataflowGraph.structural_signature()`` so op semantics —
        including attr constants — key the compile cache."""
        return (self.kind, self.ins, self.outs,
                tuple(sorted((k, repr(v)) for k, v in self.attrs.items())),
                tuple(p.signature() for p in self.parts))

    # ---- JSON serialization (docs/artifact_format.md `spec` object) ------
    def to_dict(self) -> dict:
        """Language-neutral JSON view.  Tuples inside ``attrs`` become JSON
        arrays; :meth:`from_dict` restores them through ``__post_init__``'s
        canonicalization, so ``from_dict(to_dict(s)).signature() ==
        s.signature()`` holds for every spec obeying the plain-data
        contract."""
        out: dict = {"kind": self.kind, "ins": list(self.ins),
                     "outs": list(self.outs), "attrs": dict(self.attrs)}
        if self.parts:
            out["parts"] = [p.to_dict() for p in self.parts]
        return out

    @classmethod
    def from_dict(cls, doc: dict) -> "OpSpec":
        return cls(doc["kind"], tuple(doc.get("ins", ())),
                   tuple(doc.get("outs", ())), dict(doc.get("attrs", {})),
                   tuple(cls.from_dict(p) for p in doc.get("parts", ())))


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

# kind -> implementation(spec, env) -> {out buffer: array}
_REGISTRY: dict[str, Callable[[OpSpec, dict], dict]] = {}

# Bumped on every registration so memoized *materialized* programs (e.g.
# the lower() cache) can detect that an implementation changed underneath
# them and rebuild instead of serving stale numerics.
_EPOCH = 0


def registry_epoch() -> int:
    return _EPOCH


def register_op(kind: str):
    """Decorator: register ``fn(spec, env) -> {out: array}`` under ``kind``.
    Re-registration replaces (kernels may override reference impls)."""

    def deco(fn: Callable[[OpSpec, dict], dict]):
        global _EPOCH
        _REGISTRY[kind] = fn
        _EPOCH += 1
        return fn

    return deco


def registered_ops() -> list[str]:
    return sorted(_REGISTRY)


def op_impl(kind: str) -> Callable[[OpSpec, dict], dict]:
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise UnknownOpError(
            f"no implementation registered for op kind {kind!r}; "
            f"registered: {registered_ops()}") from None


def materialize(spec: OpSpec) -> Callable[[dict], dict]:
    """Build the executable ``env -> {out: array}`` callable for ``spec``.

    Raises :class:`UnknownOpError` eagerly (at materialization, not first
    call) so a stale spec fails loudly when a cache entry is reloaded."""
    impl = op_impl(spec.kind)

    def fn(env: dict) -> dict:
        return impl(spec, env)

    fn.spec = spec  # introspection/debugging: which spec produced this fn
    return fn


# --------------------------------------------------------------------------
# Torch implementations (lazy torch imports: the registry itself — and
# everything that builds or compiles graphs — imports without torch).
# --------------------------------------------------------------------------


@register_op("identity")
def _identity(spec: OpSpec, env: dict) -> dict:
    return {spec.outs[0]: env[spec.ins[0]]}


@register_op("dup")
def _dup(spec: OpSpec, env: dict) -> dict:
    """Coarse-pass duplicator: one private stream copy per consumer."""
    src = env[spec.ins[0]]
    return {o: src for o in spec.outs}


@register_op("fused")
def _fused(spec: OpSpec, env: dict) -> dict:
    """Coarse-pass producer fusion: run ``parts`` in order, each seeing the
    accumulated scope (earlier writes staged and merged, per Fig. 4b)."""
    out: dict = {}
    scope = dict(env)
    for part in spec.parts:
        r = materialize(part)(scope)
        scope.update(r)
        out.update(r)
    return out


def _env_device(env: dict):
    """The device of the environment's tensors (the CPU when it holds
    none): where an op with no tensor operand puts its result."""
    import torch
    for v in env.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


@register_op("zeros")
def _zeros(spec: OpSpec, env: dict) -> dict:
    """Init half of the Fig. 4b init/pad multi-producer pair: a zeroed
    canvas of ``attrs['shape']`` (no operands)."""
    import numpy as np
    import torch
    shape = tuple(int(s) for s in spec.attrs["shape"])
    dtype = np.dtype(spec.attrs.get("dtype", "float32"))
    return {spec.outs[0]: torch.zeros(
        shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
        device=_env_device(env))}


@register_op("fill_interior")
def _fill_interior(spec: OpSpec, env: dict) -> dict:
    """Fill half of the init/pad pair: the canvas the init producer staged
    under this spec's own output name, with ``x`` written into its
    interior.  The canvas is copied, not written in place."""
    import torch
    p = int(spec.attrs["pad"])
    x = env[spec.ins[0]]
    canvas = env.get(spec.outs[0])
    if canvas is None:
        n, c, h, w = x.shape
        canvas = torch.zeros((n, c, h + 2 * p, w + 2 * p), dtype=x.dtype,
                             device=x.device)
    out = canvas.clone()
    out[:, :, p:p + x.shape[2], p:p + x.shape[3]] = x
    return {spec.outs[0]: out}


@register_op("pad2d")
def _pad2d(spec: OpSpec, env: dict) -> dict:
    import torch
    p = int(spec.attrs["pad"])
    return {spec.outs[0]: torch.nn.functional.pad(env[spec.ins[0]],
                                                  (p, p, p, p))}


def full_f32_convolutions():
    """Context in which cuDNN convolutions run in full float32.  cuDNN
    takes float32 convolutions through TF32 by default
    (``torch.backends.cudnn.allow_tf32``), which keeps about three
    decimal digits; the op bodies, and the oracle that runs them, must not
    depend on that global flag.  The other cuDNN flags keep their
    values."""
    import torch
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=False)


@register_op("conv2d")
def _conv2d(spec: OpSpec, env: dict) -> dict:
    """NCHW × OIHW, VALID (the pad is its own task), in full float32
    (:func:`full_f32_convolutions`)."""
    import torch
    s = int(spec.attrs.get("stride", 1))
    g = int(spec.attrs.get("groups", 1))
    with full_f32_convolutions():
        y = torch.nn.functional.conv2d(env[spec.ins[0]], env[spec.ins[1]],
                                       stride=s, groups=g)
    return {spec.outs[0]: y}


@register_op("relu")
def _relu(spec: OpSpec, env: dict) -> dict:
    import torch
    return {spec.outs[0]: torch.relu(env[spec.ins[0]])}


@register_op("gelu")
def _gelu(spec: OpSpec, env: dict) -> dict:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    import torch
    return {spec.outs[0]: torch.nn.functional.gelu(env[spec.ins[0]],
                                                   approximate="tanh")}


@register_op("add")
def _add(spec: OpSpec, env: dict) -> dict:
    return {spec.outs[0]: env[spec.ins[0]] + env[spec.ins[1]]}


@register_op("scale")
def _scale(spec: OpSpec, env: dict) -> dict:
    return {spec.outs[0]: env[spec.ins[0]] * float(spec.attrs["s"])}


@register_op("softmax")
def _softmax(spec: OpSpec, env: dict) -> dict:
    import torch
    axis = int(spec.attrs.get("axis", -1))
    return {spec.outs[0]: torch.softmax(env[spec.ins[0]], dim=axis)}


@register_op("matmul")
def _matmul(spec: OpSpec, env: dict) -> dict:
    return {spec.outs[0]: env[spec.ins[0]] @ env[spec.ins[1]]}


@register_op("transpose")
def _transpose(spec: OpSpec, env: dict) -> dict:
    """2-D transpose by default; an optional ``perm`` attr generalizes to
    any rank (the frontend emits ``perm=(0, 2, 1)`` for batched operands).
    Both return a strided view, never a copy."""
    x = env[spec.ins[0]]
    perm = spec.attrs.get("perm")
    if perm is None:
        perm = tuple(reversed(range(x.dim())))
    return {spec.outs[0]: x.permute(*(int(p) for p in perm))}


@register_op("vadd")
def _vadd(spec: OpSpec, env: dict) -> dict:
    a = float(spec.attrs.get("alpha", 1.0))
    b = float(spec.attrs.get("beta", 1.0))
    return {spec.outs[0]: a * env[spec.ins[0]] + b * env[spec.ins[1]]}


@register_op("affine")
def _affine(spec: OpSpec, env: dict) -> dict:
    """``a*x + b`` — the scalar-operand form of add/sub.  With ``a`` in
    {1, -1} the result is bit-exact with the ``x + b`` / ``b - x`` it
    stands in for."""
    a = float(spec.attrs.get("a", 1.0))
    b = float(spec.attrs.get("b", 0.0))
    x = env[spec.ins[0]]
    return {spec.outs[0]: (x if a == 1.0 else (-x if a == -1.0 else a * x)) + b}


@register_op("divc")
def _divc(spec: OpSpec, env: dict) -> dict:
    """``x / c`` — true division, not scale-by-reciprocal, so traced and
    eager results agree to the last ulp.  The divisor is a 0-d tensor on
    ``x``'s device: PyTorch's CUDA division by a host scalar multiplies by
    the reciprocal instead."""
    import torch
    x = env[spec.ins[0]]
    c = torch.full((), float(spec.attrs["c"]), dtype=x.dtype, device=x.device)
    return {spec.outs[0]: x / c}


@register_op("rdivc")
def _rdivc(spec: OpSpec, env: dict) -> dict:
    """``c / x`` as true division: the constant is a 0-d tensor, since
    PyTorch's ``c / x`` for a Python ``c`` multiplies ``x``'s reciprocal
    by ``c``."""
    import torch
    x = env[spec.ins[0]]
    c = torch.full((), float(spec.attrs["c"]), dtype=x.dtype, device=x.device)
    return {spec.outs[0]: c / x}


@register_op("div")
def _div(spec: OpSpec, env: dict) -> dict:
    return {spec.outs[0]: env[spec.ins[0]] / env[spec.ins[1]]}


@register_op("mul")
def _mul(spec: OpSpec, env: dict) -> dict:
    return {spec.outs[0]: env[spec.ins[0]] * env[spec.ins[1]]}


# (dtype, value, device) -> the constant's tensor, made once: a host copy
# on every call would be a pageable copy inside a captured CUDA graph.
_CONSTS: dict = {}


@register_op("const")
def _const(spec: OpSpec, env: dict) -> dict:
    """A compile-time constant array (an array-left operand lifted into a
    trace), its value plain data in ``attrs``.  The tensor is made on its
    device once per value and shared by every call (no body writes in
    place)."""
    import numpy as np
    import torch
    dtype = spec.attrs.get("dtype", "float32")
    device = _env_device(env)
    key = (dtype, spec.attrs["value"], str(device))
    out = _CONSTS.get(key)
    if out is None:
        value = np.array(spec.attrs["value"], dtype=np.dtype(dtype))
        out = _CONSTS[key] = torch.as_tensor(value, device=device)
    return {spec.outs[0]: out}


@register_op("mv")
def _mv(spec: OpSpec, env: dict) -> dict:
    A = env[spec.ins[0]]
    if spec.attrs.get("trans", False):
        A = A.T
    return {spec.outs[0]: A @ env[spec.ins[1]]}


@register_op("maxpool2d")
def _maxpool2d(spec: OpSpec, env: dict) -> dict:
    """k × k windows at stride k, VALID (a ragged edge is dropped)."""
    import torch
    k = int(spec.attrs["k"])
    return {spec.outs[0]: torch.nn.functional.max_pool2d(env[spec.ins[0]],
                                                         k, k)}


@register_op("mean")
def _mean(spec: OpSpec, env: dict) -> dict:
    axes = tuple(int(a) for a in spec.attrs["axes"])
    return {spec.outs[0]: env[spec.ins[0]].mean(dim=axes)}


@register_op("reshape")
def _reshape(spec: OpSpec, env: dict) -> dict:
    shape = tuple(int(s) for s in spec.attrs["shape"])
    return {spec.outs[0]: env[spec.ins[0]].reshape(shape)}


@register_op("concat")
def _concat(spec: OpSpec, env: dict) -> dict:
    import torch
    axis = int(spec.attrs.get("axis", 0))
    return {spec.outs[0]: torch.cat([env[b] for b in spec.ins], dim=axis)}


@register_op("split")
def _split(spec: OpSpec, env: dict) -> dict:
    """Multi-output inverse of concat: ``sizes`` partitions ``axis``; the
    pieces are views."""
    axis = int(spec.attrs.get("axis", 0))
    x = env[spec.ins[0]]
    out, off = {}, 0
    for o, s in zip(spec.outs, spec.attrs["sizes"]):
        out[o] = x.narrow(axis, off, int(s))
        off += int(s)
    return out


@register_op("slice")
def _slice(spec: OpSpec, env: dict) -> dict:
    """Static rectangular window: ``starts``/``sizes`` per dimension (a
    view)."""
    x = env[spec.ins[0]]
    ix = tuple(slice(int(st), int(st) + int(sz))
               for st, sz in zip(spec.attrs["starts"], spec.attrs["sizes"]))
    return {spec.outs[0]: x[ix]}


def _rglru_reference(a, b):
    """RG-LRU recurrence h_t = a_t * h_{t-1} + b_t over axis 1 of (B, S, D)
    operands, h_{-1} = 0, in a's type: a loop over time in the reference's
    step order.  No closed form (a cumulative product divided out would
    underflow over long sequences)."""
    import torch
    h = torch.zeros_like(a[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _ssd_reference(states, decay):
    """SSD inter-chunk recurrence over (nc, BH, P, N) end states and
    (nc, BH, 1, 1) decays: the state carried *into* each chunk, h_0 = 0,
    in the states' type — each chunk's h emitted before chunk c folds in."""
    import torch
    h = torch.zeros_like(states[0])
    prevs = []
    for c in range(states.shape[0]):
        prevs.append(h)
        h = h * decay[c] + states[c]
    return torch.stack(prevs, dim=0)


@register_op("rglru_scan")
def _rglru_scan(spec: OpSpec, env: dict) -> dict:
    """RG-LRU linear recurrence over axis 1 of (B, S, D) operands.  The
    generic sequential definition; the routed ``rglru.scan`` kernel
    replaces it with the CUDA scan."""
    return {spec.outs[0]: _rglru_reference(env[spec.ins[0]],
                                           env[spec.ins[1]])}


@register_op("ssd_scan")
def _ssd_scan(spec: OpSpec, env: dict) -> dict:
    """Mamba-2 SSD inter-chunk state recurrence: the state carried into
    each chunk.  The generic sequential definition; the routed ``ssd.scan``
    kernel replaces it with the CUDA scan."""
    return {spec.outs[0]: _ssd_reference(env[spec.ins[0]], env[spec.ins[1]])}


# --------------------------------------------------------------------------
# Gradient and optimizer kinds: the vocabulary the autodiff pass
# (core/autodiff.py) emits backward and AdamW-update graphs in.
# --------------------------------------------------------------------------


@register_op("mean_all")
def _mean_all(spec: OpSpec, env: dict) -> dict:
    """Full reduction to a (1, 1) scalar carrier — the loss head."""
    return {spec.outs[0]: env[spec.ins[0]].mean().reshape(1, 1)}


@register_op("bcast")
def _bcast(spec: OpSpec, env: dict) -> dict:
    """Broadcast to ``attrs['shape']`` (scalar carriers flatten first).
    Returns an ``expand`` view — zero strides, no copy."""
    shape = tuple(int(s) for s in spec.attrs["shape"])
    x = env[spec.ins[0]]
    if x.numel() == 1:
        x = x.reshape(())
    return {spec.outs[0]: x.expand(shape)}


@register_op("relu_grad")
def _relu_grad(spec: OpSpec, env: dict) -> dict:
    g, x = env[spec.ins[0]], env[spec.ins[1]]
    return {spec.outs[0]: g * (x > 0).to(g.dtype)}


_GELU_C = 0.7978845608028654    # sqrt(2 / pi), the tanh gelu's constant


@register_op("gelu_grad")
def _gelu_grad(spec: OpSpec, env: dict) -> dict:
    """VJP of the tanh gelu (:func:`_gelu`), in closed form:
    ``g · (0.5(1+t) + 0.5·x·(1−t²)·√(2/π)·(1+3·0.044715·x²))`` with
    ``t = tanh(√(2/π)(x + 0.044715·x³))``."""
    import torch
    g, x = env[spec.ins[0]], env[spec.ins[1]]
    t = torch.tanh(_GELU_C * (x + 0.044715 * (x * x * x)))
    d = 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * _GELU_C * (
        1.0 + 3.0 * 0.044715 * (x * x))
    return {spec.outs[0]: g * d}


@register_op("softmax_grad")
def _softmax_grad(spec: OpSpec, env: dict) -> dict:
    """``y * (g - sum(g*y, axis))`` with ``y`` the forward softmax output."""
    axis = int(spec.attrs.get("axis", -1))
    g, y = env[spec.ins[0]], env[spec.ins[1]]
    return {spec.outs[0]: y * (g - (g * y).sum(dim=axis, keepdim=True))}


@register_op("outer")
def _outer(spec: OpSpec, env: dict) -> dict:
    """Rank-1 outer product ``a ⊗ b`` — the matrix grad of ``mv``."""
    a, b = env[spec.ins[0]], env[spec.ins[1]]
    return {spec.outs[0]: a[:, None] * b[None, :]}


@register_op("conv2d_input_grad")
def _conv2d_input_grad(spec: OpSpec, env: dict) -> dict:
    """Cotangent of a VALID conv's input, in full float32.  ``x_shape``
    fixes the size: at stride 2 a conv may leave the input's last row or
    column unread (ResNet-18 pads 56 → 58 and reads 57), and that edge's
    cotangent is zero."""
    import torch
    s = int(spec.attrs.get("stride", 1))
    groups = int(spec.attrs.get("groups", 1))
    x_shape = tuple(int(v) for v in spec.attrs["x_shape"])
    g, w = env[spec.ins[0]], env[spec.ins[1]]
    with full_f32_convolutions():
        dx = torch.nn.grad.conv2d_input(x_shape, w, g, stride=s,
                                        groups=groups)
    return {spec.outs[0]: dx}


@register_op("conv2d_weight_grad")
def _conv2d_weight_grad(spec: OpSpec, env: dict) -> dict:
    """Cotangent of a VALID conv's weight, in full float32 (the unread
    edge of a ragged stride contributes nothing)."""
    import torch
    s = int(spec.attrs.get("stride", 1))
    groups = int(spec.attrs.get("groups", 1))
    w_shape = tuple(int(v) for v in spec.attrs["w_shape"])
    g, x = env[spec.ins[0]], env[spec.ins[1]]
    with full_f32_convolutions():
        dw = torch.nn.grad.conv2d_weight(x, w_shape, g, stride=s,
                                         groups=groups)
    return {spec.outs[0]: dw}


@register_op("maxpool2d_grad")
def _maxpool2d_grad(spec: OpSpec, env: dict) -> dict:
    """Each k × k window's cotangent to its first maximum in row-major
    order (a tied window, all zeros after a relu, gives it to its first
    element, as the reference's ``select_and_scatter`` does); the edge a
    floor drops gets zero."""
    import torch.nn.functional as fn
    k = int(spec.attrs["k"])
    g, x = env[spec.ins[0]], env[spec.ins[1]]
    _, where = fn.max_pool2d(x, k, k, return_indices=True)
    dx = fn.max_unpool2d(g, where, k, k, output_size=tuple(x.shape[-2:]))
    return {spec.outs[0]: dx}


@register_op("slice_grad")
def _slice_grad(spec: OpSpec, env: dict) -> dict:
    """Zero-embed the window cotangent back into the source shape (a fresh
    tensor; the operand is not written)."""
    import torch
    g = env[spec.ins[0]]
    x_shape = tuple(int(v) for v in spec.attrs["x_shape"])
    ix = tuple(slice(int(st), int(st) + int(sz))
               for st, sz in zip(spec.attrs["starts"], spec.attrs["sizes"]))
    out = torch.zeros(x_shape, dtype=g.dtype, device=g.device)
    out[ix] = g
    return {spec.outs[0]: out}


@register_op("mean_grad")
def _mean_grad(spec: OpSpec, env: dict) -> dict:
    """``g / count`` (true division by a 0-d tensor, as ``divc``) spread
    over the reduced axes: an ``expand`` view, like ``bcast``."""
    import torch
    g = env[spec.ins[0]]
    x_shape = tuple(int(v) for v in spec.attrs["x_shape"])
    axes = sorted(int(a) % len(x_shape) for a in spec.attrs["axes"])
    count = 1
    for a in axes:
        count *= x_shape[a]
    q = g / torch.full((), float(count), dtype=g.dtype, device=g.device)
    for a in axes:
        q = q.unsqueeze(a)
    return {spec.outs[0]: q.expand(x_shape)}


@register_op("rglru_scan_grad")
def _rglru_scan_grad(spec: OpSpec, env: dict) -> dict:
    """``(da, db)`` of ``h_t = a_t·h_{t−1} + b_t``: ``h`` from one
    ``rglru_scan`` (the kernel on the card, its plain version on the CPU,
    at the route's chunk), then the reverse recurrence ``λ_t = g_t +
    a_{t+1}·λ_{t+1}`` from one more scan of the reversed operands
    (:func:`~repro_torch.kernels.rglru.rglru.rglru_scan_backward`); ``db =
    λ``, ``da_t = λ_t·h_{t−1}`` with ``h_{−1} = 0``, in ``a``'s type."""
    from ..kernels.rglru.rglru import (chunk_length, rglru_scan,
                                       rglru_scan_backward)
    g, a, b = (env[n] for n in spec.ins)
    a, b = a.contiguous(), b.contiguous()
    chunk = chunk_length(*a.shape)
    h = rglru_scan(a, b, chunk=chunk)
    da, db = rglru_scan_backward(g.contiguous(), a, h, chunk=chunk)
    return {spec.outs[0]: da, spec.outs[1]: db}


@register_op("ssd_scan_grad")
def _ssd_scan_grad(spec: OpSpec, env: dict) -> dict:
    """``(dstates, ddecay)`` of the carried-in recurrence ``h_{c+1} =
    h_c·dec_c + st_c`` (outputs ``h_c``): ``h`` from one ``ssd_chunk_scan``
    (the kernel on the card, its plain version on the CPU), then ``μ_c =
    g_c + dec_c·μ_{c+1}`` from ``μ_nc = 0`` by one launch of the reverse
    kernel (:func:`~repro_torch.kernels.ssd.ssd.ssd_chunk_scan_backward`);
    ``dst_c = μ_{c+1}``, ``ddec_c = Σ_{P,N} μ_{c+1}·h_c`` (kept at (BH, 1,
    1))."""
    from ..kernels.ssd.ssd import ssd_chunk_scan, ssd_chunk_scan_backward
    g, states, decay = (env[n] for n in spec.ins)
    states, decay = states.contiguous(), decay.contiguous()
    h = ssd_chunk_scan(states, decay)
    ds, dd = ssd_chunk_scan_backward(g.contiguous(), decay, h)
    return {spec.outs[0]: ds, spec.outs[1]: dd}


@register_op("sumsq")
def _sumsq(spec: OpSpec, env: dict) -> dict:
    """float32 sum of squares to a (1, 1) carrier (one parameter's term of
    the global gradient norm)."""
    x = env[spec.ins[0]].float()
    return {spec.outs[0]: (x * x).sum().reshape(1, 1)}


@register_op("clip_scale")
def _clip_scale(spec: OpSpec, env: dict) -> dict:
    """Global-norm clip factor from the summed squares: outs are
    ``(scale, norm)``, both (1, 1) carriers."""
    import torch
    max_norm = float(spec.attrs["max_norm"])
    norm = torch.sqrt(env[spec.ins[0]])
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {spec.outs[0]: scale, spec.outs[1]: norm}


@register_op("lr_sched")
def _lr_sched(spec: OpSpec, env: dict) -> dict:
    """Warmup + cosine decay in float32, the reference's arithmetic op for
    op.  The input is the *already incremented* step (a (1, 1) float32
    carrier)."""
    import math

    import torch
    a = spec.attrs
    lr0 = float(a["lr"])
    warm_n = float(a["warmup_steps"])
    total = float(a["total_steps"])
    frac = float(a["min_lr_frac"])
    step = env[spec.ins[0]].reshape(()).float()
    warm = lr0 * (step + 1.0) / max(warm_n, 1.0)
    prog = torch.clamp((step - warm_n) / max(total - warm_n, 1.0), 0.0, 1.0)
    cos = lr0 * (frac + (1.0 - frac) * 0.5 * (1.0 + torch.cos(math.pi * prog)))
    return {spec.outs[0]: torch.where(step < warm_n, warm, cos).reshape(1, 1)}


@register_op("adamw_step")
def _adamw_step(spec: OpSpec, env: dict) -> dict:
    """One decoupled-weight-decay Adam update of one parameter, with the
    global clip ``scale`` and scheduled ``lr`` as (1, 1) operands; float32
    moments, the parameter back in its own dtype.
    ins: (p, g, m, v, scale, lr, step2); outs: (p2, m2, v2)."""
    import torch
    a = spec.attrs
    b1, b2 = float(a["b1"]), float(a["b2"])
    eps, wd = float(a["eps"]), float(a["wd"])
    p, g, m, v, scale, lr, step2 = (env[n] for n in spec.ins)
    g32 = g.float() * scale.reshape(())
    step_f = step2.reshape(()).float()
    p32 = p.float()
    m2 = b1 * m.float() + (1.0 - b1) * g32
    v2 = b2 * v.float() + (1.0 - b2) * g32 * g32
    mh = m2 / (1.0 - torch.pow(b1, step_f))
    vh = v2 / (1.0 - torch.pow(b2, step_f))
    delta = mh / (torch.sqrt(vh) + eps) + wd * p32
    p2 = p32 - lr.reshape(()) * delta
    return {spec.outs[0]: p2.to(p.dtype), spec.outs[1]: m2, spec.outs[2]: v2}


# --------------------------------------------------------------------------
# VJP rules (ISSUE 10): kind -> rule, the same registry discipline as the
# implementations — rules live in *code* keyed by kind, while everything
# they emit is plain OpSpec *data* in a second DataflowGraph, so the
# backward pickles/caches/reloads like any forward graph and the whole
# pass pipeline (fusion, routing, caching) applies to it unchanged.
#
# A rule takes ``(spec, g, b)``:
#
# ``spec``
#     the forward task's OpSpec;
# ``g``
#     {out buffer -> cotangent buffer name} for the *live* outputs only
#     (outputs on a path to the loss; at least one, or the task is
#     skipped entirely);
# ``b``
#     the backward-graph builder (``core.autodiff`` passes its
#     ``_BwdBuilder``): ``b.shape(name)`` reports a buffer's shape,
#     ``b.res(name)`` imports a forward buffer as a shared residual, the
#     op helpers (``b.add/mul/scale/matmul/...``) emit spec'd tasks and
#     return the produced buffer name.
#
# Rules return the input cotangents either as ``{in buffer: cot buffer}``
# or as a ``[(in buffer, cot buffer)]`` pair list.  The pair list is
# *required* whenever one buffer can appear in several operand slots
# (``mul(x, x)``, ``matmul(x, x)``, ...): each pair accumulates
# separately, a dict would silently drop one term.
# --------------------------------------------------------------------------

# kind -> rule(spec, g, b) -> {in: cot} | [(in, cot)]
_VJP_REGISTRY: dict[str, Callable] = {}


def register_vjp(kind: str):
    """Decorator registering a VJP rule for ``kind`` (replace-on-repeat,
    like :func:`register_op`; does *not* bump the registry epoch — rules
    never change already-materialized forward numerics)."""

    def deco(fn: Callable):
        _VJP_REGISTRY[kind] = fn
        return fn

    return deco


def has_vjp(kind: str) -> bool:
    return kind in _VJP_REGISTRY


def differentiable_ops() -> list[str]:
    return sorted(_VJP_REGISTRY)


def vjp_rule(kind: str) -> Callable:
    try:
        return _VJP_REGISTRY[kind]
    except KeyError:
        raise UnknownOpError(
            f"no VJP rule registered for op kind {kind!r}; differentiable "
            f"kinds: {differentiable_ops()}") from None


@register_vjp("identity")
def _identity_vjp(spec, g, b):
    return {spec.ins[0]: g[spec.outs[0]]}


@register_vjp("dup")
def _dup_vjp(spec, g, b):
    return {spec.ins[0]: b.add_n([g[o] for o in spec.outs if o in g])}


@register_vjp("zeros")
def _zeros_vjp(spec, g, b):
    return {}


@register_vjp("const")
def _const_vjp(spec, g, b):
    return {}


def _pad_window_vjp(spec, g, b):
    p = int(spec.attrs["pad"])
    x_shape = b.shape(spec.ins[0])
    starts = (0, 0) + (p,) * (len(x_shape) - 2)
    return {spec.ins[0]: b.slice(g[spec.outs[0]], starts, x_shape)}


register_vjp("pad2d")(_pad_window_vjp)
register_vjp("fill_interior")(_pad_window_vjp)


@register_vjp("conv2d")
def _conv2d_vjp(spec, g, b):
    go = g[spec.outs[0]]
    x, w = spec.ins
    base = {"stride": int(spec.attrs.get("stride", 1)),
            "groups": int(spec.attrs.get("groups", 1))}
    dx = b.emit("conv2d_input_grad", (go, b.res(w)), (b.shape(x),),
                dict(base, x_shape=b.shape(x)), op="conv",
                flops=2.0)[0]
    dw = b.emit("conv2d_weight_grad", (go, b.res(x)), (b.shape(w),),
                dict(base, w_shape=b.shape(w)), op="conv",
                flops=2.0)[0]
    return {x: dx, w: dw}


@register_vjp("relu")
def _relu_vjp(spec, g, b):
    return {spec.ins[0]: b.ewise(
        "relu_grad", (g[spec.outs[0]], b.res(spec.ins[0])))}


@register_vjp("gelu")
def _gelu_vjp(spec, g, b):
    return {spec.ins[0]: b.ewise(
        "gelu_grad", (g[spec.outs[0]], b.res(spec.ins[0])), flops=12.0)}


@register_vjp("add")
def _add_vjp(spec, g, b):
    go = g[spec.outs[0]]
    return [(spec.ins[0], go), (spec.ins[1], go)]


@register_vjp("vadd")
def _vadd_vjp(spec, g, b):
    go = g[spec.outs[0]]
    al = float(spec.attrs.get("alpha", 1.0))
    be = float(spec.attrs.get("beta", 1.0))
    return [(spec.ins[0], go if al == 1.0 else b.scale(go, al)),
            (spec.ins[1], go if be == 1.0 else b.scale(go, be))]


@register_vjp("scale")
def _scale_vjp(spec, g, b):
    return {spec.ins[0]: b.scale(g[spec.outs[0]], float(spec.attrs["s"]))}


@register_vjp("affine")
def _affine_vjp(spec, g, b):
    a = float(spec.attrs.get("a", 1.0))
    go = g[spec.outs[0]]
    return {spec.ins[0]: go if a == 1.0 else b.scale(go, a)}


@register_vjp("divc")
def _divc_vjp(spec, g, b):
    return {spec.ins[0]: b.divc(g[spec.outs[0]], float(spec.attrs["c"]))}


@register_vjp("rdivc")
def _rdivc_vjp(spec, g, b):
    # d(c/x)/dx = -c/x^2 = -y^2/c with y the forward output residual.
    go = g[spec.outs[0]]
    c = float(spec.attrs["c"])
    y = b.res(spec.outs[0])
    return {spec.ins[0]: b.scale(b.mul(go, b.mul(y, y)), -1.0 / c)}


@register_vjp("div")
def _div_vjp(spec, g, b):
    go = g[spec.outs[0]]
    y = b.res(spec.outs[0])
    den = b.res(spec.ins[1])
    da = b.div(go, den)
    db = b.scale(b.div(b.mul(go, y), den), -1.0)
    return [(spec.ins[0], da), (spec.ins[1], db)]


@register_vjp("mul")
def _mul_vjp(spec, g, b):
    go = g[spec.outs[0]]
    xa, xb = spec.ins
    if xa == xb:
        return [(xa, b.scale(b.mul(go, b.res(xa)), 2.0))]
    return [(xa, b.mul(go, b.res(xb))), (xb, b.mul(go, b.res(xa)))]


@register_vjp("matmul")
def _matmul_vjp(spec, g, b):
    go = g[spec.outs[0]]
    A, B = spec.ins
    dA = b.matmul(go, b.transpose(b.res(B)))
    dB = b.matmul(b.transpose(b.res(A)), go)
    return [(A, dA), (B, dB)]


@register_vjp("mv")
def _mv_vjp(spec, g, b):
    go = g[spec.outs[0]]
    A, x = spec.ins
    trans = bool(spec.attrs.get("trans", False))
    if trans:                       # y = A.T @ x
        dA = b.outer(b.res(x), go)
        dx = b.mv(b.res(A), go, trans=False)
    else:                           # y = A @ x
        dA = b.outer(go, b.res(x))
        dx = b.mv(b.res(A), go, trans=True)
    return [(A, dA), (x, dx)]


@register_vjp("transpose")
def _transpose_vjp(spec, g, b):
    # Both emitted perms (2-D T, batched (0, 2, 1)) are self-inverse.
    return {spec.ins[0]: b.transpose(g[spec.outs[0]])}


@register_vjp("reshape")
def _reshape_vjp(spec, g, b):
    x_shape = b.shape(spec.ins[0])
    return {spec.ins[0]: b.emit("reshape", (g[spec.outs[0]],), (x_shape,),
                                {"shape": x_shape}, op="copy", flops=0.0)[0]}


@register_vjp("concat")
def _concat_vjp(spec, g, b):
    go = g[spec.outs[0]]
    if len(spec.ins) == 1:
        return [(spec.ins[0], go)]
    axis = int(spec.attrs.get("axis", 0))
    sizes = tuple(b.shape(i)[axis] for i in spec.ins)
    return list(zip(spec.ins, b.split(go, sizes, axis)))


@register_vjp("split")
def _split_vjp(spec, g, b):
    axis = int(spec.attrs.get("axis", 0))
    pieces = [g[o] if o in g else b.zeros(b.shape(o)) for o in spec.outs]
    return {spec.ins[0]: b.concat(pieces, axis)}


@register_vjp("slice")
def _slice_vjp(spec, g, b):
    x_shape = b.shape(spec.ins[0])
    attrs = {"starts": tuple(int(s) for s in spec.attrs["starts"]),
             "sizes": tuple(int(s) for s in spec.attrs["sizes"]),
             "x_shape": x_shape}
    return {spec.ins[0]: b.emit("slice_grad", (g[spec.outs[0]],),
                                (x_shape,), attrs, op="copy", flops=0.0)[0]}


@register_vjp("softmax")
def _softmax_vjp(spec, g, b):
    axis = int(spec.attrs.get("axis", -1))
    return {spec.ins[0]: b.ewise(
        "softmax_grad", (g[spec.outs[0]], b.res(spec.outs[0])),
        {"axis": axis}, flops=4.0)}


@register_vjp("maxpool2d")
def _maxpool2d_vjp(spec, g, b):
    x = spec.ins[0]
    x_shape = b.shape(x)
    return {x: b.emit("maxpool2d_grad", (g[spec.outs[0]], b.res(x)),
                      (x_shape,), {"k": int(spec.attrs["k"])},
                      op="pool")[0]}


@register_vjp("mean")
def _mean_vjp(spec, g, b):
    x_shape = b.shape(spec.ins[0])
    axes = tuple(int(a) for a in spec.attrs["axes"])
    return {spec.ins[0]: b.emit("mean_grad", (g[spec.outs[0]],), (x_shape,),
                                {"axes": axes, "x_shape": x_shape})[0]}


@register_vjp("mean_all")
def _mean_all_vjp(spec, g, b):
    x_shape = b.shape(spec.ins[0])
    count = 1
    for s in x_shape:
        count *= int(s)
    scaled = b.divc(g[spec.outs[0]], float(count))
    return {spec.ins[0]: b.emit("bcast", (scaled,), (x_shape,),
                                {"shape": x_shape}, op="copy", flops=0.0)[0]}


@register_vjp("rglru_scan")
def _rglru_scan_vjp(spec, g, b):
    a, bb = spec.ins
    da, db = b.emit("rglru_scan_grad",
                    (g[spec.outs[0]], b.res(a), b.res(bb)),
                    (b.shape(a), b.shape(bb)), op="scan", flops=4.0)
    return [(a, da), (bb, db)]


@register_vjp("ssd_scan")
def _ssd_scan_vjp(spec, g, b):
    st, dec = spec.ins
    ds, dd = b.emit("ssd_scan_grad",
                    (g[spec.outs[0]], b.res(st), b.res(dec)),
                    (b.shape(st), b.shape(dec)), op="scan", flops=4.0)
    return [(st, ds), (dec, dd)]


__all__ = ["OpSpec", "UnknownOpError", "differentiable_ops", "has_vjp",
           "materialize", "op_impl", "register_op", "register_vjp",
           "registered_ops", "vjp_rule"]
