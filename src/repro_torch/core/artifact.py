"""Portable compiled-design artifacts: versioned JSON export/import.

The PyTorch port's copy of ``repro/core/artifact.py`` over the port's own
``core`` modules: the same schema (1.5), compatibility policy and
documents, so an artifact exported by either package imports and runs in
the other.  Differences from the reference, each kept small:

* ``generator`` names this package (``codo-repro-torch``); it is cosmetic
  and ``diff_artifacts`` ignores it.
* Routed groups are recorded as ``pallas:<pattern>``, the reference's
  spelling, so both packages read each other's routing tables; the kernel
  behind a pattern here is the Hopper one.
* A v1.4 ``sharding`` section is written and read as the reference does:
  the plan is pure data (:mod:`repro_torch.distributed.plan`), with the
  same digest in both packages.
* Weight payloads may be given as tensors (on any device); they are
  written from their host copy.

The paper's flow ends in a *product*: a violation-free graph plus a
schedule and data-movement plan handed to downstream tooling.  This module
makes that product a language-neutral, versioned JSON document —
:func:`export_artifact` serializes a :class:`~repro_torch.core.compiler.
CompiledDataflow` and :func:`import_artifact` reconstructs a fully
*executable* one (it lowers, executes, and passes ``verify_lowering``) in
any process, including non-Python consumers reading the JSON directly.

The field-by-field format contract lives in ``docs/artifact_format.md``
(every example block there is executed by ``tools/check_docs.py`` in CI,
so the spec cannot drift from this implementation).  In short, a document
contains:

``schema_version``     format version, ``"<major>.<minor>"``
``graph``              topology: buffers (shape/dtype/kind/impl) + tasks
                       (loop nests, accesses, declarative ``OpSpec``s)
``options``            the :class:`CodoOptions` the design was compiled under
``buffer_plan``        FIFO/ping-pong decision per internal edge
``transfer_plan``      HBM channel + burst assignment
``schedule``           parallel degrees + stage latencies (§VI report)
``fusion``             FIFO-connected fusion groups (derived, cross-checked)
``cost``               baseline/final cost-model summary
``diagnostics``        per-pass timing + violation census
``integrity``          the graph's ``structural_hash`` at export time

Compatibility policy
--------------------

* **Unknown fields warn** (forward compatible): a newer writer may add
  fields; readers ignore them with a :class:`ArtifactWarning`.
* **Version mismatch fails**: a different *major* version raises
  :class:`ArtifactError`; a newer *minor* version warns and proceeds.
* **Corruption fails loudly**: validation reports every problem with its
  JSON path, and the reconstructed graph must hash to the recorded
  ``integrity.structural_hash`` (disable with ``check_integrity=False``
  for deliberately hand-edited artifacts).

Everything here is importable without torch — export/import are pure
data transforms; only lowering/executing the imported design needs torch.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import sys
import warnings
from pathlib import Path
from typing import Any

import numpy as np

from .buffers import BufferPlan
from .compiler import CodoOptions, CompiledDataflow
from .costmodel import (GraphCost, HwParams, graph_latency, routing_params,
                        sequential_latency)
from .graph import FIFO, PINGPONG, UNDECIDED, DataflowGraph, GraphError
from .offchip import TransferPlan
from .ops import OpSpec, op_impl, registered_ops
from .passes import CompileDiagnostics
from .patterns import coarse_violations
from .routing import (XLA_FUSED, decide_route, ensure_kernel_patterns,
                      match_group, pallas_disabled)
from .schedule import ScheduleReport

SCHEMA_VERSION = "1.5"

# Schema changelog
# ----------------
# 1.5  `provenance`: source-graph provenance — the *pre-pass* source
#      graph's structural hash plus the trace origin (the traced
#      function's module-qualified name, or ``graph:<name>`` for
#      hand-built graphs).  The integrity hash covers the *optimized*
#      graph, so two artifacts compiled from the same source under
#      different pipelines used to be indistinguishable from two
#      different models; ``artifact diff`` now tells "same source,
#      different pipeline" from "different source".  Also introduces the
#      *train-step* document (``kind: "train_step"``): three linked
#      per-phase artifacts (`phases.forward/backward/update` — the
#      graph-level autodiff forward, cotangent, and AdamW-update designs)
#      plus a `train` section naming the loss buffer, seed cotangents,
#      shared residual buffers, per-parameter gradient buffers, and the
#      optimizer attrs, so ``codo.load`` reconstructs an executable
#      CompiledTrainStep in a fresh interpreter.  Older readers ignore
#      the `provenance` section (unknown-field policy) and this reader
#      accepts v1.0–v1.4 documents without it.
# 1.4  `sharding`: the multi-device ShardingPlan — pure-data mesh axes,
#      per-buffer placements, and the typed collective schedule
#      (all_gather / reduce_scatter / psum / ppermute steps with their
#      FIFO-depth buffer sizing and decomposition choices), plus a
#      content digest that is re-checked on import.  ``codo.load``
#      restores the plan so a sharded design round-trips to the same
#      sharded execution; devices are only touched at run time.
#      Older readers ignore the section (unknown-field policy) and this
#      reader accepts v1.0–v1.3 documents without it.
# 1.3  `weights`: bound weight payloads — content-hashed arrays either
#      embedded (base64 of the raw little-endian bytes) or referenced from
#      an ``.npz`` sidecar next to the document, one entry per weight
#      buffer with its dtype/shape/sha256.  A weight-carrying artifact is
#      a *self-contained served model*: ``codo.load`` binds the arrays, so
#      execution never reaches ``weight_init``.  Older readers ignore the
#      section (unknown-field policy) and this reader accepts v1.0–v1.2
#      documents without it.
# 1.2  `tuning`: measured autotune results for the design's routed chains
#      — `{"entries": [TuningRecord dicts]}` keyed on chain structural
#      signature + backend + hw name (see repro_torch.core.tuning).  Importers
#      merge the entries into the process tuning database so measured
#      routing decisions travel with the artifact; older readers ignore
#      the section (unknown-field policy) and this reader accepts v1.0/
#      v1.1 documents without it.  `diagnostics.group_kernels` values
#      became per-group entry dicts (kernel + cost-gate decision +
#      predicted cycles); bare v1.1 strings are still read.
# 1.1  `fusion.kernels`: per-group kernel-routing decision ("xla-fused" or
#      "pallas:<pattern>[+...]"), aligned with `fusion.groups`; advisory —
#      readers re-derive routing against their own kernel registry and
#      warn (never fail) on drift.  v1.0 readers ignore it (unknown-field
#      policy); this reader accepts v1.0 documents without it.

# Tool identifier recorded in `generator`; consumers should key behaviour
# on `schema_version`, never on this string.
GENERATOR = "codo-repro-torch"

class ArtifactError(ValueError):
    """A document failed validation, version, or integrity checks.  The
    message lists every problem with its JSON path."""


class ArtifactWarning(UserWarning):
    """Forward-compat warnings: unknown fields, newer minor versions,
    cost-model drift."""


def _warn(msg: str) -> None:
    warnings.warn(msg, ArtifactWarning, stacklevel=3)


# --------------------------------------------------------------------------
# Export
# --------------------------------------------------------------------------


def _fifo_groups(graph: DataflowGraph, impl: dict[str, str]) -> list[list[str]]:
    """Maximal FIFO-connected task sets in topo order — the fusion decision
    the artifact records.  Mirrors ``lowering.fusion_groups`` but stays
    torch-free and does not mutate ``fused_group`` ids."""
    parent = {t.name: t.name for t in graph.tasks}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for p, buf, c in graph.internal_edges():
        if impl.get(buf) == FIFO:
            parent[find(p.name)] = find(c.name)

    order = [t.name for t in graph.toposort()]
    by_root: dict[str, list[str]] = {}
    for n in order:
        by_root.setdefault(find(n), []).append(n)
    pos = {n: i for i, n in enumerate(order)}
    return sorted(by_root.values(), key=lambda names: pos[names[0]])


def _group_kernels(graph: DataflowGraph, impl: dict[str, str],
                   groups: list[list[str]],
                   compiled: "CompiledDataflow | None" = None,
                   backend: str | None = None) -> list[str]:
    """Per-group kernel-routing decision, aligned with ``groups``.

    Prefers the decision the lowering recorded on the design's diagnostics
    (the kernels that actually ran); otherwise derives it structurally
    from this process's pattern registry, priced for ``backend`` (see
    :func:`~repro_torch.core.costmodel.routing_backend`) — torch-free
    either way.  The record is advisory: importers re-derive against their
    own registry.
    """
    recorded = (compiled.diagnostics.group_kernels
                if compiled is not None and compiled.diagnostics is not None
                else {})
    if recorded and set(recorded) == {str(i) for i in range(len(groups))}:
        return [recorded[str(i)].get("kernel", XLA_FUSED)
                if isinstance(recorded[str(i)], dict) else str(recorded[str(i)])
                for i in range(len(groups))]
    ensure_kernel_patterns()
    if pallas_disabled():
        return [XLA_FUSED] * len(groups)
    params = routing_params(backend)       # the gate's constants, as lowered
    out = []
    for names in groups:
        routed = []
        if len(names) > 1:
            for pat, tasks in match_group(graph, names, impl):
                if decide_route(graph, tasks, pat, params=params,
                                backend=backend).routed:     # cost gate
                    routed.append(pat.name)
        out.append("pallas:" + "+".join(routed) if routed else XLA_FUSED)
    return out


def _host_array(value) -> np.ndarray:
    """A weight payload as a host numpy array (tensors on any device are
    copied to the host)."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def _hash_array(arr: np.ndarray) -> str:
    """Content hash of a weight payload: sha256 over the raw (C-contiguous,
    native-endian) bytes."""
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def sidecar_path(path: str | Path) -> Path:
    """Where a sidecar-weights export puts its ``.npz`` — next to the JSON
    document, same stem."""
    return Path(path).with_suffix(".weights.npz")


def _weights_section(graph: DataflowGraph, weights: dict,
                     path: str | Path | None, sidecar: bool) -> dict:
    """Build (and, for sidecar format, write) the v1.3 ``weights`` payload.
    Every array is validated against the graph's weight-buffer table so a
    weight-carrying artifact can never ship values its design cannot bind.
    """
    by_name = {b.name: b for b in graph.weights()}
    unknown = sorted(set(weights) - set(by_name))
    if unknown:
        raise ArtifactError(
            f"cannot export weights {unknown}: not weight buffers of "
            f"{graph.name!r} (weights: {sorted(by_name)})")
    if sidecar and path is None:
        raise ArtifactError("sidecar weights need a document path — the "
                            ".npz lives next to the JSON (pass path=, or "
                            "use embedded weights for in-memory documents)")
    arrays: dict[str, dict] = {}
    payload: dict[str, np.ndarray] = {}
    for name in sorted(weights):
        buf = by_name[name]
        arr = _host_array(weights[name])
        if tuple(arr.shape) != tuple(buf.shape):
            raise ArtifactError(
                f"weight {name!r} has shape {tuple(arr.shape)}, buffer "
                f"expects {tuple(buf.shape)}")
        arr = arr.astype(np.dtype(buf.dtype), copy=False)
        entry = {"dtype": np.dtype(buf.dtype).name,
                 "shape": [int(s) for s in arr.shape],
                 "sha256": _hash_array(arr)}
        if not sidecar:
            entry["data"] = base64.b64encode(
                np.ascontiguousarray(arr).tobytes()).decode("ascii")
        arrays[name] = entry
        payload[name] = arr
    section: dict[str, Any] = {
        "format": "sidecar" if sidecar else "embedded",
        "arrays": arrays,
    }
    if sidecar:
        sc = sidecar_path(path)
        np.savez(sc, **payload)
        section["file"] = sc.name
    return section


def export_artifact(compiled: CompiledDataflow,
                    path: str | Path | None = None, *,
                    weights: dict | None = None,
                    weights_sidecar: bool = False,
                    sharding=None, provenance: dict | None = None,
                    backend: str | None = None) -> dict:
    """Serialize a compiled design to the versioned JSON artifact format.

    Returns the document as a dict; when ``path`` is given, also writes it
    as canonical JSON (sorted keys, 2-space indent).  Raises
    :class:`ArtifactError` for closure-built tasks — closures cannot
    serialize; build graphs with declarative ``OpSpec``s (``repro_torch.
    core.ops``) so the artifact stays executable after import.

    ``weights`` (v1.3) binds concrete arrays to the design's weight
    buffers: content-hashed payloads embedded in the document, or — with
    ``weights_sidecar`` — written to ``<path>.weights.npz`` next to it.
    ``codo.load`` binds them back, so a weight-carrying artifact serves
    with no model code and no initializer in reach.

    ``sharding`` (v1.4) records the design's
    :class:`~repro_torch.distributed.plan.ShardingPlan` — placements +
    collective schedule — so the importer reconstructs the same
    multi-device program without re-partitioning.

    ``provenance`` (v1.5) records where the design came from: the
    *pre-pass* source graph's structural hash and the trace origin.  The
    integrity hash covers the optimized graph only, so this section is
    what lets ``artifact diff`` separate "same source, different
    pipeline" from "different source".

    ``backend`` is the routing backend the ``fusion.kernels`` record is
    priced for when the design has not been lowered yet (a lowered design
    records the kernels that ran).
    """
    g = compiled.graph
    closures = [t.name for t in g.tasks if t.fn_is_closure]
    if closures:
        raise ArtifactError(
            f"cannot export {g.name!r}: tasks {closures[:3]} carry raw "
            "closure numerics, which do not serialize. Attach declarative "
            "OpSpecs (repro_torch.core.ops) instead — see "
            "docs/artifact_format.md.")
    missing = [t.name for t in g.tasks if t.spec is None]
    if missing:
        raise ArtifactError(
            f"cannot export {g.name!r}: tasks {missing[:3]} have no "
            "numeric semantics (no OpSpec); the imported design could "
            "never execute. Attach specs at graph construction.")

    impl = compiled.buffer_plan.impl if compiled.buffer_plan else {}
    groups = _fifo_groups(g, impl)
    tuning = _design_tuning(g, impl, groups)
    doc: dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "generator": GENERATOR,
        "graph": g.to_dict(),
        "options": compiled.options.to_dict(),
        "buffer_plan": (compiled.buffer_plan.to_dict()
                        if compiled.buffer_plan else None),
        "transfer_plan": (compiled.transfer_plan.to_dict()
                          if compiled.transfer_plan else None),
        "schedule": (compiled.schedule_report.to_dict()
                     if compiled.schedule_report else None),
        "fusion": {"groups": groups,
                   "kernels": _group_kernels(g, impl, groups, compiled,
                                             backend)},
        "cost": {
            "baseline_cycles": (compiled.baseline.total_cycles
                                if compiled.baseline else None),
            "final_cycles": (compiled.final.total_cycles
                             if compiled.final else None),
            "speedup": compiled.speedup,
            "fifo_fraction": compiled.fifo_fraction,
            "bottleneck": (compiled.final.bottleneck
                           if compiled.final else None),
            "units": compiled.final.units if compiled.final else None,
        },
        "diagnostics": (compiled.diagnostics.to_dict()
                        if compiled.diagnostics else None),
        "tuning": tuning,
        "integrity": {"structural_hash": g.structural_hash()},
    }
    if weights is not None:
        doc["weights"] = _weights_section(g, weights, path, weights_sidecar)
    if sharding is not None:
        doc["sharding"] = sharding.to_dict()
    if provenance is not None:
        doc["provenance"] = dict(provenance)
    if path is not None:
        Path(path).write_text(dumps(doc))
    return doc


def _design_tuning(graph: DataflowGraph, impl: dict[str, str],
                   groups: list[list[str]]) -> dict | None:
    """The v1.2 ``tuning`` payload: every process tuning-database entry
    whose chain signature occurs in this design (all backends/hardware —
    the importer's routing picks the entries for its own environment).
    ``None`` when no measured entries apply."""
    from .tuning import chain_signature, default_tuning_db
    ensure_kernel_patterns()
    sigs = set()
    for names in groups:
        if len(names) < 2:
            continue
        for _pat, tasks in match_group(graph, names, impl):
            sigs.add(chain_signature(graph, tasks))
    entries = [r.to_dict() for k, r in
               sorted(default_tuning_db().entries.items())
               if r.signature in sigs]
    return {"entries": entries} if entries else None


def dumps(doc: dict) -> str:
    """Canonical JSON text of an artifact document."""
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"


# --------------------------------------------------------------------------
# Validation
# --------------------------------------------------------------------------

_NUM = (int, float)
_OPT_STR = (str, type(None))

# Field tables: name -> (accepted types, required).  ``None`` types means
# any JSON value (checked by a dedicated validator instead).
_TOP_FIELDS = {
    "schema_version": ((str,), True),
    "generator": ((str,), False),
    "graph": ((dict,), True),
    "options": ((dict,), True),
    "buffer_plan": ((dict, type(None)), False),
    "transfer_plan": ((dict, type(None)), False),
    "schedule": ((dict, type(None)), False),
    "fusion": ((dict, type(None)), False),
    "cost": ((dict, type(None)), False),
    "diagnostics": ((dict, type(None)), False),
    # v1.2: measured autotune entries for the design's routed chains.
    "tuning": ((dict, type(None)), False),
    # v1.3: bound weight payloads (embedded base64 or .npz sidecar).
    "weights": ((dict, type(None)), False),
    # v1.4: the multi-device ShardingPlan (mesh + placements + collectives).
    "sharding": ((dict, type(None)), False),
    # v1.5: pre-pass source hash + trace origin.
    "provenance": ((dict, type(None)), False),
    "integrity": ((dict, type(None)), False),
}

_PROVENANCE_FIELDS = {
    "source_structural_hash": ((str,), True),
    "origin": ((str,), False),
}

# v1.5 train-step document (kind: "train_step"): three linked per-phase
# artifacts plus the autodiff linking section.
TRAIN_STEP_KIND = "train_step"

_TRAIN_TOP_FIELDS = {
    "schema_version": ((str,), True),
    "generator": ((str,), False),
    "kind": ((str,), True),
    "phases": ((dict,), True),
    "train": ((dict,), True),
    "provenance": ((dict, type(None)), False),
}

_TRAIN_FIELDS = {
    "loss": ((str,), True),
    "seeds": ((dict,), True),
    "residuals": ((list,), True),
    "grads": ((dict,), True),
    "params": ((list,), True),
    "opt": ((dict,), True),
}

_SHARDING_FIELDS = {
    "mesh": ((dict,), True),
    "strategy": ((str,), True),
    "specs": ((dict,), False),
    "steps": ((list,), False),
    "estimated_cycles": (_NUM, False),
    "digest": ((str,), False),
}

_SHARDING_STEP_FIELDS = {
    "kind": ((str,), True),
    "buffer": ((str,), True),
    "axis": ((str,), True),
    "task": ((str,), True),
    "where": ((str,), False),
    "dim": (_NUM, False),
    "bytes": (_NUM, False),
    "chunk_bytes": (_NUM, False),
    "depth": (_NUM, False),
    "channel": (_NUM, False),
    "via": ((str,), False),
}

_GRAPH_FIELDS = {
    "name": ((str,), True),
    "buffers": ((list,), True),
    "tasks": ((list,), True),
}

_BUFFER_FIELDS = {
    "name": ((str,), True),
    "shape": ((list,), True),
    "dtype": ((str,), True),
    "kind": ((str,), True),
    "impl": ((str,), False),
    "fifo_depth": (_NUM, False),
    "hbm_channel": (_NUM, False),
    "burst_len": (_NUM, False),
}

_TASK_FIELDS = {
    "name": ((str,), True),
    "loops": ((list,), True),
    "reads": ((list,), True),
    "writes": ((list,), True),
    "op": ((str,), False),
    "flops_per_iter": (_NUM, False),
    "bytes_per_iter": (_NUM, False),
    "fused_group": (_NUM, False),
    "stage": (_NUM, False),
    "reduction_rewritten": ((bool,), False),
    "reuse_buffers": ((dict,), False),
    "tags": ((list,), False),
    "spec": ((dict, type(None)), False),
}

_LOOP_FIELDS = {
    "var": ((str,), True),
    "trip": (_NUM, True),
    "parallel": (_NUM, False),
    "tile": (_NUM, False),
    "ring": ((str,), False),
}

_ACCESS_FIELDS = {
    "buffer": ((str,), True),
    "index": ((list,), True),
    "is_write": ((bool,), True),
    "enclosing": ((list, type(None)), False),
    "stream_shape": ((list, type(None)), False),
}

_SPEC_FIELDS = {
    "kind": ((str,), True),
    "ins": ((list,), False),
    "outs": ((list,), False),
    "attrs": ((dict,), False),
    "parts": ((list,), False),
}

_FUSION_FIELDS = {
    "groups": ((list,), True),
    # v1.1: advisory per-group routing decision, aligned with `groups`.
    "kernels": ((list,), False),
}

_COST_FIELDS = {
    "baseline_cycles": (_NUM + (type(None),), False),
    "final_cycles": (_NUM + (type(None),), False),
    "speedup": (_NUM, False),
    "fifo_fraction": (_NUM, False),
    "bottleneck": (_OPT_STR, False),
    "units": (_NUM + (type(None),), False),
}

_TUNING_FIELDS = {
    "entries": ((list,), True),
}

# Per-entry fields of the v1.2 `tuning.entries` records (TuningRecord).
_TUNING_ENTRY_FIELDS = {
    "signature": ((str,), True),
    "backend": ((str,), True),
    "hw": ((str,), True),
    "pattern": ((str,), False),
    "choice": ((str,), False),
    "tile": ((dict, type(None)), False),
    "routed_ms": (_NUM, False),
    "generic_ms": (_NUM, False),
    "workload": ((str,), False),
    "tasks": ((list,), False),
}

# v1.3 `weights` section and its per-array entries.
_WEIGHTS_FIELDS = {
    "format": ((str,), True),
    "file": ((str,), False),
    "arrays": ((dict,), True),
}

_WEIGHT_ENTRY_FIELDS = {
    "dtype": ((str,), True),
    "shape": ((list,), True),
    "sha256": ((str,), True),
    "data": ((str,), False),
}

_WEIGHT_FORMATS = ("embedded", "sidecar")

_INTEGRITY_FIELDS = {
    "structural_hash": ((str,), False),
}

# Known option/hw field names: unknown entries warn and are dropped on
# import (same forward-compat stance as everywhere else in the document —
# the cost cross-check flags any semantic consequence).
_OPTIONS_KNOWN = {f.name for f in dataclasses.fields(CodoOptions)}
_HW_KNOWN = {f.name for f in dataclasses.fields(HwParams)}

_BUFFER_KINDS = ("input", "weight", "intermediate", "output")
_IMPLS = (FIFO, PINGPONG, UNDECIDED)


def _check_fields(doc: dict, path: str, fields: dict,
                  errors: list[str], notes: list[str]) -> None:
    for name, (types, required) in fields.items():
        if name not in doc:
            if required:
                errors.append(f"{path}.{name}: missing required field")
            continue
        v = doc[name]
        if not isinstance(v, types):
            want = "|".join(t.__name__ for t in types)
            errors.append(f"{path}.{name}: expected {want}, "
                          f"got {type(v).__name__}")
    for k in doc:
        if k not in fields:
            notes.append(f"{path}.{k}: unknown field (ignored — written by a "
                         "newer schema minor version?)")


def _check_spec(doc: dict, path: str, errors: list[str],
                notes: list[str]) -> None:
    _check_fields(doc, path, _SPEC_FIELDS, errors, notes)
    for i, part in enumerate(doc.get("parts", ()) or ()):
        if isinstance(part, dict):
            _check_spec(part, f"{path}.parts[{i}]", errors, notes)
        else:
            errors.append(f"{path}.parts[{i}]: expected object, "
                          f"got {type(part).__name__}")


def _check_graph(doc: dict, errors: list[str], notes: list[str]) -> None:
    _check_fields(doc, "graph", _GRAPH_FIELDS, errors, notes)
    buf_names = set()
    for i, b in enumerate(doc.get("buffers") or ()):
        p = f"graph.buffers[{i}]"
        if not isinstance(b, dict):
            errors.append(f"{p}: expected object, got {type(b).__name__}")
            continue
        _check_fields(b, p, _BUFFER_FIELDS, errors, notes)
        name = b.get("name")
        if name in buf_names:
            errors.append(f"{p}.name: duplicate buffer {name!r}")
        buf_names.add(name)
        if b.get("kind") not in (None,) + _BUFFER_KINDS:
            errors.append(f"{p}.kind: {b['kind']!r} not one of {_BUFFER_KINDS}")
        if b.get("impl") not in (None,) + _IMPLS:
            errors.append(f"{p}.impl: {b['impl']!r} not one of {_IMPLS}")
    task_names = set()
    for i, t in enumerate(doc.get("tasks") or ()):
        p = f"graph.tasks[{i}]"
        if not isinstance(t, dict):
            errors.append(f"{p}: expected object, got {type(t).__name__}")
            continue
        _check_fields(t, p, _TASK_FIELDS, errors, notes)
        name = t.get("name")
        if name in task_names:
            errors.append(f"{p}.name: duplicate task {name!r}")
        task_names.add(name)
        for j, l in enumerate(t.get("loops") or ()):
            if isinstance(l, dict):
                _check_fields(l, f"{p}.loops[{j}]", _LOOP_FIELDS, errors, notes)
            else:
                errors.append(f"{p}.loops[{j}]: expected object, "
                              f"got {type(l).__name__}")
        for side in ("reads", "writes"):
            for j, a in enumerate(t.get(side) or ()):
                q = f"{p}.{side}[{j}]"
                if not isinstance(a, dict):
                    errors.append(f"{q}: expected object, "
                                  f"got {type(a).__name__}")
                    continue
                _check_fields(a, q, _ACCESS_FIELDS, errors, notes)
                if (isinstance(a.get("buffer"), str)
                        and a["buffer"] not in buf_names):
                    errors.append(f"{q}.buffer: {a['buffer']!r} is not a "
                                  "declared graph buffer")
        spec = t.get("spec")
        if isinstance(spec, dict):
            _check_spec(spec, f"{p}.spec", errors, notes)


def _parse_version(v: str) -> tuple[int, int]:
    try:
        major, minor = v.split(".")
        return int(major), int(minor)
    except Exception:
        raise ArtifactError(
            f"schema_version: {v!r} is not '<major>.<minor>'") from None


def validate_artifact(doc: Any) -> list[str]:
    """Strict structural validation of an artifact document.

    Returns the list of forward-compat notes (unknown fields — the caller
    decides whether to warn).  Raises :class:`ArtifactError` naming every
    hard problem with its JSON path: missing/ill-typed fields, duplicate
    names, dangling buffer references, bad enum values, or an incompatible
    ``schema_version`` major.
    """
    if not isinstance(doc, dict):
        raise ArtifactError(
            f"artifact root: expected a JSON object, got "
            f"{type(doc).__name__} — is this file an exported artifact?")
    errors: list[str] = []
    notes: list[str] = []
    _check_fields(doc, "artifact", _TOP_FIELDS, errors, notes)

    version = doc.get("schema_version")
    if isinstance(version, str):
        major, minor = _parse_version(version)
        ours = _parse_version(SCHEMA_VERSION)
        if major != ours[0]:
            errors.append(
                f"schema_version: artifact is v{version}, this reader "
                f"understands v{SCHEMA_VERSION} (same major only) — "
                "re-export with a matching codo version")
        elif (major, minor) > ours:
            notes.append(
                f"schema_version: artifact v{version} is newer than this "
                f"reader (v{SCHEMA_VERSION}); unknown fields are ignored")

    if isinstance(doc.get("graph"), dict):
        _check_graph(doc["graph"], errors, notes)
    fusion = doc.get("fusion")
    if isinstance(fusion, dict):
        _check_fields(fusion, "fusion", _FUSION_FIELDS, errors, notes)
        kernels = fusion.get("kernels")
        groups = fusion.get("groups")
        if (isinstance(kernels, list) and isinstance(groups, list)
                and len(kernels) != len(groups)):
            errors.append(f"fusion.kernels: {len(kernels)} entries for "
                          f"{len(groups)} groups (must align)")
    if isinstance(doc.get("cost"), dict):
        _check_fields(doc["cost"], "cost", _COST_FIELDS, errors, notes)
    tuning = doc.get("tuning")
    if isinstance(tuning, dict):
        _check_fields(tuning, "tuning", _TUNING_FIELDS, errors, notes)
        for i, entry in enumerate(tuning.get("entries") or ()):
            if not isinstance(entry, dict):
                errors.append(f"tuning.entries[{i}]: expected dict, got "
                              f"{type(entry).__name__}")
                continue
            _check_fields(entry, f"tuning.entries[{i}]",
                          _TUNING_ENTRY_FIELDS, errors, notes)
    wts = doc.get("weights")
    if isinstance(wts, dict):
        _check_fields(wts, "weights", _WEIGHTS_FIELDS, errors, notes)
        fmt = wts.get("format")
        if isinstance(fmt, str) and fmt not in _WEIGHT_FORMATS:
            errors.append(f"weights.format: {fmt!r} not one of "
                          f"{_WEIGHT_FORMATS}")
        if fmt == "sidecar" and not isinstance(wts.get("file"), str):
            errors.append("weights.file: required for sidecar format "
                          "(names the .npz next to the document)")
        weight_bufs = {b.get("name") for b in
                       (doc.get("graph") or {}).get("buffers") or ()
                       if isinstance(b, dict) and b.get("kind") == "weight"}
        for name, entry in (wts.get("arrays") or {}).items():
            p = f"weights.arrays.{name}"
            if not isinstance(entry, dict):
                errors.append(f"{p}: expected object, "
                              f"got {type(entry).__name__}")
                continue
            _check_fields(entry, p, _WEIGHT_ENTRY_FIELDS, errors, notes)
            if name not in weight_bufs:
                errors.append(f"{p}: {name!r} is not a weight buffer of "
                              "the graph")
            if fmt == "embedded" and not isinstance(entry.get("data"), str):
                errors.append(f"{p}.data: required for embedded format")
    shard = doc.get("sharding")
    if isinstance(shard, dict):
        from repro_torch.distributed.plan import COLLECTIVE_KINDS
        _check_fields(shard, "sharding", _SHARDING_FIELDS, errors, notes)
        mesh = shard.get("mesh")
        axes = mesh.get("axes") if isinstance(mesh, dict) else None
        axis_names = set()
        if isinstance(axes, list):
            for i, ax in enumerate(axes):
                if (not isinstance(ax, list) or len(ax) != 2
                        or not isinstance(ax[0], str)
                        or not isinstance(ax[1], int)):
                    errors.append(f"sharding.mesh.axes[{i}]: expected "
                                  "[name, size]")
                else:
                    axis_names.add(ax[0])
        elif mesh is not None:
            errors.append("sharding.mesh.axes: missing or not a list")
        buf_names = {b.get("name") for b in
                     (doc.get("graph") or {}).get("buffers") or ()
                     if isinstance(b, dict)}
        task_names = {t.get("name") for t in
                      (doc.get("graph") or {}).get("tasks") or ()
                      if isinstance(t, dict)}
        for name, spec in (shard.get("specs") or {}).items():
            p = f"sharding.specs.{name}"
            if name not in buf_names:
                errors.append(f"{p}: not a graph buffer")
            dims = spec.get("dims") if isinstance(spec, dict) else None
            if not isinstance(dims, list):
                errors.append(f"{p}.dims: missing or not a list")
                continue
            for d in dims:
                if d is not None and d not in axis_names:
                    errors.append(f"{p}.dims: {d!r} is not a mesh axis")
        for i, step in enumerate(shard.get("steps") or ()):
            p = f"sharding.steps[{i}]"
            if not isinstance(step, dict):
                errors.append(f"{p}: expected object, "
                              f"got {type(step).__name__}")
                continue
            _check_fields(step, p, _SHARDING_STEP_FIELDS, errors, notes)
            if step.get("kind") not in COLLECTIVE_KINDS:
                errors.append(f"{p}.kind: {step.get('kind')!r} not one of "
                              f"{COLLECTIVE_KINDS}")
            if step.get("buffer") not in buf_names:
                errors.append(f"{p}.buffer: {step.get('buffer')!r} is not "
                              "a graph buffer")
            if step.get("task") not in task_names:
                errors.append(f"{p}.task: {step.get('task')!r} is not a "
                              "graph task")
            if step.get("axis") not in axis_names:
                errors.append(f"{p}.axis: {step.get('axis')!r} is not a "
                              "mesh axis")
    if isinstance(doc.get("integrity"), dict):
        _check_fields(doc["integrity"], "integrity", _INTEGRITY_FIELDS,
                      errors, notes)
    if isinstance(doc.get("provenance"), dict):
        _check_fields(doc["provenance"], "provenance", _PROVENANCE_FIELDS,
                      errors, notes)
    opts = doc.get("options")
    if isinstance(opts, dict):
        for k in set(opts) - _OPTIONS_KNOWN:
            notes.append(f"options.{k}: unknown field (ignored — forward-"
                         "compat; the cost cross-check flags semantic drift)")
        hw = opts.get("hw")
        if isinstance(hw, dict):
            for k in set(hw) - _HW_KNOWN:
                notes.append(f"options.hw.{k}: unknown field (ignored — "
                             "forward-compat)")
    plan = doc.get("buffer_plan")
    if isinstance(plan, dict):
        buf_names = {b.get("name") for b in
                     (doc.get("graph") or {}).get("buffers") or ()
                     if isinstance(b, dict)}
        for name, impl in (plan.get("impl") or {}).items():
            if name not in buf_names:
                errors.append(f"buffer_plan.impl.{name}: not a graph buffer")
            if impl not in _IMPLS:
                errors.append(f"buffer_plan.impl.{name}: {impl!r} not one "
                              f"of {_IMPLS}")
    if errors:
        raise ArtifactError(
            "invalid artifact (%d problem%s):\n  " %
            (len(errors), "s" if len(errors) != 1 else "")
            + "\n  ".join(errors))
    return notes


# --------------------------------------------------------------------------
# Import
# --------------------------------------------------------------------------


def _load(source: str | Path | dict) -> dict:
    if isinstance(source, dict):
        return source
    path = Path(source)
    try:
        text = path.read_text()
    except OSError as e:
        raise ArtifactError(f"cannot read artifact {path}: {e}") from e
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise ArtifactError(
            f"{path} is not valid JSON (line {e.lineno}: {e.msg}) — "
            "artifact truncated or corrupted?") from e


def _check_ops_registered(spec: OpSpec, task: str) -> None:
    try:
        op_impl(spec.kind)
    except KeyError:
        raise ArtifactError(
            f"task {task!r}: op kind {spec.kind!r} has no registered "
            f"implementation (registered: {registered_ops()}). Import the "
            "module that registers it (e.g. "
            "repro_torch.kernels.register_all()) "
            "before import_artifact, or register_op yours.") from None
    for part in spec.parts:
        _check_ops_registered(part, task)


def import_artifact(source: str | Path | dict, *,
                    check_integrity: bool = True,
                    backend: str | None = None) -> CompiledDataflow:
    """Reconstruct an executable :class:`CompiledDataflow` from an artifact.

    ``source`` is a path to a JSON file or an already-parsed document.
    The result lowers, executes, and verifies like a freshly compiled
    design — every task re-derives its numerics from its ``OpSpec``
    through the op registry of *this* process.

    Validation is strict (see :func:`validate_artifact`); unknown fields
    and version-minor skew emit :class:`ArtifactWarning`.  With
    ``check_integrity`` (default), the reconstructed graph must hash to
    the recorded ``integrity.structural_hash`` — pass ``False`` to accept
    deliberately hand-edited artifacts.  ``backend`` is the routing
    backend the advisory ``fusion.kernels`` record is checked against (the
    loading program's; :func:`~repro_torch.core.costmodel.routing_backend`
    when ``None``).
    """
    doc = _load(source)
    for note in validate_artifact(doc):
        _warn(note)

    try:
        graph = DataflowGraph.from_dict(doc["graph"])
    except GraphError as e:
        raise ArtifactError(f"graph does not reconstruct: {e}") from e
    for t in graph.tasks:
        if t.spec is not None:
            _check_ops_registered(t.spec, t.name)

    recorded = (doc.get("integrity") or {}).get("structural_hash")
    if check_integrity and recorded:
        got = graph.structural_hash()
        if got != recorded:
            raise ArtifactError(
                f"integrity check failed: reconstructed graph hashes to "
                f"{got[:16]}…, artifact records {recorded[:16]}… — the "
                "document was modified after export (pass "
                "check_integrity=False to import an edited artifact).")

    # Unknown option/hw fields were noted by validate_artifact; drop them
    # here so forward-compat documents reconstruct (known fields still
    # apply and the cost cross-check below flags semantic drift).
    opts_doc = {k: v for k, v in doc["options"].items()
                if k in _OPTIONS_KNOWN}
    if isinstance(opts_doc.get("hw"), dict):
        opts_doc["hw"] = {k: v for k, v in opts_doc["hw"].items()
                          if k in _HW_KNOWN}
    try:
        options = CodoOptions.from_dict(opts_doc)
    except (KeyError, TypeError) as e:
        raise ArtifactError(f"options do not reconstruct: {e}") from e

    def _section(name: str, ctor, payload):
        if not payload:
            return None
        try:
            return ctor(payload)
        except (KeyError, TypeError, ValueError) as e:
            raise ArtifactError(
                f"{name} does not reconstruct ({type(e).__name__}: {e}) — "
                "corrupted values?") from e

    out = CompiledDataflow(
        graph, options,
        buffer_plan=_section("buffer_plan", BufferPlan.from_dict,
                             doc.get("buffer_plan")),
        transfer_plan=_section("transfer_plan", TransferPlan.from_dict,
                               doc.get("transfer_plan")),
        schedule_report=_section("schedule", ScheduleReport.from_dict,
                                 doc.get("schedule")),
        diagnostics=_section("diagnostics", CompileDiagnostics.from_dict,
                             doc.get("diagnostics")),
    )

    # Fusion cross-check: the groups are derivable from graph + plan, so a
    # stored section that disagrees means the document is inconsistent.
    stored = (doc.get("fusion") or {}).get("groups")
    impl = out.buffer_plan.impl if out.buffer_plan else {}
    if stored is not None:
        derived = _fifo_groups(graph, impl)
        if [list(g) for g in stored] != derived:
            raise ArtifactError(
                "fusion.groups disagree with the groups derived from the "
                "graph + buffer_plan — artifact edited inconsistently? "
                f"(stored {len(stored)} groups, derived {len(derived)})")
        # v1.1 `fusion.kernels` is *advisory*: routing depends on the
        # reading process's kernel registry and env switches, so drift
        # warns (the reader re-routes at lower()) instead of failing.
        stored_kernels = (doc.get("fusion") or {}).get("kernels")
        if stored_kernels is not None:
            local = _group_kernels(graph, impl, derived, backend=backend)
            if [str(k) for k in stored_kernels] != local:
                _warn("fusion.kernels drift: the exporter routed "
                      f"{sum(1 for k in stored_kernels if k != XLA_FUSED)} "
                      f"group(s) to routed kernels, this process derives "
                      f"{sum(1 for k in local if k != XLA_FUSED)} — routing "
                      "is re-derived against the local kernel registry at "
                      "lower() time")

    # v1.2 tuning entries: merge the measured routing decisions into the
    # process tuning database so this design (and any same-shaped chain)
    # routes on measurement here too.  The DB digest is part of the
    # lowering memo key, so the merge invalidates stale lowerings.
    tuning = doc.get("tuning") or {}
    if tuning.get("entries"):
        from .tuning import TuningRecord, default_tuning_db
        try:
            default_tuning_db().merge(
                TuningRecord.from_dict(e) for e in tuning["entries"])
        except (KeyError, TypeError, ValueError) as e:
            raise ArtifactError(
                f"tuning does not reconstruct ({type(e).__name__}: {e}) — "
                "corrupted values?") from e

    # v1.4 sharding section: reconstruct the pure-data plan (its stored
    # digest is re-checked by from_dict) and attach it to the design —
    # ``codo_torch.load`` turns it back into a multi-device program.  No
    # device is touched here.
    if doc.get("sharding"):
        from repro_torch.distributed.plan import ShardingPlan
        try:
            out.sharding_plan = ShardingPlan.from_dict(doc["sharding"])
        except (KeyError, TypeError, ValueError) as e:
            raise ArtifactError(
                f"sharding does not reconstruct ({type(e).__name__}: {e}) "
                "— corrupted values?") from e

    # The final cost is recomputed (the model is deterministic pure Python
    # over the stored graph); the recorded summary cross-checks for
    # cost-model drift across versions.  The *baseline* measured the
    # pre-optimization source graph, which the artifact does not carry
    # (passes insert duplicators and rewrite accesses), so it is restored
    # from the recorded cycles — falling back to the optimized graph's
    # sequential latency when the optional `cost` section is absent.
    sequential = bool(coarse_violations(graph))
    out.final = graph_latency(graph, options.hw, out.buffer_plan,
                              sequential=sequential)
    cost = doc.get("cost") or {}
    base = cost.get("baseline_cycles")
    if base is not None:
        out.baseline = GraphCost(
            total_cycles=float(base), start={}, finish={}, costs={},
            bottleneck="", units=0, vmem_bytes=0,
            seconds=float(base) / options.hw.clock_hz)
    else:
        out.baseline = sequential_latency(graph, options.hw)
    recorded_final = cost.get("final_cycles")
    if recorded_final is not None and out.final.total_cycles:
        drift = abs(recorded_final - out.final.total_cycles) \
            / max(out.final.total_cycles, 1.0)
        if drift > 1e-6:
            _warn(f"cost-model drift: artifact records "
                  f"{recorded_final:,.0f} final cycles, this version "
                  f"computes {out.final.total_cycles:,.0f} "
                  f"({drift:.1%}) — exported by a different codo version?")
    return out


def load_artifact(source: str | Path | dict) -> dict:
    """Parse an artifact file (or pass a parsed document through) without
    validating it — the cheap first step when the caller needs to dispatch
    on ``kind`` (design vs. v1.5 ``train_step``) before importing."""
    return _load(source)


# --------------------------------------------------------------------------
# v1.5 train-step documents
# --------------------------------------------------------------------------

_TRAIN_PHASES = ("forward", "backward", "update")


def export_train_step_artifact(phases: dict, train: dict,
                               path: str | Path | None = None, *,
                               weights: dict | None = None,
                               provenance: dict | None = None,
                               backend: str | None = None) -> dict:
    """Serialize a compiled training step (v1.5, ``kind: "train_step"``).

    ``phases`` maps ``forward``/``backward``/``update`` to their
    :class:`CompiledDataflow`; each is exported as a full artifact under
    ``phases.<name>``, so every per-phase guarantee (integrity hash,
    fusion cross-check, tuning merge) holds phase by phase on import.
    ``train`` is the autodiff linking section — loss buffer, seed
    cotangents, residual buffers shared forward→backward, per-parameter
    gradient buffers, and the optimizer attrs.  ``weights`` embeds the
    parameters into the forward phase (v1.3 semantics)."""
    missing = [p for p in _TRAIN_PHASES if p not in phases]
    if missing:
        raise ArtifactError(f"train-step export needs phases "
                            f"{_TRAIN_PHASES}; missing {missing}")
    doc: dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "generator": GENERATOR,
        "kind": TRAIN_STEP_KIND,
        "phases": {name: export_artifact(phases[name], None,
                                         weights=(weights if name == "forward"
                                                  else None),
                                         backend=backend)
                   for name in _TRAIN_PHASES},
        "train": dict(train),
    }
    if provenance is not None:
        doc["provenance"] = dict(provenance)
    if path is not None:
        Path(path).write_text(dumps(doc))
    return doc


def import_train_step(source: str | Path | dict, *,
                      check_integrity: bool = True,
                      backend: str | None = None):
    """Reconstruct the three phases of a v1.5 train-step artifact.

    Returns ``(phases, train, weights)`` — ``phases`` maps
    ``forward``/``backward``/``update`` to executable
    :class:`CompiledDataflow`\\ s (each imported through the full
    per-phase validation of :func:`import_artifact`), ``train`` is the
    linking section, ``weights`` the forward phase's bound parameter
    arrays (empty when the document carries none)."""
    doc = _load(source)
    if doc.get("kind") != TRAIN_STEP_KIND:
        raise ArtifactError(
            f"not a train-step artifact (kind={doc.get('kind')!r}); "
            "use import_artifact for single-design documents")
    errors: list[str] = []
    notes: list[str] = []
    _check_fields(doc, "artifact", _TRAIN_TOP_FIELDS, errors, notes)
    if isinstance(doc.get("train"), dict):
        _check_fields(doc["train"], "train", _TRAIN_FIELDS, errors, notes)
    if isinstance(doc.get("provenance"), dict):
        _check_fields(doc["provenance"], "provenance", _PROVENANCE_FIELDS,
                      errors, notes)
    phase_docs = doc.get("phases")
    if isinstance(phase_docs, dict):
        for p in _TRAIN_PHASES:
            if not isinstance(phase_docs.get(p), dict):
                errors.append(f"phases.{p}: missing or not an object")
    if errors:
        raise ArtifactError(
            "invalid train-step artifact (%d problem%s):\n  " %
            (len(errors), "s" if len(errors) != 1 else "")
            + "\n  ".join(errors))
    for note in notes:
        _warn(note)
    phases = {p: import_artifact(phase_docs[p],
                                 check_integrity=check_integrity,
                                 backend=backend)
              for p in _TRAIN_PHASES}
    train = doc["train"]
    loss = train.get("loss")
    if loss not in set(phases["forward"].graph.buffers):
        raise ArtifactError(f"train.loss: {loss!r} is not a forward-phase "
                            "buffer")
    bwd_bufs = set(phases["backward"].graph.buffers)
    dangling = [r for r in train.get("residuals", ()) if r not in bwd_bufs]
    if dangling:
        raise ArtifactError(
            f"train.residuals: {dangling[:3]} are not backward-phase "
            "buffers — phases edited inconsistently?")
    weights = artifact_weights(phase_docs["forward"])
    return phases, train, weights


def artifact_weights(source: str | Path | dict, *,
                     base_dir: str | Path | None = None) -> dict:
    """The bound weight arrays of a v1.3 artifact, verified against their
    recorded content hashes.

    Returns ``{buffer_name: np.ndarray}`` — empty for documents without a
    ``weights`` section (v1.0–v1.2).  ``source`` is a path or a parsed
    document; for sidecar-format weights the ``.npz`` is resolved relative
    to ``base_dir`` (default: the source path's directory, or the current
    directory for dict sources).  Raises :class:`ArtifactError` on a
    missing sidecar, an array the sidecar does not contain, undecodable
    payload bytes, or any sha256 mismatch — corruption never loads.
    """
    doc = _load(source)
    wts = doc.get("weights")
    if not wts:
        return {}
    fmt = wts.get("format")
    arrays = wts.get("arrays") or {}
    if base_dir is None:
        base_dir = (Path(source).parent
                    if not isinstance(source, dict) else Path("."))
    npz = None
    if fmt == "sidecar":
        sc = Path(base_dir) / wts.get("file", "")
        try:
            npz = np.load(sc)
        except OSError as e:
            raise ArtifactError(
                f"weights sidecar {sc} is missing or unreadable ({e}) — "
                "the artifact's .npz must travel next to its JSON") from e
    elif fmt != "embedded":
        raise ArtifactError(f"weights.format: {fmt!r} not one of "
                            f"{_WEIGHT_FORMATS}")
    out: dict[str, np.ndarray] = {}
    for name in sorted(arrays):
        entry = arrays[name]
        dtype = np.dtype(entry["dtype"])
        shape = tuple(int(s) for s in entry["shape"])
        if npz is not None:
            if name not in npz.files:
                raise ArtifactError(
                    f"weights.arrays.{name}: not present in sidecar "
                    f"{wts.get('file')!r} (has {sorted(npz.files)})")
            arr = np.asarray(npz[name])
            if arr.dtype != dtype or arr.shape != shape:
                raise ArtifactError(
                    f"weights.arrays.{name}: sidecar holds "
                    f"{arr.dtype.name}{list(arr.shape)}, document records "
                    f"{dtype.name}{list(shape)}")
        else:
            try:
                raw = base64.b64decode(entry["data"], validate=True)
                arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
            except (ValueError, KeyError) as e:
                raise ArtifactError(
                    f"weights.arrays.{name}: embedded payload does not "
                    f"decode to {dtype.name}{list(shape)} ({e})") from e
        got = _hash_array(arr)
        if got != entry["sha256"]:
            raise ArtifactError(
                f"weights.arrays.{name}: content hash mismatch — payload "
                f"hashes to {got[:16]}…, document records "
                f"{entry['sha256'][:16]}… (corrupted or tampered weights)")
        out[name] = arr
    return out


# --------------------------------------------------------------------------
# Inspection
# --------------------------------------------------------------------------


def artifact_summary(source: str | Path | dict) -> str:
    """One-paragraph human summary of an artifact (used by the CLI's
    ``--import-artifact`` verb and handy in notebooks)."""
    doc = _load(source)
    if doc.get("kind") == TRAIN_STEP_KIND:
        train = doc.get("train") or {}
        lines = [f"train-step artifact (schema "
                 f"v{doc.get('schema_version')}): loss={train.get('loss')}, "
                 f"{len(train.get('params') or ())} params, "
                 f"{len(train.get('residuals') or ())} residuals"]
        for p in _TRAIN_PHASES:
            phase = (doc.get("phases") or {}).get(p)
            if phase:
                lines += ["  " + ln for ln in
                          artifact_summary(phase).splitlines()]
        return "\n".join(lines)
    g = doc.get("graph") or {}
    cost = doc.get("cost") or {}
    plan = doc.get("buffer_plan") or {}
    impl = plan.get("impl") or {}
    fifo = sum(1 for v in impl.values() if v == FIFO)
    groups = (doc.get("fusion") or {}).get("groups") or []
    kernels = (doc.get("fusion") or {}).get("kernels") or []
    routed = sum(1 for k in kernels if k != XLA_FUSED)
    lines = [
        f"artifact {g.get('name', '?')} (schema v{doc.get('schema_version')})",
        f"  {len(g.get('tasks') or ())} tasks, "
        f"{len(g.get('buffers') or ())} buffers; "
        f"{fifo}/{len(impl)} internal edges FIFO; "
        f"{len(groups)} fusion groups"
        + (f" ({routed} pallas-routed)" if kernels else ""),
    ]
    if cost.get("final_cycles") is not None:
        lines.append(
            f"  cost: {cost['final_cycles']:,.0f} cycles "
            f"({cost.get('speedup', 1.0):.1f}x vs sequential), "
            f"bottleneck={cost.get('bottleneck')}")
    sched = doc.get("schedule") or {}
    if sched:
        lines.append(f"  schedule: units={sched.get('units_used')}, "
                     f"{len(sched.get('degrees') or {})} tasks scheduled")
    return "\n".join(lines)


def diff_artifacts(a: str | Path | dict, b: str | Path | dict) -> list[str]:
    """Compare two artifact documents; return human-readable differences.

    An empty list means the artifacts agree on everything the compiler
    decided: schema version, graph structure (structural hash + counts),
    fusion grouping and kernel routing, autotuning entries, and the v1.4
    ``sharding`` section.  Cosmetic fields (generator string, measured
    milliseconds inside tuning records) are ignored so re-exports of the
    same design diff clean.

    With v1.5 ``provenance`` on both sides, a graph difference is
    classified: *same source, different pipeline* (equal pre-pass source
    hashes — the designs came from one model compiled under different
    options/passes) vs. *different source* (the models themselves
    differ).  Two v1.5 train-step documents diff phase by phase.
    """
    da, db = _load(a), _load(b)
    if (da.get("kind") == TRAIN_STEP_KIND) != (db.get("kind") == TRAIN_STEP_KIND):
        return [f"kind: {da.get('kind')!r} != {db.get('kind')!r} "
                "(train-step vs single-design artifact)"]
    if da.get("kind") == TRAIN_STEP_KIND:
        out = []
        for p in _TRAIN_PHASES:
            out += [f"phases.{p}.{line}" for line in
                    diff_artifacts((da.get("phases") or {}).get(p) or {},
                                   (db.get("phases") or {}).get(p) or {})]
        if da.get("train") != db.get("train"):
            out.append("train: linking sections differ")
        return out
    out: list[str] = []

    def _field(label, va, vb):
        if va != vb:
            out.append(f"{label}: {va!r} != {vb!r}")

    _field("schema_version", da.get("schema_version"), db.get("schema_version"))
    ha = (da.get("integrity") or {}).get("structural_hash")
    hb = (db.get("integrity") or {}).get("structural_hash")
    _field("integrity.structural_hash", ha, hb)
    pa, pb = da.get("provenance") or {}, db.get("provenance") or {}
    sa_hash, sb_hash = (pa.get("source_structural_hash"),
                        pb.get("source_structural_hash"))
    if sa_hash and sb_hash and ha != hb:
        # v1.5: the integrity hash covers the optimized graph; the source
        # hash tells whether the divergence is the model or the pipeline.
        if sa_hash == sb_hash:
            out.append("provenance: same source, different pipeline "
                       f"(source {sa_hash[:16]}…; optimized graphs differ)")
        else:
            out.append(f"provenance: different source "
                       f"({sa_hash[:16]}… != {sb_hash[:16]}…)")
    elif pa.get("origin") != pb.get("origin"):
        _field("provenance.origin", pa.get("origin"), pb.get("origin"))
    ga, gb = da.get("graph") or {}, db.get("graph") or {}
    _field("graph.name", ga.get("name"), gb.get("name"))
    _field("graph.tasks", len(ga.get("tasks") or ()), len(gb.get("tasks") or ()))
    _field("graph.buffers", len(ga.get("buffers") or ()),
           len(gb.get("buffers") or ()))

    fa, fb = da.get("fusion") or {}, db.get("fusion") or {}
    gra = [tuple(g) for g in fa.get("groups") or ()]
    grb = [tuple(g) for g in fb.get("groups") or ()]
    if gra != grb:
        out.append(f"fusion.groups: {len(gra)} group(s) != {len(grb)} group(s)")
    ka, kb = list(fa.get("kernels") or ()), list(fb.get("kernels") or ())
    if ka != kb:
        out.append(f"fusion.kernels: {ka} != {kb}")

    def _tuning(doc):
        entries = (doc.get("tuning") or {}).get("entries") or ()
        return {f"{e.get('signature')}:{e.get('backend')}:{e.get('hw')}":
                (e.get("choice"), json.dumps(e.get("tile"), sort_keys=True))
                for e in entries}

    ta, tb = _tuning(da), _tuning(db)
    for key in sorted(set(ta) - set(tb)):
        out.append(f"tuning[{key}]: only in first")
    for key in sorted(set(tb) - set(ta)):
        out.append(f"tuning[{key}]: only in second")
    for key in sorted(set(ta) & set(tb)):
        if ta[key] != tb[key]:
            out.append(f"tuning[{key}]: choice/tile {ta[key]} != {tb[key]}")

    sa, sb = da.get("sharding"), db.get("sharding")
    if (sa is None) != (sb is None):
        out.append("sharding: present in "
                   + ("first only" if sb is None else "second only"))
    elif sa is not None:
        _field("sharding.strategy", sa.get("strategy"), sb.get("strategy"))
        _field("sharding.mesh", (sa.get("mesh") or {}).get("axes"),
               (sb.get("mesh") or {}).get("axes"))
        _field("sharding.digest", sa.get("digest"), sb.get("digest"))
        na, nb = len(sa.get("steps") or ()), len(sb.get("steps") or ())
        if na != nb:
            out.append(f"sharding.steps: {na} != {nb}")
    return out


def main(argv: list[str] | None = None) -> int:
    """``python -m repro_torch.core.artifact diff A.json B.json``.

    Exit status: 0 = artifacts agree, 1 = they differ (differences on
    stdout, one per line), 2 = usage or load error.  Stable for CI use:
    ``python -m repro_torch.core.artifact diff golden.json fresh.json`` guards
    against silent compiler-decision drift.
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.core.artifact",
        description="Inspect and compare CODO artifact files.")
    sub = parser.add_subparsers(dest="verb", required=True)
    p_diff = sub.add_parser(
        "diff", help="compare two artifacts' compiler decisions")
    p_diff.add_argument("a", help="first artifact JSON")
    p_diff.add_argument("b", help="second artifact JSON")
    p_show = sub.add_parser("summary", help="print a one-paragraph summary")
    p_show.add_argument("a", help="artifact JSON")
    try:
        ns = parser.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0
    try:
        if ns.verb == "summary":
            print(artifact_summary(ns.a))
            return 0
        diffs = diff_artifacts(ns.a, ns.b)
    except (OSError, ValueError, ArtifactError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for line in diffs:
        print(line)
    if diffs:
        print(f"{len(diffs)} difference(s)")
        return 1
    print("artifacts match")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(main())


__all__ = ["SCHEMA_VERSION", "TRAIN_STEP_KIND",
           "ArtifactError",
           "ArtifactWarning", "artifact_summary", "artifact_weights",
           "diff_artifacts", "dumps", "export_artifact",
           "export_train_step_artifact", "import_artifact",
           "import_train_step", "load_artifact", "main", "sidecar_path",
           "validate_artifact"]
