"""The captured step runner: the port's counterpart of ``jax.jit``.

``lower(compiled, jit=True)`` in the reference hands the whole step list
to XLA, which fuses it and dispatches it once.  Here a lowered step list
on a CUDA device is captured into a ``torch.cuda.CUDAGraph`` per input
signature and replayed, so a call costs one graph launch of host time
instead of one launch and its Python for every task:

* **First call of a signature.**  The step list runs eagerly on a side
  stream (this builds and loads the kernels and sets their attributes),
  and its answers are the call's.  The blocks that run freed go back to
  the card (the graph's private memory pool cannot reuse them).  Then
  the step list is captured over
  static input buffers laid out as the call's tensors are
  (``torch.empty_strided``).  The signature is the device and, for every
  env entry, its name, shape, dtype and strides.
* **Later calls.**  The env is copied into the static buffers, the graph
  replays, and each output comes back as a fresh tensor: no call
  overwrites an answer an earlier call returned.  Every entry is copied on
  every call, weights too, so an in-place change to a bound weight and a
  train step's new parameters are seen by the next call.
* **Bound entries** (``CapturedProgram(..., bound=names)``) are captured
  where they lie and never copied: the graph reads and writes those very
  tensors, so a step that writes one in place (a decode step's cache)
  writes it on every replay.  Their data pointers join the signature, so
  a bound entry replaced by another tensor is captured anew.
* **CPU tensors** run the step list as it is; there is no graph to
  capture there.
* **A sharded program** (``lower(..., sharding=)``) is a step list too:
  the split of the env onto the mesh's positions, each task's lockstep
  step over the positions with its collectives, and the reassembly of
  the outputs.  When every position sits on the card of the env, the
  whole lockstep run is one graph.
* **A rank of a mesh split over ranks** (one process a card,
  :func:`~repro_torch.launch.mesh.rank_mesh`) captures its own positions'
  steps with their NCCL collectives inside the graph.  The first call's
  eager run on the side stream makes the communicators and runs every
  collective once before the capture begins; every rank runs the same
  program, so every rank captures the same collective sequence, and a
  replay is bit for bit the eager run.
* **No fallback.**  A step that cannot be captured (one that reads a
  device value on the host, say) raises :class:`CaptureError` naming the
  step; the call never runs eagerly instead.

Kernel launch counters (:class:`~repro_torch.kernels.common.CudaLibrary`)
count executed launches either way: launches made while capturing are
recorded, not counted (those of a backward too, which the autograd engine
enqueues from a thread of its own), and every replay counts them.

Captured graphs live in one LRU bounded like the lowering memo
(``CODO_LOWER_CACHE_SIZE``); :func:`clear_graphs` (called by
``lowering.clear_lower_cache``) releases them with their memory pools,
and a program's graphs go when the program is collected (no one can
replay them then, and a graph pins its bound entries).
Captures take a process-wide lock and use ``thread_local`` capture mode,
so a thread may capture a new design while others replay theirs.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import Counter, OrderedDict
from typing import Any


class CaptureError(RuntimeError):
    """A step of a lowered program could not be captured into a CUDA
    graph (or the capture could not be completed)."""


def run_steps(steps: list, outputs: list[str], env: dict) -> dict:
    """The step list run eagerly: each step reads the scope and adds its
    outputs to it."""
    scope = dict(env)
    for _name, f in steps:
        scope.update(f(scope))
    return {k: scope[k] for k in outputs}


# (runner serial, signature) -> _Graph, least recently used first.
_GRAPHS: OrderedDict[tuple, "_Graph"] = OrderedDict()
_GRAPHS_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()          # one capture at a time
_SERIALS = itertools.count()
_DEAD: list[int] = []                     # serials of collected programs
_STREAMS: dict = {}                       # device -> capture stream
# Captures made, host seconds spent capturing, replays run.
CAPTURE_STATS = {"captures": 0, "capture_s": 0.0, "replays": 0}


def _cache_size() -> int:
    from .lowering import _lower_cache_size
    return _lower_cache_size()


def clear_graphs() -> None:
    """Release every captured graph (and its memory pool)."""
    with _GRAPHS_LOCK:
        _GRAPHS.clear()
        CAPTURE_STATS.update(captures=0, capture_s=0.0, replays=0)


def graph_count() -> int:
    with _GRAPHS_LOCK:
        _purge()
        return len(_GRAPHS)


def _forget(serial: int) -> None:
    """A collected program's finalizer: its graphs go at the next look at
    the LRU.  It takes no lock, since a collection can run while this
    thread holds ``_GRAPHS_LOCK``."""
    _DEAD.append(serial)


def _purge(*serials: int) -> None:
    """Drop the graphs of ``serials`` and of collected programs; the
    caller holds ``_GRAPHS_LOCK``."""
    dead = set(serials)
    while _DEAD:
        dead.add(_DEAD.pop())
    for key in [k for k in _GRAPHS if k[0] in dead]:
        del _GRAPHS[key]


def _card_device(env: dict):
    """The CUDA device every env value lies on, or None (a CPU tensor, a
    non-tensor value, or tensors on several devices: run eagerly)."""
    import torch
    devices = set()
    for v in env.values():
        if not isinstance(v, torch.Tensor):
            return None
        devices.add(v.device)
    if len(devices) != 1:
        return None
    (device,) = devices
    return device if device.type == "cuda" else None


def _signature(device, env: dict, bound: frozenset = frozenset()) -> tuple:
    return (str(device), tuple(sorted(
        (k, tuple(v.shape), v.dtype, tuple(v.stride()),
         v.data_ptr() if k in bound else None)
        for k, v in env.items())))


def _static_like(v):
    """An uninitialised buffer laid out as ``v``: its strides kept (views
    stay views of the same layout), unless some dimension overlaps itself
    (a stride of 0), which a copy cannot write into."""
    import torch
    if any(s == 0 and n > 1 for s, n in zip(v.stride(), v.shape)):
        return torch.empty(v.shape, dtype=v.dtype, device=v.device)
    return torch.empty_strided(tuple(v.shape), tuple(v.stride()),
                               dtype=v.dtype, device=v.device)


def _capture_stream(device):
    import torch
    stream = _STREAMS.get(str(device))
    if stream is None:
        stream = _STREAMS[str(device)] = torch.cuda.Stream(device)
    return stream


class _Graph:
    """One captured step list: the graph, its static inputs and outputs,
    and the kernel launches one replay executes."""

    def __init__(self, device, graph, static_in: dict, static_out: dict,
                 launches: Counter, bound: frozenset):
        self.device = device
        self.graph = graph
        self.names = sorted(k for k in static_in if k not in bound)
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches
        self.lock = threading.Lock()
        self.done = None            # recorded after each replay's clones

    def replay(self, env: dict) -> dict:
        import torch
        with self.lock:
            stream = torch.cuda.current_stream(self.device)
            if self.done is None:
                self.done = torch.cuda.Event()
            # A replay from another stream waits for the last one's clones
            # before it writes the static inputs.
            stream.wait_event(self.done)
            if self.names:
                torch._foreach_copy_([self.static_in[k] for k in self.names],
                                     [env[k] for k in self.names])
            self.graph.replay()
            out = {k: v.clone() for k, v in self.static_out.items()}
            self.done.record(stream)
        for (lib, name), n in self.launches.items():
            lib.count(name, n)
        CAPTURE_STATS["replays"] += 1
        return out


class CapturedProgram:
    """A lowered step list that captures itself into a CUDA graph per
    input signature on the card and runs eagerly on the CPU (see the
    module docstring).  ``steps`` are ``(task name, fn)`` pairs; the env
    entries named in ``bound`` are captured in place, never copied."""

    def __init__(self, steps: list, outputs: list[str], bound=()):
        self.steps = list(steps)
        self.outputs = list(outputs)
        self.bound = frozenset(bound)
        self.serial = next(_SERIALS)
        weakref.finalize(self, _forget, self.serial).atexit = False

    def __call__(self, env: dict[str, Any]) -> dict[str, Any]:
        device = _card_device(env)
        if device is None:
            return run_steps(self.steps, self.outputs, env)
        key = (self.serial, _signature(device, env, self.bound))
        with _GRAPHS_LOCK:
            _purge()
            entry = _GRAPHS.get(key)
            if entry is not None:
                _GRAPHS.move_to_end(key)
        if entry is not None:
            return entry.replay(env)
        return self._first_call(key, device, env)

    def graphs(self) -> int:
        """The graphs this program holds (one a signature captured)."""
        with _GRAPHS_LOCK:
            _purge()
            return sum(k[0] == self.serial for k in _GRAPHS)

    def release(self) -> None:
        """Drop this program's captured graphs."""
        with _GRAPHS_LOCK:
            _purge(self.serial)

    def _first_call(self, key: tuple, device, env: dict) -> dict:
        import torch
        with _CAPTURE_LOCK:
            with _GRAPHS_LOCK:
                entry = _GRAPHS.get(key)
            if entry is not None:           # captured while we waited
                return entry.replay(env)
            caller = torch.cuda.current_stream(device)
            side = _capture_stream(device)
            with torch.cuda.device(device):
                # Static inputs belong to the caller's stream: freed with
                # the graph, their blocks go back behind its replays.
                static_in = {k: v if k in self.bound else _static_like(v)
                             for k, v in env.items()}
                side.wait_stream(caller)
                try:
                    with torch.cuda.stream(side):
                        out = run_steps(self.steps, self.outputs, env)
                        for k, v in env.items():
                            if k not in self.bound:
                                static_in[k].copy_(v)
                        # The eager run's freed blocks back to the card:
                        # the graph allocates from a private pool, which
                        # cannot reuse them (a train step's temporaries).
                        torch.cuda.empty_cache()
                        t0 = time.perf_counter()
                        graph, static_out, launches = self._capture(
                            static_in)
                        CAPTURE_STATS["capture_s"] += time.perf_counter() - t0
                finally:                    # the caller's stream waits even
                    caller.wait_stream(side)    # when a capture fails
            for v in out.values():          # answers made on the side stream
                v.record_stream(caller)
            entry = _Graph(device, graph, static_in, static_out, launches,
                           self.bound)
            with _GRAPHS_LOCK:
                _GRAPHS[key] = entry
                while len(_GRAPHS) > _cache_size():
                    _GRAPHS.popitem(last=False)
            CAPTURE_STATS["captures"] += 1
        return out

    def _capture(self, static_in: dict):
        """Capture the step list over ``static_in`` on the current (side)
        stream.  Raises :class:`CaptureError` naming the step that
        failed."""
        import torch

        from repro_torch.kernels.common import recording_launches
        graph = torch.cuda.CUDAGraph()
        launches: Counter = Counter()
        failed: BaseException | None = None
        where = "capture start"
        scope = dict(static_in)
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            with recording_launches(
                    launches, torch.cuda.current_stream().cuda_stream):
                for where, f in self.steps:
                    scope.update(f(scope))
            where = "capture end"
        except Exception as e:              # noqa: BLE001 — re-raised below
            failed = e
        finally:
            try:
                graph.capture_end()
            except Exception as e:          # noqa: BLE001
                if failed is None:
                    failed = e
        if failed is not None:
            raise CaptureError(
                f"cannot capture step {where!r} into a CUDA graph: "
                f"{type(failed).__name__}: {failed}") from failed
        return graph, {k: scope[k] for k in self.outputs}, launches


__all__ = ["CAPTURE_STATS", "CaptureError", "CapturedProgram", "clear_graphs",
           "graph_count", "run_steps"]
