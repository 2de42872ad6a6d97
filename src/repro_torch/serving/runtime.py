"""The CODO serving runtime on PyTorch: bounded queue, dynamic batching,
worker pool, zero-downtime artifact hot-swap.

The counterpart of ``repro/serving/runtime.py``.  A :class:`ServingRuntime`
serves compiled designs on one device — the CUDA card unless the caller
asks for the CPU — and owns

* a **bounded request queue** (``CODO_SERVE_MAX_QUEUE``; overflow raises
  :class:`QueueFullError` — backpressure, never unbounded memory),
* a **dynamic batcher**: requests for the same model arriving within a
  configurable window (``CODO_SERVE_BATCH_WINDOW_MS``) coalesce into ONE
  execution of a leading-batch-dim graph built by
  :func:`repro_torch.core.frontend.batch_graph` and compiled through the
  shared content-addressed :class:`~repro_torch.core.cache.CompileCache` —
  so N same-signature requests cost one compile (then pure cache hits) and
  one dispatch of the design's kernels for the whole group.  Workloads
  whose graphs cannot batch (see
  :func:`~repro_torch.core.frontend.batch_blockers`) fall back to
  per-request execution, correct first.
* an optional **process worker pool** (``CODO_SERVE_WORKERS``, spawn start
  method, never fork: a forked child cannot use its parent's CUDA
  context).  Each worker loads the artifact on the runtime's device, so on
  the card each owns its own CUDA context; the kernel libraries are built
  once, before the pool starts, and the workers only load them.  Workers
  share the disk compile cache and the ``TuningDB`` sidecar via
  environment passed at spawn; a crashed worker breaks the pool, the
  runtime **respawns** it and retries the affected requests (bounded by
  ``max_retries``, then a clean :class:`ServeError` on the future).
* **hot-swap**: :meth:`ServingRuntime.swap` loads a new artifact via
  ``codo_torch.load``, warms it, then atomically flips the serving handle —
  requests already dispatched drain on the old design; queued and new
  requests resolve the new one.  Zero requests are lost.

Requests take numpy arrays or tensors.  A future resolves to ``{output:
torch.Tensor}`` on the host — the counterpart of the reference's numpy
arrays; the device-to-host copy is part of a request's latency, and
nothing that crosses a process boundary lives on the card.

Everything is event-based (``threading.Condition``); nothing in here or
in its tests synchronizes by sleeping.

.. code-block:: python

    rt = ServingRuntime(ServeConfig(batch_window_ms=5, max_batch=8))
    rt.add_model("m", "artifacts/model.json")     # codo_torch.load + warm
    futs = [rt.submit("m", x=arr) for arr in batch]
    outs = [f.result(timeout=30) for f in futs]
    rt.swap("m", "artifacts/model_v2.json")       # zero-downtime
    rt.close()
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = ["QueueFullError", "ServeConfig", "ServeError", "ServeFuture",
           "ServeStats", "ServingRuntime"]


class ServeError(RuntimeError):
    """A request failed permanently (execution error, or a worker crashed
    more than ``max_retries`` times)."""


class QueueFullError(ServeError):
    """The bounded request queue is at ``max_queue`` — backpressure: the
    caller should retry later or shed load."""


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass(frozen=True)
class ServeConfig:
    """Runtime knobs.  :meth:`from_env` reads the documented
    ``CODO_SERVE_*`` environment variables (README "PyTorch / H100
    port")."""
    batch_window_ms: float = 2.0    # how long the head request waits
    max_batch: int = 8              # dispatch early at this group size
    max_queue: int = 256            # bounded queue -> QueueFullError
    workers: int = 0                # 0 = execute in-process
    max_retries: int = 2            # worker-crash retries per request

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        base = dict(
            batch_window_ms=_env_float("CODO_SERVE_BATCH_WINDOW_MS", 2.0),
            max_queue=_env_int("CODO_SERVE_MAX_QUEUE", 256),
            workers=_env_int("CODO_SERVE_WORKERS", 0),
        )
        base.update(overrides)
        return cls(**base)


class ServeFuture:
    """Completion handle for one submitted request (event-based — no
    polling, no sleeps).  ``result`` re-raises the request's failure.
    ``submitted`` and ``resolved`` are ``time.monotonic()`` stamps, so
    ``resolved - submitted`` is the request's latency."""

    def __init__(self, rid: int):
        self.rid = rid
        self.submitted = time.monotonic()
        self.resolved: float | None = None
        self._event = threading.Event()
        self._value: Any = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done "
                               f"after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def _set_result(self, value) -> None:
        self._value = value
        self.resolved = time.monotonic()
        self._event.set()

    def _set_error(self, err: BaseException) -> None:
        self._error = err
        self.resolved = time.monotonic()
        self._event.set()


@dataclass
class ServeStats:
    """Counters a load test reads after the fact.  Compile accounting
    lives on the runtime's ``cache.stats`` — a batched window is exactly
    one cache miss, then hits."""
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    batches: int = 0                # dispatch groups executed
    batched_requests: int = 0       # requests served through batch_graph
    fallback_requests: int = 0      # per-request executions
    retries: int = 0                # requeues after a worker crash
    respawns: int = 0               # worker-pool rebuilds
    swaps: int = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


@dataclass
class _Request:
    rid: int
    model: str
    env: dict
    future: ServeFuture
    retries: int = 0
    arrived: float = field(default_factory=time.monotonic)


class _ModelHandle:
    """One served design generation: the program, its coalescing
    signature, and the memoized per-batch-size batched programs."""

    def __init__(self, name: str, program, path: str | None,
                 generation: int):
        from repro_torch.core.frontend import batch_blockers
        self.name = name
        self.program = program
        self.path = path                    # set when loadable by workers
        self.generation = generation
        self.signature = program.graph.structural_hash()
        self.blockers = batch_blockers(program.source)
        self.batched: dict[int, Any] = {}   # batch size -> CompiledProgram
        self.lock = threading.Lock()        # guards `batched`

    def warm(self) -> None:
        """Lower + execute once on deterministic inputs so the first real
        request never pays lowering or kernel-library loading (hot-swap
        warms the new design *before* the flip)."""
        from repro_torch.models.dataflow_models import random_inputs
        env = self.program.make_env(**random_inputs(self.program.graph))
        self.program.lower(jit=True)(env)
        _synchronize(self.program.device)


def _synchronize(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingRuntime:
    """See the module docstring.  Thread-safe; one dispatcher thread owns
    batching, execution runs inline (``workers=0``) or on the process
    pool.  ``device`` is where the served programs run: CUDA unless the
    caller asks for the CPU (see :func:`repro_torch.api.resolve_device`)."""

    def __init__(self, config: ServeConfig | None = None, *, cache=None,
                 device=None):
        from repro_torch.api import resolve_device
        from repro_torch.core.compiler import default_cache
        self.config = config or ServeConfig.from_env()
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else default_cache()
        self.stats = ServeStats()
        self._models: dict[str, _ModelHandle] = {}
        self._generation = 0
        self._queue: deque[_Request] = deque()
        self._rid = 0
        self._inflight = 0
        self._paused = False
        self._stop = False
        self._cond = threading.Condition()
        self._pool: ProcessPoolExecutor | None = None
        self._pool_lock = threading.Lock()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="codo-serve-dispatch",
            daemon=True)
        self._dispatcher.start()

    # ---- model registry --------------------------------------------------
    def add_model(self, name: str, source, *, warm: bool = True
                  ) -> _ModelHandle:
        """Register a model under ``name``: an artifact path
        (``codo_torch.load`` — required for process workers, which re-load
        it themselves), a parsed artifact dict, or a ready
        ``CompiledProgram`` on the runtime's device."""
        handle = self._make_handle(name, source, warm=warm)
        with self._cond:
            self._models[name] = handle
        return handle

    def swap(self, name: str, source, *, warm: bool = True) -> _ModelHandle:
        """Zero-downtime hot-swap: build and warm the replacement fully,
        then atomically flip the handle.  Requests already dispatched (or
        taken by a worker) finish on the old design; everything after the
        flip — including requests still queued — resolves the new one.
        Nothing is dropped."""
        if name not in self._models:
            raise KeyError(f"no model {name!r} to swap "
                           f"(serving: {sorted(self._models)})")
        handle = self._make_handle(name, source, warm=warm)
        with self._cond:
            self._models[name] = handle
            self.stats.swaps += 1
        return handle

    def _make_handle(self, name: str, source, *, warm: bool) -> _ModelHandle:
        from repro_torch import api as codo_torch
        path: str | None = None
        if isinstance(source, (str, os.PathLike)):
            path = os.fspath(source)
            program = codo_torch.load(path, device=self.device)
        elif isinstance(source, dict):
            program = codo_torch.load(source, device=self.device)
        else:
            program = source        # a ready CompiledProgram
            if program.device != self.device:
                raise ValueError(f"program runs on {program.device}, the "
                                 f"runtime serves on {self.device}")
        with self._cond:
            self._generation += 1
            gen = self._generation
        handle = _ModelHandle(name, program, path, gen)
        if warm and self.config.workers == 0:
            handle.warm()
        return handle

    # ---- request path ----------------------------------------------------
    def submit(self, model: str, **arrays) -> ServeFuture:
        """Enqueue one request (named input arrays or tensors, the
        ``CompiledProgram`` keyword convention).  Returns immediately with
        a :class:`ServeFuture`; raises :class:`QueueFullError` at
        ``max_queue`` and ``KeyError`` for an unregistered model."""
        with self._cond:
            if self._stop:
                raise ServeError("runtime is closed")
            if model not in self._models:
                raise KeyError(f"no model {model!r} "
                               f"(serving: {sorted(self._models)})")
            if len(self._queue) >= self.config.max_queue:
                raise QueueFullError(
                    f"request queue is full ({self.config.max_queue}); "
                    "retry later (CODO_SERVE_MAX_QUEUE raises the bound)")
            self._rid += 1
            fut = ServeFuture(self._rid)
            self._queue.append(_Request(self._rid, model, dict(arrays), fut))
            self.stats.submitted += 1
            self._cond.notify_all()
        return fut

    # ---- test/ops hooks (event-based; tests never sleep) -----------------
    def pause(self) -> None:
        """Stop dispatching (requests keep queueing — the deterministic
        way to fill one batching window, or to drive the queue to
        ``max_queue`` in a backpressure test)."""
        with self._cond:
            self._paused = True
            self._cond.notify_all()

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def flush(self, timeout: float | None = None) -> bool:
        """Block until the queue is empty and nothing is in flight."""
        with self._cond:
            return self._cond.wait_for(
                lambda: not self._queue and self._inflight == 0, timeout)

    def close(self, timeout: float | None = 30.0) -> None:
        """Drain, stop the dispatcher, shut the pool down."""
        self.flush(timeout)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._dispatcher.join(timeout)
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True, cancel_futures=True)
                self._pool = None

    def __enter__(self) -> "ServingRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- dispatcher ------------------------------------------------------
    def _dispatch_loop(self) -> None:
        cfg = self.config
        window = cfg.batch_window_ms / 1e3
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._stop
                    or (self._queue and not self._paused))
                if self._stop:
                    return
                head = self._queue[0]
                deadline = head.arrived + window

                def group_size() -> int:
                    return sum(1 for r in self._queue
                               if r.model == head.model)

                # Hold the window open for the head's group: dispatch as
                # soon as it reaches max_batch, or when the window ends.
                while not self._stop and not self._paused:
                    if group_size() >= cfg.max_batch:
                        break
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                if self._stop:
                    return
                if self._paused:
                    continue
                batch: list[_Request] = []
                rest: deque[_Request] = deque()
                for r in self._queue:
                    if r.model == head.model and len(batch) < cfg.max_batch:
                        batch.append(r)
                    else:
                        rest.append(r)
                self._queue = rest
                handle = self._models.get(head.model)
                self._inflight += len(batch)
                self._cond.notify_all()
            if handle is None:      # model removed while queued
                self._finish(batch, error=ServeError(
                    f"model {head.model!r} is no longer served"))
                continue
            if self.config.workers > 0 and handle.path is not None:
                self._dispatch_pool(handle, batch)
            else:
                self._execute_inline(handle, batch)

    def _finish(self, batch: list[_Request], *, results=None,
                error: BaseException | None = None) -> None:
        with self._cond:
            self._inflight -= len(batch)
            self.stats.batches += 1
            if error is None:
                self.stats.completed += len(batch)
            else:
                self.stats.failed += len(batch)
            self._cond.notify_all()
        for i, r in enumerate(batch):
            if error is None:
                r.future._set_result(results[i])
            else:
                r.future._set_error(error)

    def _requeue(self, batch: list[_Request], err: BaseException) -> None:
        """After a worker crash: bounded retries, then a clean error."""
        retry, dead = [], []
        for r in batch:
            r.retries += 1
            (retry if r.retries <= self.config.max_retries else dead).append(r)
        with self._cond:
            self.stats.retries += len(retry)
            self._inflight -= len(batch)
            self.stats.failed += len(dead)
            for r in retry:
                self._queue.appendleft(r)
            self._cond.notify_all()
        for r in dead:
            r.future._set_error(ServeError(
                f"request {r.rid} failed after {r.retries} worker "
                f"crashes ({type(err).__name__}: {err})"))

    # ---- in-process execution -------------------------------------------
    def _execute_inline(self, handle: _ModelHandle,
                        batch: list[_Request]) -> None:
        try:
            results = _run_batch(handle, batch, self.cache, self.stats,
                                 self._cond)
        except Exception as e:          # noqa: BLE001 — becomes the response
            self._finish(batch, error=ServeError(
                f"execution failed for {handle.name!r}: "
                f"{type(e).__name__}: {e}"))
            return
        self._finish(batch, results=results)

    # ---- process-pool execution -----------------------------------------
    def _ensure_pool(self) -> ProcessPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                import multiprocessing as mp
                if self.device.type == "cuda":
                    # Built here once; the workers only load the libraries.
                    from repro_torch.kernels import common, libraries
                    common.build_all(libraries())
                env = {
                    "CODO_CACHE_DIR": getattr(self.cache, "disk_dir", "")
                    and str(self.cache.disk_dir),
                    "CODO_TUNING_DB": os.environ.get("CODO_TUNING_DB", ""),
                    "CODO_SERVE_FAULT":
                        os.environ.get("CODO_SERVE_FAULT", ""),
                }
                # spawn, never fork: a forked child cannot use the CUDA
                # context its parent holds.
                self._pool = ProcessPoolExecutor(
                    max_workers=self.config.workers,
                    mp_context=mp.get_context("spawn"),
                    initializer=_serve_worker_init, initargs=(env,))
            return self._pool

    def _break_pool(self, pool: ProcessPoolExecutor) -> None:
        """Forget a broken pool; the next dispatch spawns a fresh one.  Its
        own manager thread has already terminated its workers — and holds
        the pool's shutdown lock while it runs the futures' callbacks, so
        calling ``pool.shutdown`` from here would deadlock."""
        with self._pool_lock:
            if self._pool is not pool:
                return              # another failed dispatch got here first
            self._pool = None
        with self._cond:
            self.stats.respawns += 1

    def _dispatch_pool(self, handle: _ModelHandle,
                       batch: list[_Request]) -> None:
        pool = self._ensure_pool()
        try:
            fut = pool.submit(
                _serve_worker_run, handle.path, handle.generation,
                [_host_env(r.env) for r in batch], not handle.blockers,
                str(self.device))
        except BrokenProcessPool as e:
            self._break_pool(pool)
            self._requeue(batch, e)
            return
        fut.add_done_callback(
            lambda f, b=batch, h=handle, p=pool: self._pool_done(h, b, p, f))

    def _pool_done(self, handle: _ModelHandle, batch: list[_Request],
                   pool: ProcessPoolExecutor, fut) -> None:
        try:
            results, batched = fut.result()
        except BrokenProcessPool as e:
            self._break_pool(pool)
            self._requeue(batch, e)
            return
        except Exception as e:          # noqa: BLE001 — becomes the response
            self._finish(batch, error=ServeError(
                f"worker execution failed for {handle.name!r}: "
                f"{type(e).__name__}: {e}"))
            return
        with self._cond:
            if batched:
                self.stats.batched_requests += len(batch)
            else:
                self.stats.fallback_requests += len(batch)
        self._finish(batch, results=results)


def _host_env(env: dict) -> dict:
    """A request's values as they may cross to a worker: tensors on the
    host (a CUDA tensor is never pickled across the process boundary)."""
    import torch
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in env.items()}


# --------------------------------------------------------------------------
# Batched execution core — shared by the in-process path and the workers.
# --------------------------------------------------------------------------


def _batched_program(handle: _ModelHandle, size: int, cache):
    """The leading-batch-dim program for ``size`` requests, compiled
    through the shared cache (one miss per (design, size) — every later
    window is a pure cache hit) on the served program's device and
    memoized on the handle."""
    from repro_torch import api as codo_torch
    from repro_torch.core.frontend import batch_graph
    with handle.lock:
        prog = handle.batched.get(size)
        if prog is None:
            bg = batch_graph(handle.program.source, size)
            prog = codo_torch.compile(
                bg, device=handle.program.device,
                options=handle.program.compiled.options, cache=cache)
            weights = {b.name for b in bg.weights()}
            bound = {k: v for k, v in handle.program._bindings.items()
                     if k in weights}
            if bound:
                prog.bind(**bound)
            handle.batched[size] = prog
    return prog


def _stack(graph, name: str, values: list, device):
    """Requests' values for input ``name`` as one tensor with a leading
    batch dim, at the buffer's dtype on ``device``."""
    import torch

    from repro_torch.api import torch_dtype
    dtype = torch_dtype(graph.buffers[name].dtype)
    return torch.stack([torch.as_tensor(
        v if isinstance(v, torch.Tensor) else np.asarray(v), dtype=dtype,
        device=device) for v in values])


def _run_batch(handle: _ModelHandle, batch: list[_Request], cache,
               stats: ServeStats | None = None,
               cond: threading.Condition | None = None) -> list:
    """Execute one dispatch group: coalesced through ``batch_graph`` when
    the design allows it and every request binds exactly the inputs,
    otherwise per-request.  Returns one ``{output: host tensor}`` dict per
    request (a coalesced request's answer is a row of the batch's).  The batched answers are the same function of each request;
    whether they are bit for bit the sequential ones depends on the
    kernels the larger products pick (the CPU tests pin it at a small
    size, the card smoke run measures it at GPT-2-medium width)."""
    program = handle.program
    inputs = list(program.input_names)
    coalesce = (len(batch) > 1 and not handle.blockers
                and all(set(r.env) == set(inputs) for r in batch))
    if coalesce:
        bp = _batched_program(handle, len(batch), cache)
        stacked = {n: _stack(program.graph, n, [r.env[n] for r in batch],
                             program.device) for n in inputs}
        out = bp.lower(jit=True)(bp.make_env(**stacked))
        # One copy to the host; each answer is a view of its row, as the
        # reference's numpy answers are (a copy a row cost more than the
        # batch's device time on the card).
        host = {n: out[n].cpu() for n in program.output_names}
        results = [{n: host[n][i] for n in program.output_names}
                   for i in range(len(batch))]
    else:
        results = []
        low = program.lower(jit=True)
        for r in batch:
            out = low(program.make_env(**r.env))
            results.append({n: out[n].cpu() for n in program.output_names})
    if stats is not None:
        with cond:
            if coalesce:
                stats.batched_requests += len(batch)
            else:
                stats.fallback_requests += len(batch)
    return results


# --------------------------------------------------------------------------
# Worker-process side (module-level: must pickle by reference under spawn).
# --------------------------------------------------------------------------

_WORKER_PROGRAMS: dict = {}


def _serve_worker_init(env: dict) -> None:
    """Runs once in each spawned worker: point this process at the shared
    disk compile cache and tuning-DB sidecar before any import binds its
    defaults."""
    for k, v in env.items():
        if v:
            os.environ[k] = v


def _maybe_fault() -> None:
    """Test-only crash injection (``CODO_SERVE_FAULT``): ``crash`` dies on
    every request; ``crash_once:<marker>`` dies only while the marker file
    exists and consumes it first, so exactly one crash happens no matter
    how many workers race."""
    fault = os.environ.get("CODO_SERVE_FAULT", "")
    if fault == "crash":
        os._exit(1)
    if fault.startswith("crash_once:"):
        marker = fault.split(":", 1)[1]
        try:
            os.unlink(marker)
        except FileNotFoundError:
            return
        os._exit(1)


def _serve_worker_run(path: str, generation: int, envs: list[dict],
                      batch_ok: bool, device: str):
    """One dispatch group inside a worker, on ``device``.  The artifact is
    loaded (and its batched variants compiled) at most once per (path,
    generation) per worker; the compiles go through the shared disk cache,
    so sibling workers hit what the first one stored.  Returns host
    tensors only."""
    _maybe_fault()
    key = (path, generation)
    handle = _WORKER_PROGRAMS.get(key)
    if handle is None:
        from repro_torch import api as codo_torch
        handle = _ModelHandle("worker", codo_torch.load(path, device=device),
                              path, generation)
        _WORKER_PROGRAMS[key] = handle
    from repro_torch.core.compiler import default_cache
    batch = [_Request(i, "worker", env, ServeFuture(i))
             for i, env in enumerate(envs)]
    if not batch_ok:
        handle.blockers = handle.blockers or ["disabled"]
    results = _run_batch(handle, batch, default_cache())
    coalesced = len(envs) > 1 and batch_ok and not handle.blockers
    return results, coalesced
