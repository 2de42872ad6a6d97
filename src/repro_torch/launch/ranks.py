"""One process a card: the ranks a multi-card mesh runs in.

The reference runs a mesh over several devices from one process
(``jax.jit`` over a ``Mesh``).  The port's counterpart for a mesh whose
positions sit on several cards is PyTorch's own idiom: one process a
card, joined by ``torch.distributed``.  :func:`spawn` starts ``world``
such processes and runs ``fn(rank, world, *args)`` in each, inside a
process group:

* the processes come from the ``spawn`` start method (nothing of the
  parent's state is forked, so CUDA starts clean in every child);
* they meet at a :class:`torch.distributed.FileStore` in a temporary
  directory: no TCP, no address, no network;
* the backend is NCCL on the card, each child on card ``rank``
  (``torch.cuda.set_device``); gloo when the caller asks for the CPU
  (``device="cpu"``), or explicitly (``backend="gloo"``), in which case
  ranks on the card share the cards round robin, as the two-rank check
  on one card needs.  There is no fallback: NCCL with more ranks than
  cards raises, as NCCL itself refuses two ranks on one card;
* joining the group and the whole run each have a time limit.  A child's
  exception is raised again in the parent with the child's traceback
  (:class:`RankError`), and the other children are stopped; a child
  that is still running at the limit is killed, and the parent raises
  :class:`RankTimeout`.

Inside a child, :func:`rank_device` is where the rank computes (its card,
or the CPU when spawn was asked for it), and :func:`repro_torch.launch.
mesh.rank_mesh` deals a mesh's positions to the ranks on those devices, and the sharded steps run each rank's positions
(``distributed/spmd.py``, ``core/lowering.py``).  ``fn``'s return value
comes back to the parent pickled: give back numbers, numpy arrays or CPU
tensors.

Nothing here touches a device or starts a process when it is imported.
"""

from __future__ import annotations

import inspect
import os
import pickle
import queue as _queue
import tempfile
import time
import traceback
from datetime import timedelta

__all__ = ["RankError", "RankTimeout", "rank_device", "spawn"]

# Seconds a child may take to join the process group, and a collective
# may wait for the other ranks.
INIT_TIMEOUT_S = 120.0

# This process's device when :func:`spawn` started it, else None.
_DEVICE = None


class RankError(RuntimeError):
    """A rank raised; the message holds its traceback."""


class RankTimeout(RankError):
    """A rank was still running (or joining) at the time limit."""


def rank_device():
    """The device :func:`spawn` put this rank on: its card (``cuda:<i>``),
    or the CPU when spawn was given ``device="cpu"``; None in a process
    that spawn did not start."""
    return _DEVICE


def _backend(device, backend):
    import torch
    if backend is not None:
        return backend
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    return "nccl"


def _child(rank: int, world: int, store_path: str, backend: str,
           on_card: bool, payload: bytes, results) -> None:
    import torch
    import torch.distributed as dist
    global _DEVICE
    try:
        if on_card:
            torch.cuda.set_device(rank % torch.cuda.device_count())
            _DEVICE = torch.device("cuda", torch.cuda.current_device())
        else:
            _DEVICE = torch.device("cpu")
        store = dist.FileStore(store_path, world)
        kw = {}
        if backend == "nccl" and "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            # the communicator made now, on this card, not at first use
            kw["device_id"] = _DEVICE
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=INIT_TIMEOUT_S),
                                **kw)
        fn, args = pickle.loads(payload)
        out = fn(rank, world, *args)
        if on_card:
            torch.cuda.synchronize()
        results.put(("ok", rank, pickle.dumps(out)))
    except BaseException:                   # the parent raises it again
        results.put(("error", rank, traceback.format_exc()))
        results.close()
        results.join_thread()               # the message out before exit
        raise
    finally:                                # after the report: it may wait
        if dist.is_initialized():           # for ranks that have stopped
            dist.destroy_process_group()


def spawn(fn, world: int, *args, device=None, backend: str | None = None,
          timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` processes, one a rank,
    inside one process group, and return their results in rank order.

    ``device`` is where the ranks compute: the card unless the caller asks
    for the CPU (``device="cpu"``).  ``backend`` is NCCL on the card and
    gloo on the CPU unless given.  ``timeout_s`` bounds the whole run, the
    join of the process group included (itself bounded by
    ``INIT_TIMEOUT_S``, which also bounds each collective's wait).  ``fn``
    and ``args`` must pickle (a module-level function)."""
    import multiprocessing as mp

    import torch
    backend = _backend(device, backend)
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("spawn on the card needs CUDA; pass device='cpu' "
                           "to run the ranks on the CPU")
    if backend == "nccl":
        if not on_card:
            raise ValueError("NCCL runs on the card: pass backend='gloo' "
                             "for ranks on the CPU")
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(
                f"NCCL needs one card a rank: {world} ranks, {cards} cards "
                f"(NCCL refuses two ranks on one card; backend='gloo' "
                f"shares them)")
    payload = pickle.dumps((fn, args))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="codo-ranks-") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(r, world, store_path, backend, on_card,
                                   payload, results),
                             name=f"codo-rank-{r}")
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, world, timeout_s)
        finally:
            _stop(procs)
            results.close()
            results.join_thread()


def _collect(procs: list, results, world: int, timeout_s: float) -> list:
    """Every rank's result, in rank order; raises at the first error, at a
    child that ended without a word, or at the time limit."""
    deadline = time.monotonic() + timeout_s
    got: dict = {}
    while len(got) < world:
        left = deadline - time.monotonic()
        if left <= 0:
            waiting = sorted(set(range(world)) - set(got))
            raise RankTimeout(f"ranks {waiting} of {world} still running "
                              f"after {timeout_s:.0f} s: killed")
        try:
            kind, rank, body = results.get(timeout=min(left, 0.5))
        except _queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode is not None]
            if dead:
                # a message may still be in the pipe behind its exit
                try:
                    kind, rank, body = results.get(timeout=2.0)
                except _queue.Empty:
                    raise RankError(
                        f"rank {dead[0]} of {world} exited with code "
                        f"{procs[dead[0]].exitcode} and no result") from None
            else:
                continue
        if kind == "error":
            raise RankError(f"rank {rank} of {world} raised:\n{body}")
        got[rank] = pickle.loads(body)
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    return [got[r] for r in range(world)]


def _stop(procs: list) -> None:
    """End every child still running: terminate, then kill."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=5.0)
        if p.is_alive():
            p.kill()
            p.join(timeout=5.0)
