"""repro_torch.serving — the serving stack of the PyTorch port.

* :mod:`repro_torch.serving.runtime` — :class:`ServingRuntime`: bounded
  queue, dynamic batching, process worker pool, zero-downtime artifact
  hot-swap, on the card unless the caller asks for the CPU.
* :mod:`repro_torch.serving.cli` — the ``python -m
  repro_torch.serving.cli`` launcher (``repro_torch.launch.serve`` is its
  deprecated alias).
* :mod:`repro_torch.serving.generator` — slot-based LM token generation
  with a captured decode step (``repro_torch.serving.serve`` is its
  deprecated alias).

Only the runtime names are imported eagerly; the generator pulls in the
transformer stack, so its sharded steps ``jit_serve_step`` and
``jit_prefill_step`` are imported at first use.
"""

from .runtime import (QueueFullError, ServeConfig, ServeError, ServeFuture,
                      ServeStats, ServingRuntime)

__all__ = ["QueueFullError", "ServeConfig", "ServeError", "ServeFuture",
           "ServeStats", "ServingRuntime", "jit_prefill_step",
           "jit_serve_step"]


def __getattr__(name):
    if name in ("jit_serve_step", "jit_prefill_step"):
        from . import generator
        return getattr(generator, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
