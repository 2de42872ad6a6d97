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
transformer stack, so import it explicitly.
"""

from .runtime import (QueueFullError, ServeConfig, ServeError, ServeFuture,
                      ServeStats, ServingRuntime)

__all__ = ["QueueFullError", "ServeConfig", "ServeError", "ServeFuture",
           "ServeStats", "ServingRuntime"]
