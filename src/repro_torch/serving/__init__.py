"""repro_torch.serving — the serving stack of the PyTorch port.

* :mod:`repro_torch.serving.runtime` — :class:`ServingRuntime`: bounded
  queue, dynamic batching, process worker pool, zero-downtime artifact
  hot-swap, on the card unless the caller asks for the CPU.
* :mod:`repro_torch.serving.cli` — the ``python -m
  repro_torch.serving.cli`` launcher.

LM token generation (the reference's ``serving/generator.py``) is not
ported yet (``ROADMAP.md``, Queue 1 item 7).
"""

from .runtime import (QueueFullError, ServeConfig, ServeError, ServeFuture,
                      ServeStats, ServingRuntime)

__all__ = ["QueueFullError", "ServeConfig", "ServeError", "ServeFuture",
           "ServeStats", "ServingRuntime"]
