"""Deprecated alias — the generation driver lives in
:mod:`repro_torch.serving.generator` (the ``serve`` name belongs to the
serving *runtime* stack: ``repro_torch.serving.runtime`` +
``repro_torch.serving.cli``).

The port's copy of ``repro/serving/serve.py``: it warns once on import
and re-exports the generator's public names.
"""

from __future__ import annotations

import warnings

warnings.warn(
    "repro_torch.serving.serve is deprecated: import "
    "repro_torch.serving.generator (generation driver) or "
    "repro_torch.serving.runtime (serving runtime) instead",
    DeprecationWarning, stacklevel=2)

from .generator import (Generator, Request, build_prefill_step,  # noqa: E402
                        build_serve_step, jit_prefill_step, jit_serve_step)

__all__ = ["Generator", "Request", "build_prefill_step", "build_serve_step",
           "jit_prefill_step", "jit_serve_step"]
