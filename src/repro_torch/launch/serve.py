"""Deprecated alias — the serving CLI is :mod:`repro_torch.serving.cli`
(the launcher rides on the :class:`~repro_torch.serving.runtime.
ServingRuntime`: dynamic batching, worker pool, hot-swap; ``--arch``
generates tokens).

The port's copy of ``repro/launch/serve.py``: it warns once on import and
delegates everything — ``python -m repro_torch.launch.serve`` keeps
working, as do :class:`InputError` / :func:`load_input_env` /
:func:`main`.
"""

from __future__ import annotations

import warnings

warnings.warn(
    "repro_torch.launch.serve is deprecated: use repro_torch.serving.cli "
    "(python -m repro_torch.serving.cli) instead",
    DeprecationWarning, stacklevel=2)

from repro_torch.serving.cli import (InputError, load_input_env,  # noqa: E402
                                     main, serve_artifact, serve_lm)

__all__ = ["InputError", "load_input_env", "main", "serve_artifact",
           "serve_lm"]


if __name__ == "__main__":
    raise SystemExit(main())
