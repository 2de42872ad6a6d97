"""Deprecated alias — the training CLI is :mod:`repro_torch.training.cli`
(the launcher also drives the graph-level-autodiff
:class:`~repro_torch.api.CompiledTrainStep` via ``--compiled``).

The port's copy of ``repro/launch/train.py``: it warns once on import and
delegates everything — ``python -m repro_torch.launch.train`` keeps
working, as does the documented :func:`main` entry point.
"""

from __future__ import annotations

import warnings

warnings.warn(
    "repro_torch.launch.train is deprecated: use repro_torch.training.cli "
    "(python -m repro_torch.training.cli) instead",
    DeprecationWarning, stacklevel=2)

from repro_torch.training.cli import main  # noqa: E402

__all__ = ["main"]


if __name__ == "__main__":
    raise SystemExit(main())
