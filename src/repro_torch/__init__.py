"""repro_torch — the PyTorch/CUDA port of the CODO reproduction.

Mirrors ``repro`` module for module (``repro_torch.core.graph`` is the
counterpart of ``repro.core.graph``, and so on); the hand-written Hopper
kernels live under ``repro_torch/csrc``.  ``import codo_torch`` is the
user-facing alias of :mod:`repro_torch.api`.
"""
