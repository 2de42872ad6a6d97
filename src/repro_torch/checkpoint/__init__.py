"""repro_torch.checkpoint — async, manifest-verified checkpoints in the
reference's layout (:mod:`~repro_torch.checkpoint.checkpointer`)."""

from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
