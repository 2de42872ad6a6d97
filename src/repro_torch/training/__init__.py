"""repro_torch.training — LM training for the PyTorch port.

* :mod:`~repro_torch.training.optimizer` — AdamW, the warmup-cosine
  schedule and global-norm clipping on trees of tensors (float32 moments);
* :mod:`~repro_torch.training.train_loop` — ``build_train_step``, the
  captured :class:`TrainStep`, the sharded step on a mesh
  (``jit_train_step``, :class:`ShardedTrainStep`,
  ``train_state_shardings``), the fault-tolerant ``train`` / ``resume``
  driver and its compiled twin ``train_compiled`` / ``resume_compiled``;
* :mod:`~repro_torch.training.cli` — ``python -m
  repro_torch.training.cli`` (``repro_torch.launch.train`` is its
  deprecated alias).
"""

from .optimizer import (OptConfig, adamw_init, adamw_update,
                        clip_by_global_norm, global_norm, lr_at)
from .train_loop import (Heartbeat, ShardedTrainStep, SimulatedFailure,
                         StepTimeMonitor, TrainReport, TrainStep,
                         build_train_step, jit_train_step, resume,
                         resume_compiled, train, train_compiled,
                         train_state_shardings)

__all__ = ["Heartbeat", "OptConfig", "ShardedTrainStep", "SimulatedFailure",
           "StepTimeMonitor", "TrainReport", "TrainStep", "adamw_init",
           "adamw_update", "build_train_step", "clip_by_global_norm",
           "global_norm", "jit_train_step", "lr_at", "resume",
           "resume_compiled", "train", "train_compiled",
           "train_state_shardings"]
