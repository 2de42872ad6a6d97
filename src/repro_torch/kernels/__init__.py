"""Hand-written Hopper kernels for the compute hot-spots CODO routes.

Each subpackage keeps the reference's layout: a kernel module (the CUDA
wrapper plus its plain PyTorch version), an ``ops`` wrapper, a ``ref``
oracle, and the routing registration.  The CUDA sources live in
``repro_torch/csrc`` and build at first use (:mod:`.common`).

* ``flashattn``  — streaming online-softmax attention (GQA/causal/SWA)
* ``streamfuse`` — the fused ``pad → conv → relu`` streaming kernel
  (conv), ``ew(a @ w1) @ w2`` matmul chains and the backward
  ``ew(a @ w, *residuals)`` gradient epilogues (mmchain, mmgrad)
"""

from . import flashattn, streamfuse


def register_all() -> None:
    """Hook the kernels into the CODO routing registry, in the reference's
    order: streamfuse first, then flashattn.  ``flashattn.mha`` anchors at
    the score matmul and claims its whole chain by longest-match-first."""
    streamfuse.register()
    flashattn.register()
