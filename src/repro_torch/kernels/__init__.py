"""Hand-written Hopper kernels for the compute hot-spots CODO routes.

Each subpackage keeps the reference's layout: a kernel module (the CUDA
wrapper plus its plain PyTorch version), an ``ops`` wrapper, a ``ref``
oracle, and the routing registration (all but ``matmul``, which no
pattern reaches, as in the reference).  The CUDA sources live in
``repro_torch/csrc`` and build at first use (:mod:`.common`).

* ``flashattn``  — streaming online-softmax attention (GQA/causal/SWA)
* ``matmul``     — blocked matmul, the accumulator written once (Fig. 5)
* ``streamfuse`` — the fused ``pad → conv → relu`` streaming kernel
  (conv), ``ew(a @ w1) @ w2`` matmul chains (mmchain), the
  ``softmax(s) @ v`` attention tail (softmaxmm) and the backward
  ``ew(a @ w, *residuals)`` gradient epilogues (mmgrad)
* ``rglru``      — RG-LRU linear recurrence (chunked time scan)
* ``ssd``        — Mamba-2 SSD inter-chunk state scan
"""

from . import flashattn, matmul, rglru, ssd, streamfuse


def register_all() -> None:
    """Hook the kernels into the CODO routing registry, in the reference's
    order: streamfuse, then flashattn, then rglru and ssd.  Order matters
    only for patterns sharing an anchor op: ``flashattn.mha`` anchors at
    the score matmul, which precedes the softmax in topo order, so it
    claims the whole attention chain before ``streamfuse.softmaxmm`` can
    anchor at the tail."""
    streamfuse.register()
    flashattn.register()
    rglru.register()
    ssd.register()


def libraries() -> list:
    """Every CUDA library of the port, one a ``csrc/*.cu`` source (build
    them together with :func:`.common.build_all`)."""
    return [flashattn.LIBRARY, streamfuse.LIBRARY, streamfuse.GRAD_LIBRARY,
            streamfuse.CONV_LIBRARY, streamfuse.SOFTMAX_LIBRARY,
            rglru.LIBRARY, ssd.LIBRARY, matmul.LIBRARY]
