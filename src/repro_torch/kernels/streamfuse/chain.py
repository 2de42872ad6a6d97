"""The streamfuse matmul kernels for Hopper and their plain versions.

The counterpart of ``repro/kernels/streamfuse/chain.py``:
``fused_matmul_chain``, ``fused_matmul_grad`` and ``fused_softmax_matmul``.

``fused_matmul_chain`` — ``ew(a @ w1) @ w2``: a (M, K), w1 (K, N1), w2
(N1, N2) of one element type (float32 or bfloat16), float32 accumulation,
output in a's type.  ``ew`` is data, not a closure: a sequence of
``(kind, attrs)`` pairs over the elementwise kinds in :data:`EW_CODES`,
applied in order — which is how it reaches the CUDA kernel (op codes plus
scalar attributes, a :class:`ChainTail` built once a route).  Tensors on
the card launch ``csrc/chain.cu`` in one of two forms, picked by
:func:`chain_form` from the shapes, two launches either way
(:func:`chain_launches`):

* up to 16 rows, a K-split GEMV: the first launch writes float32 split
  partials of ``a @ w1`` (splits × M × N1 floats, under 1 MB at VGG-16's
  head) to device memory — the one place the intermediate leaves the
  chip's shared memory — and the second sums them in a fixed order,
  applies the tail and multiplies by w2;
* otherwise clusters of up to 8 blocks sharing a chunk of h through
  distributed shared memory (h stays on chip), each chunk writing a
  float32 partial of the output, then their fixed-order sum.

``fused_matmul_grad`` — ``ew(a @ w, *extras)``, the backward pass's
cotangent matmul with its gradient epilogue: a (M, K), w (K, N), each
extra (M, N), one element type, float32 accumulation, output in a's type.
``ew`` is a sequence of ``(kind, attrs, extra index)`` over
:data:`GRAD_CODES` (the elementwise kinds plus ``relu_grad``,
``gelu_grad`` and ``softmax_grad``, whose residual operand is
``extras[index]``).  Every operand is read through its own strides, so
transposed and ``expand`` views go in as they are.  Tensors on the card
launch ``csrc/chain_grad.cu``: see :func:`fused_matmul_grad`.

``fused_softmax_matmul`` — ``softmax(s, -1) @ v``, the attention tail:
s (M, K), v (K, N), online softmax over key tiles, float32 accumulation,
output in s's type.  Tensors on the card launch ``csrc/softmax_mm.cu``:
see :func:`fused_softmax_matmul`.

Tensors on the CPU run the plain versions, :func:`matmul_chain_plain`,
:func:`matmul_grad_plain` and :func:`softmax_matmul_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

from ..common import (INT, INT64, META, NUM_SMS, PTR, SMEM_PER_BLOCK,
                      CudaLibrary, dtype_code, meta_result, on_card, stream_of)


# op code of each elementwise kind csrc/chain.cu replays, and the attrs
# that fill its two float slots.
EW_CODES = {"identity": (0, ()), "relu": (1, ()), "gelu": (2, ()),
            "scale": (3, ("s",)), "affine": (4, ("a", "b")),
            "divc": (5, ("c",)), "rdivc": (6, ("c",))}
_ATTR_DEFAULTS = {"a": 1.0, "b": 0.0}
MAX_EW = 8

# Tile constants of csrc/chain.cu.  Small-M form: a split GEMV, 8 warps a
# block, 8 lanes on each 128-byte row segment (32 float32 or 64 bfloat16
# columns a block) and 32 rows in flight; each split a whole number of
# 32-row steps, at least 64 rows and at most what 64 KB of a's slab holds
# (16384 floats over the rows the kernel is compiled for).  Large-M form:
# 64 × 64 tiles of h a block, clusters of up to 8 blocks sharing a chunk
# of 64·c columns of h.
SMALL_M = 16                      # rows the small-M form takes at most
_GV_WARPS, _GV_RG, _MIN_KPER, _SLAB = 8, 32, 64, 16384
_GV_TARGET = 2 * NUM_SMS         # small-M blocks: two a SM
_BM, _BN, _BK, _MAX_CLUSTER = 64, 64, 32, 8

# The entry points take the shape as an int array and the tail as an
# EwChain (a launch's host time grows with its argument count, and the VGG
# head's call is host-bound).
LIBRARY = CudaLibrary("chain.cu", {
    "codo_matmul_chain": [INT, PTR, PTR, PTR, PTR, PTR, PTR, PTR],
    "codo_matmul_chain_reduce": [INT, PTR, PTR, INT, INT64, PTR],
    "codo_matmul_chain_rows": [INT, PTR, PTR, PTR, PTR, PTR],
    "codo_matmul_chain_rows_out": [INT, PTR, PTR, PTR, PTR, INT, PTR, PTR],
})


class EwChain(ctypes.Structure):
    """csrc/chain.cu's EwChain: n op codes with two float attributes each."""
    _fields_ = [("n", ctypes.c_int), ("op", ctypes.c_int * MAX_EW),
                ("a", ctypes.c_float * MAX_EW), ("b", ctypes.c_float * MAX_EW)]


class ChainTail:
    """An ``ew`` tail as the chain kernel takes it: the stages and their
    :class:`EwChain`.  The mmchain factory builds one a route, so a call
    does not re-derive the codes."""

    def __init__(self, ew: Sequence[tuple[str, dict]]):
        ops, ea, eb = ew_codes(ew)
        self.ew = tuple(ew)
        self.struct = EwChain(len(ops), (ctypes.c_int * MAX_EW)(*ops),
                              (ctypes.c_float * MAX_EW)(*ea),
                              (ctypes.c_float * MAX_EW)(*eb))


def _rows_mr(M: int) -> int:
    """Rows the small-M kernels are compiled for: the least power of 2
    that holds M."""
    return 1 << max(0, M - 1).bit_length()


def row_columns(itemsize: int) -> int:
    """Output columns of one small-M block: 8 lanes of 16 bytes."""
    return 8 * (16 // itemsize)


def row_splits(M: int, K: int, N1: int,
               itemsize: int = 4) -> tuple[int, int]:
    """(splits, rows of each) of the small-M form's contraction: enough
    splits that the first launch reaches two blocks a SM, each a whole
    number of 32-row steps, at least 64 rows and within the slab."""
    tiles = -(-N1 // row_columns(itemsize))
    depth = -(-K // max(1, -(-_GV_TARGET // tiles)))
    kper = min(max(_GV_RG * -(-depth // _GV_RG), _MIN_KPER),
               _SLAB // _rows_mr(M))
    return -(-K // kper), kper


def rows_smem_bytes(M: int, K: int, N1: int,
                    itemsize: int = 4) -> tuple[int, int]:
    """Shared memory of the small-M form's two kernels: the a slab (or h)
    as float32 and the warps' sums for the fixed-order reduction."""
    mr, red = _rows_mr(M), _GV_WARPS * _rows_mr(M) * row_columns(itemsize)
    kper = row_splits(M, K, N1, itemsize)[1]
    return 4 * (mr * kper + red), 4 * (mr * N1 + red)


def cluster_smem_bytes() -> int:
    """Shared memory of one large-M block: its 64 × 64 slice of h and two
    buffers each of the a and weight tiles (float32 sizes)."""
    return 4 * (_BM * (_BN + 4) + 2 * _BM * (_BK + 4) + 2 * _BK * (_BN + 8))


def chain_form(M: int, K: int, N1: int, itemsize: int = 4) -> str:
    """``"rows"`` (the small-M split GEMV) for M up to 16 when h's rows fit
    a block's shared memory, else ``"cluster"`` (the large-M form): a pure
    function of the shapes."""
    if M <= SMALL_M and max(rows_smem_bytes(M, K, N1, itemsize)) <= \
            SMEM_PER_BLOCK:
        return "rows"
    return "cluster"


def cluster_shape(N1: int, N2: int) -> tuple[int, int]:
    """(c, ncr): c blocks a cluster, 64 columns of h each (a chunk of 64·c
    columns), and the output columns each block computes, a multiple of
    64."""
    c = min(_MAX_CLUSTER, -(-N1 // _BN))
    cols = -(-N2 // c)
    return c, _BN * -(-cols // _BN)


def cluster_chunks(N1: int, N2: int) -> int:
    """Chunks of h (float32 partials the second launch sums)."""
    return -(-N1 // (_BN * cluster_shape(N1, N2)[0]))


def chain_launches(M: int, K: int, N1: int, N2: int) -> int:
    """Kernel launches of one :func:`fused_matmul_chain` call: two in
    either form (the split GEMV, then its sum times w2; or the cluster
    kernel, then its chunks' sum)."""
    return 2


def ew_codes(ew: Sequence[tuple[str, dict]]) -> tuple[list[int], list[float],
                                                       list[float]]:
    """(op codes, first attrs, second attrs) of an ``ew`` tail."""
    if len(ew) > MAX_EW:
        raise ValueError(f"the chain kernel replays at most {MAX_EW} "
                         f"elementwise ops, got {len(ew)}")
    ops, a, b = [], [], []
    for kind, attrs in ew:
        if kind not in EW_CODES:
            raise ValueError(f"elementwise kind {kind!r} is not one the chain "
                             f"kernel replays ({sorted(EW_CODES)})")
        code, names = EW_CODES[kind]
        vals = [float(attrs.get(n, _ATTR_DEFAULTS.get(n))) for n in names]
        vals += [0.0] * (2 - len(vals))
        ops.append(code)
        a.append(vals[0])
        b.append(vals[1])
    return ops, a, b


def apply_ew_plain(h, ew: Sequence[tuple[str, dict]]):
    """The tail in plain PyTorch ops, mirroring the op registry's bodies."""
    import torch
    for kind, attrs in ew:
        if kind == "relu":
            h = torch.relu(h)
        elif kind == "gelu":
            h = torch.nn.functional.gelu(h, approximate="tanh")
        elif kind == "scale":
            h = h * float(attrs["s"])
        elif kind == "affine":
            a, b = float(attrs.get("a", 1.0)), float(attrs.get("b", 0.0))
            h = (h if a == 1.0 else (-h if a == -1.0 else a * h)) + b
        elif kind == "divc":
            h = h / float(attrs["c"])
        elif kind == "rdivc":
            h = float(attrs["c"]) / h
        elif kind != "identity":
            raise ValueError(f"unknown elementwise kind {kind!r}")
    return h


def _check(a, w1, w2):
    _check_shapes(a.shape, w1.shape, w2.shape, a.dtype, w1.dtype, w2.dtype)


def _check_shapes(a_shape, w1_shape, w2_shape, a_dtype, w1_dtype, w2_dtype):
    import torch
    if len(a_shape) != 2 or len(w1_shape) != 2 or len(w2_shape) != 2:
        raise ValueError("fused_matmul_chain wants 2-D a, w1, w2")
    if a_shape[1] != w1_shape[0] or w1_shape[1] != w2_shape[0]:
        raise ValueError(f"shapes do not chain: {tuple(a_shape)} @ "
                         f"{tuple(w1_shape)} @ {tuple(w2_shape)}")
    if not (a_dtype == w1_dtype == w2_dtype) or a_dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"a/w1/w2 must share float32 or bfloat16, got "
                        f"{a_dtype}, {w1_dtype}, {w2_dtype}")


def fused_matmul_chain(a, w1, w2, *,
                       ew: "Sequence[tuple[str, dict]] | ChainTail" = ()):
    """``ew(a @ w1) @ w2`` (tensors on the card), or its plain version (on
    the CPU).  ``ew`` is the stages, or a :class:`ChainTail` built from
    them once.

    On the card, two launches in the form :func:`chain_form` picks: for M
    up to 16 a K-split GEMV writing float32 partials of ``a @ w1``, then
    their fixed-order sum with the tail and the product with w2; else the
    cluster kernel (mma.sync, 3×TF32 in float32) writing a float32 partial
    a chunk of h, then their fixed-order sum.  Deterministic; no
    atomics."""
    import torch
    where = on_card(a, w1, w2)
    stages = ew.ew if isinstance(ew, ChainTail) else ew
    if where is META:
        _check_shapes(a.shape, w1.shape, w2.shape, a.dtype, w1.dtype,
                      w2.dtype)
        (M, K), (N1, N2) = a.shape, w2.shape
        gelus = sum(kind == "gelu" for kind, *_ in stages)
        return meta_result((M, N2), a.dtype, (a, w1, w2),
                           flops=2.0 * M * N1 * (K + N2),
                           transcendentals=float(gelus * M * N1))
    if not where:
        return matmul_chain_plain(a, w1, w2, ew=stages)
    tail = ew if isinstance(ew, ChainTail) else ChainTail(ew)
    rows, scratch, shape, parts, code = _chain_plan(
        a.shape, w1.shape, w2.shape, a.dtype, w1.dtype, w2.dtype)
    if not (a.is_contiguous() and w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError("fused_matmul_chain reads row-major a/w1/w2; got "
                         f"strides {a.stride()}, {w1.stride()}, {w2.stride()}")
    M, N2 = a.shape[0], w2.shape[1]
    out = torch.empty((M, N2), dtype=a.dtype, device=a.device)
    # The scratch stays referenced until both launches are issued, so no
    # allocation between them (a captured graph's pool) takes its block.
    scratch_t = torch.empty(scratch, dtype=torch.float32, device=a.device)
    part = scratch_t.data_ptr()
    ew_arg, stream = ctypes.byref(tail.struct), stream_of(a)
    with torch.cuda.device(a.device):
        if rows:
            LIBRARY.launch("codo_matmul_chain_rows", code, a.data_ptr(),
                           w1.data_ptr(), part, shape, stream)
            LIBRARY.launch("codo_matmul_chain_rows_out", code, part,
                           w2.data_ptr(), out.data_ptr(), shape, N2, ew_arg,
                           stream)
        else:
            LIBRARY.launch("codo_matmul_chain", code, a.data_ptr(),
                           w1.data_ptr(), w2.data_ptr(), part, shape, ew_arg,
                           stream)
            LIBRARY.launch("codo_matmul_chain_reduce", code, part,
                           out.data_ptr(), parts, M * N2, stream)
    return out


@functools.lru_cache(maxsize=1024)
def _chain_plan(a_shape, w1_shape, w2_shape, a_dtype, w1_dtype,
                w2_dtype) -> tuple:
    """Everything a call on the card derives from its operands' shapes and
    types, once for each: (small-M form?, float32 scratch elements, the
    shape array the entry points read, partials summed, the element-type
    code).  The shape array is {M, K, N1, kper, splits} for the split
    GEMV, {M, K, N1, N2, c, ncr} for the cluster kernel (with its chunks).
    Raises on operands the kernel does not take."""
    _check_shapes(a_shape, w1_shape, w2_shape, a_dtype, w1_dtype, w2_dtype)
    (M, K), (N1, N2) = a_shape, w2_shape
    itemsize = 4 if dtype_code(a_dtype) == 0 else 2
    if chain_form(M, K, N1, itemsize) == "rows":
        splits, kper = row_splits(M, K, N1, itemsize)
        rows, scratch, parts = True, splits * M * N1, splits
        shape = (M, K, N1, kper, splits)
    else:
        rows, parts = False, cluster_chunks(N1, N2)
        scratch = parts * M * N2
        shape = (M, K, N1, N2, *cluster_shape(N1, N2))
    return (rows, scratch, (ctypes.c_int * len(shape))(*shape), parts,
            dtype_code(a_dtype))


def matmul_chain_plain(a, w1, w2, *, ew: Sequence[tuple[str, dict]] = ()):
    """The kernel's function in plain PyTorch ops, float32 throughout."""
    _check(a, w1, w2)
    h = apply_ew_plain(a.float() @ w1.float(), ew)
    return (h @ w2.float()).to(a.dtype)


# --------------------------------------------------------------------------
# matmul -> *ewise gradient epilogue (backward-pass chains)
# --------------------------------------------------------------------------

# The gradient kinds csrc/chain_grad.cu replays beside EW_CODES: each takes
# the chain value and one residual operand.
GRAD_KINDS = ("relu_grad", "gelu_grad", "softmax_grad")
GRAD_CODES = {**EW_CODES, "relu_grad": (7, ()), "gelu_grad": (8, ()),
              "softmax_grad": (9, ())}
_SOFTMAX_GRAD = GRAD_CODES["softmax_grad"][0]
# One stage of a gradient tail: (kind, attrs, index of its extra or None).
GradStage = tuple[str, dict, "int | None"]

# Tile constants of csrc/chain_grad.cu (csrc/mma_gemm.cuh): a (GRAD_BM x
# GRAD_BN) output tile a block of 8 warps on the tensor cores, two blocks
# resident on a SM, the contraction in 32-deep stages, and the least depth
# a K split gets.
GRAD_BM, GRAD_BN = 128, 128
_GRAD_STAGE = 32
_MIN_K_SPLIT = 64
# The split choice's cost model (float32, NVIDIA H100 80GB HBM3, fitted to
# chip_smoke.py's route shapes): a block costs _GRAD_BLOCK_US besides its
# k steps; one block alone on a SM advances one k in _GRAD_K_US[0] µs, two
# co-resident blocks one k each in _GRAD_K_US[1]; split partial sums cost
# a write and a read each at 3.35 TB/s.
_GRAD_BLOCK_US = 8.0
_GRAD_K_US = (0.10, 0.18)
_BYTES_PER_US = 3.35e6


def tile_splits(M: int, N: int, K: int, *, tile: tuple[int, int],
                stage: int, cost) -> tuple[int, int]:
    """(splits, depth of each) of a tiled product's contraction, each
    depth a whole number of ``stage``-deep stages and at least 64 when
    split.  Few output tiles leave most of the card idle, and a tile count
    just past a whole number of waves leaves the last wave short: the
    choice minimises ``cost(blocks, depth)`` (µs) plus the traffic of the
    split partial sums."""
    tiles = -(-M // tile[0]) * -(-N // tile[1])
    best = None
    for want in range(1, max(1, K // _MIN_K_SPLIT) + 1):
        depth = -(-K // want)
        per = stage * -(-depth // stage)
        splits = -(-K // per)
        total = cost(tiles * splits, per)
        if splits > 1:
            total += 8.0 * splits * M * N / _BYTES_PER_US
        if best is None or total < best[0]:
            best = (total, splits, per)
    return best[1], best[2]


def _grad_cost(blocks: int, per: int) -> float:
    """µs of the grad kernel's product: the busiest SM's blocks, two at a
    time, each costing a fixed part and its k steps."""
    pairs, single = divmod(-(-blocks // NUM_SMS), 2)
    return ((pairs + single) * _GRAD_BLOCK_US
            + per * (pairs * _GRAD_K_US[1] + single * _GRAD_K_US[0]))


GRAD_LIBRARY = CudaLibrary("chain_grad.cu", {
    "codo_matmul_grad": [INT, PTR, INT64, INT64, PTR, INT64, INT64, PTR,
                         INT, INT, INT, INT, INT, INT, INT, INT, PTR, PTR,
                         PTR, PTR, INT, PTR, PTR, PTR, PTR],
    "codo_matmul_grad_rows": [INT, PTR, INT, PTR, INT, INT, INT, INT, PTR,
                              PTR, PTR, PTR, INT, PTR, PTR, PTR, PTR],
})


def grad_ew_codes(ew, n_extras: int):
    """(op codes, first attrs, second attrs, extra indices) of a gradient
    tail; the extra index is -1 for a stage that reads none."""
    if len(ew) > MAX_EW or n_extras > MAX_EW:
        raise ValueError(f"the grad kernel replays at most {MAX_EW} "
                         f"elementwise ops and extras, got {len(ew)} and "
                         f"{n_extras}")
    ops, a, b, ex = [], [], [], []
    for kind, attrs, idx in ew:
        if kind in GRAD_KINDS:
            if idx is None or not 0 <= idx < n_extras:
                raise ValueError(f"{kind} reads one residual operand: extra "
                                 f"index {idx!r} of {n_extras} extras")
            ops.append(GRAD_CODES[kind][0])
            a.append(0.0)
            b.append(0.0)
            ex.append(int(idx))
            continue
        if idx is not None:
            raise ValueError(f"{kind} reads no residual operand, got extra "
                             f"index {idx!r}")
        (op,), (va,), (vb,) = ew_codes([(kind, attrs)])
        ops.append(op)
        a.append(va)
        b.append(vb)
        ex.append(-1)
    return ops, a, b, ex


@functools.lru_cache(maxsize=256)
def k_splits(M: int, N: int, K: int) -> tuple[int, int]:
    """(splits, depth of each) of :func:`fused_matmul_grad`'s contraction
    (:func:`tile_splits` for its tile): the FFN chain at S=128 has 32
    output tiles for the card's 132 SMs."""
    return tile_splits(M, N, K, tile=(GRAD_BM, GRAD_BN), stage=_GRAD_STAGE,
                       cost=_grad_cost)


def grad_one_pass(M: int, N: int, K: int, ew) -> bool:
    """Whether a :func:`fused_matmul_grad` call is the tiled product
    alone: the contraction is not split and no ``softmax_grad`` follows.
    Otherwise the row pass follows it."""
    return (k_splits(M, N, K)[0] == 1
            and all(kind != "softmax_grad" for kind, _, _ in ew))


def grad_launches(M: int, N: int, K: int, ew) -> int:
    """Kernel launches of one :func:`fused_matmul_grad` call."""
    return 1 if grad_one_pass(M, N, K, ew) else 2


def _check_grad(a, w, extras):
    import torch
    if a.dim() != 2 or w.dim() != 2 or any(e.dim() != 2 for e in extras):
        raise ValueError("fused_matmul_grad wants 2-D a, w and extras")
    if a.shape[1] != w.shape[0]:
        raise ValueError(f"shapes do not chain: {tuple(a.shape)} @ "
                         f"{tuple(w.shape)}")
    mn = (a.shape[0], w.shape[1])
    if any(tuple(e.shape) != mn for e in extras):
        raise ValueError(f"extras must be {mn}, got "
                         f"{[tuple(e.shape) for e in extras]}")
    dtypes = {a.dtype, w.dtype, *(e.dtype for e in extras)}
    if len(dtypes) != 1 or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a/w/extras must share float32 or bfloat16, got "
                        f"{sorted(map(str, dtypes))}")


def _c_array(ctype, values):
    return (ctype * max(len(values), 1))(*values)


class GradTail:
    """A gradient tail as the kernel takes it: the stages' op codes and
    attributes as C arrays, and the first ``softmax_grad`` (where the row
    pass takes over).  The mmgrad factory builds one a route, so a call
    does not re-derive them; the extras' stride arrays are kept by their
    strides, which a route's operands repeat."""

    def __init__(self, ew: Sequence[GradStage], n_extras: int):
        ops, ea, eb, ex = grad_ew_codes(ew, n_extras)
        self.ew = tuple(ew)
        self.n_extras = n_extras
        self.first_sg = (ops.index(_SOFTMAX_GRAD) if _SOFTMAX_GRAD in ops
                         else len(ops))
        self.n_ops = len(ops)
        self.codes = (len(ops), _c_array(ctypes.c_int, ops),
                      _c_array(ctypes.c_float, ea),
                      _c_array(ctypes.c_float, eb),
                      _c_array(ctypes.c_int, ex), n_extras)
        self._strides: dict = {}

    def args(self, extras) -> tuple:
        """The tail's arguments of both C entry points for these extras."""
        key = tuple(e.stride() for e in extras)
        strides = self._strides.get(key)
        if strides is None:
            strides = self._strides[key] = (
                _c_array(ctypes.c_longlong, [s[0] for s in key]),
                _c_array(ctypes.c_longlong, [s[1] for s in key]))
        ptrs = _c_array(ctypes.c_void_p, [e.data_ptr() for e in extras])
        return (*self.codes, ptrs, *strides)


def fused_matmul_grad(a, w, *extras, ew: "Sequence[GradStage] | GradTail"):
    """``ew(a @ w, *extras)`` (tensors on the card), or its plain version
    (on the CPU).  ``ew`` is the stages, or a :class:`GradTail` built from
    them once.

    On the card: the tensor-core tile product (mma.sync, 3×TF32 in
    float32) over an (N/128, M/128, splits) grid, the tail's leading
    elementwise stages applied in the epilogue.  A ``softmax_grad`` needs
    its row's whole dot, and a split contraction its partial sums: then
    the first launch writes float32 values and a second, one block a row
    (or a row's 1024 columns where no ``softmax_grad`` follows), sums the
    splits in order, takes each ``softmax_grad``'s row dot as a
    fixed-order block reduction and applies the rest of the tail.
    Deterministic; no atomics."""
    import torch
    _check_grad(a, w, extras)
    tail = ew if isinstance(ew, GradTail) else GradTail(ew, len(extras))
    if tail.n_extras != len(extras):
        raise ValueError(f"the tail was built for {tail.n_extras} extras, "
                         f"got {len(extras)}")
    where = on_card(a, w, *extras)
    if where is META:
        return meta_result((a.shape[0], w.shape[1]), a.dtype, (a, w, *extras),
                           flops=2.0 * a.shape[0] * a.shape[1] * w.shape[1])
    if not where:
        return matmul_grad_plain(a, w, *extras, ew=tail.ew)
    M, K = a.shape
    N = w.shape[1]
    splits, per = k_splits(M, N, K)
    one_pass = grad_one_pass(M, N, K, tail.ew)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if one_pass:
        dst, n_apply = out, tail.n_ops
    else:
        dst = torch.empty((splits, M, N), dtype=torch.float32,
                          device=a.device)
        n_apply = tail.first_sg if splits == 1 else 0
    args = tail.args(extras)
    code, stream = dtype_code(a), stream_of(a)
    with torch.cuda.device(a.device):
        GRAD_LIBRARY.launch("codo_matmul_grad", code, a.data_ptr(),
                            a.stride(0), a.stride(1), w.data_ptr(),
                            w.stride(0), w.stride(1), dst.data_ptr(),
                            int(one_pass), M, N, K, per, splits, n_apply,
                            *args, stream)
        if not one_pass:
            GRAD_LIBRARY.launch("codo_matmul_grad_rows", code,
                                dst.data_ptr(), splits, out.data_ptr(), M, N,
                                n_apply, *args, stream)
    return out


def apply_grad_ew_plain(h, ew, extras):
    """A gradient tail in plain PyTorch: the gradient kinds through the op
    registry's own bodies, the others through :func:`apply_ew_plain`."""
    from ...core.ops import OpSpec, op_impl
    for kind, attrs, idx in ew:
        if kind in GRAD_KINDS:
            spec = OpSpec(kind, ("h", "x"), ("y",), dict(attrs))
            h = op_impl(kind)(spec, {"h": h, "x": extras[idx]})["y"]
        else:
            h = apply_ew_plain(h, [(kind, attrs)])
    return h


def matmul_grad_plain(a, w, *extras, ew: Sequence[GradStage]):
    """The kernel's function in plain PyTorch ops, float32 throughout."""
    _check_grad(a, w, extras)
    grad_ew_codes(ew, len(extras))
    h = apply_grad_ew_plain(a.float() @ w.float(), ew,
                            [e.float() for e in extras])
    return h.to(a.dtype)


# --------------------------------------------------------------------------
# softmax -> matmul (online-softmax attention tail)
# --------------------------------------------------------------------------

# Tile constants of csrc/softmax_mm.cu: 64 rows a block (4 warps of 16),
# 64-key tiles of s and V, 64 or 128 output columns a block; three blocks
# a SM at 64 columns, two at 128 (registers: the accumulator and, where a
# block walks several key tiles, a tile's fresh fragment).
SM_BQ, SM_BK = 64, 64

SOFTMAX_LIBRARY = CudaLibrary("softmax_mm.cu", {
    "codo_softmax_matmul": [INT, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                            INT, INT, PTR],
    "codo_softmax_matmul_combine": [INT, PTR, PTR, PTR, INT, INT, INT, PTR],
})


def softmax_mm_columns(N: int) -> int:
    """Output columns a block owns: 64, or 128 above 64 (wider N is tiled
    over the grid, each column tile recomputing the same row
    statistics)."""
    return 64 if N <= 64 else 128


def softmax_mm_smem_bytes(N: int) -> int:
    """Shared memory of one block: two buffers, each a 64 × 64 tile of s
    and a 64-key tile of V, rows padded by 16 and 32 bytes (float32
    sizes)."""
    bn = softmax_mm_columns(N)
    return 2 * (SM_BQ * (4 * SM_BK + 16) + SM_BK * (4 * bn + 32))


def softmax_mm_splits(M: int, K: int, N: int) -> tuple[int, int]:
    """(splits, key tiles per split) of the contraction: as many splits as
    keep the grid within one wave of resident blocks, no more than there
    are tiles."""
    tiles = -(-K // SM_BK)
    blocks = -(-M // SM_BQ) * -(-N // softmax_mm_columns(N))
    slots = NUM_SMS * (3 if softmax_mm_columns(N) == 64 else 2)
    splits = min(tiles, max(1, slots // blocks))
    per = -(-tiles // splits)
    return -(-tiles // per), per


def softmax_mm_launches(M: int, K: int, N: int) -> int:
    """Kernel launches of one :func:`fused_softmax_matmul` call: the split
    pass alone, or with the combine when the keys split."""
    return 1 if softmax_mm_splits(M, K, N)[0] == 1 else 2


def _check_softmax_mm(s, v):
    import torch
    if s.dim() != 2 or v.dim() != 2 or s.shape[1] != v.shape[0]:
        raise ValueError(f"fused_softmax_matmul wants s (M, K) and v (K, N), "
                         f"got {tuple(s.shape)} and {tuple(v.shape)}")
    if s.dtype != v.dtype or s.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"s/v must share float32 or bfloat16, got {s.dtype}, "
                        f"{v.dtype}")


def fused_softmax_matmul(s, v):
    """``softmax(s, -1) @ v``: s (M, K), v (K, N), output in s's type.

    On the card: blocks of 64 rows × 64 or 128 output columns × one split
    of the key tiles, the online softmax (running max from −1e30, running
    denominator, float32 accumulator) on registers and P·V on the tensor
    cores (mma.sync, 3×TF32 in float32), each key tile's P·V folded into
    the accumulator by round-to-nearest FMAs where a block walks several
    key tiles.  With one split the
    block writes ``acc / max(l, 1e-30)`` (one launch), else each split
    writes its unnormalized accumulator with its max and denominator and a
    second kernel combines the splits in a fixed order.  Operands are read
    through their strides.  On the CPU: :func:`softmax_matmul_plain`."""
    import torch
    _check_softmax_mm(s, v)
    where = on_card(s, v)
    if where is META:                       # one exp a score
        return meta_result((s.shape[0], v.shape[1]), s.dtype, (s, v),
                           flops=2.0 * s.shape[0] * s.shape[1] * v.shape[1],
                           transcendentals=float(s.numel()))
    if not where:
        return softmax_matmul_plain(s, v)
    M, K = s.shape
    N = v.shape[1]
    splits, per = softmax_mm_splits(M, K, N)
    out = torch.empty((M, N), dtype=s.dtype, device=s.device)
    if splits > 1:
        part_o = torch.empty((splits, M, N), dtype=torch.float32,
                             device=s.device)
        part_ml = torch.empty((splits, M, 2), dtype=torch.float32,
                              device=s.device)
        dst, ml = part_o, part_ml.data_ptr()
    else:
        dst, ml = out, None
    strides = (ctypes.c_longlong * 4)(*s.stride(), *v.stride())
    code, stream = dtype_code(s), stream_of(s)
    with torch.cuda.device(s.device):
        SOFTMAX_LIBRARY.launch("codo_softmax_matmul", code, s.data_ptr(),
                               v.data_ptr(), strides, dst.data_ptr(), ml, M,
                               K, N, softmax_mm_columns(N), splits, per,
                               stream)
        if splits > 1:
            SOFTMAX_LIBRARY.launch("codo_softmax_matmul_combine", code,
                                   part_o.data_ptr(), part_ml.data_ptr(),
                                   out.data_ptr(), splits, M, N, stream)
    return out


def softmax_matmul_plain(s, v):
    """The kernel's function in plain PyTorch ops: whole-row softmax in
    float32 with the kernel's denominator guard."""
    _check_softmax_mm(s, v)
    sf = s.float()
    p = (sf - sf.amax(dim=-1, keepdim=True)).exp()
    o = (p @ v.float()) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.to(s.dtype)


__all__ = ["ChainTail", "EW_CODES", "GRAD_CODES", "GRAD_KINDS", "GRAD_LIBRARY",
           "GradTail", "LIBRARY", "SOFTMAX_LIBRARY", "apply_ew_plain",
           "apply_grad_ew_plain", "chain_form", "chain_launches",
           "cluster_chunks", "cluster_shape", "cluster_smem_bytes",
           "ew_codes", "fused_matmul_chain", "fused_matmul_grad",
           "fused_softmax_matmul", "grad_ew_codes", "grad_launches",
           "grad_one_pass", "k_splits", "matmul_chain_plain",
           "matmul_grad_plain", "row_columns", "row_splits",
           "rows_smem_bytes", "softmax_matmul_plain", "softmax_mm_columns",
           "softmax_mm_launches", "softmax_mm_smem_bytes",
           "softmax_mm_splits", "tile_splits"]
