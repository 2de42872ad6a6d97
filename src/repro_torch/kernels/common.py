"""Shared helpers of the port's kernel families: where a call runs, whether
a kernel's tiling exists, and how a CUDA source becomes a loaded library.

Where a call runs follows from its operands alone: tensors on a CUDA
device launch the hand-written kernel, tensors on the CPU run the kernel's
plain PyTorch version (the same function written with torch ops, kept in
the kernel's module).  A CUDA call never falls back: it launches or
raises.  Tensors on the ``meta`` device (a step costed without running,
:mod:`repro_torch.launch.dryrun`) get a meta result of the kernel's shape
and type, and the kernel's work is charged to the active cost walker
(:func:`meta_result`); nothing is computed, the plain version least of
all.

Kernels are CUDA C++ for ``sm_90a`` with a plain C interface, compiled
with ``nvcc`` at first use into ``build/kernels/`` at the repository root
and loaded with :mod:`ctypes`.  The library file name carries a hash of
the sources and flags, so a stale build is never loaded.  Every C entry
point launches exactly one kernel on the stream it is given and returns
``cudaGetLastError()``; :meth:`CudaLibrary.launch` raises on a non-zero
code and counts the launch.  A launch made while the calling thread
captures a CUDA graph (:mod:`repro_torch.core.capture`) only enqueues the
kernel into the graph: it goes to the capture's record instead, and each
replay of the graph counts it (:func:`recording_launches`).  So does a
launch that another thread makes into the capturing stream: the autograd
engine runs a CUDA backward on a thread of its own.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Sequence

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Shared memory one Hopper block may use (dynamic, after opting in with
# cudaFuncSetAttribute): 227 KB of the SM's 256 KB; 228 KB for all the
# blocks of one SM (each also reserves 1 KB); streaming multiprocessors of
# an H100.
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
NUM_SMS = 132

# Launches the calling thread records into a CUDA graph it is capturing:
# ``_RECORDING.record`` is a Counter of (library, entry point) while a
# capture runs on this thread, else absent.
_RECORDING = threading.local()
# The same record keyed by the capturing stream's handle, for launches
# that other threads enqueue into that stream (a captured backward).
_CAPTURING: dict[int, Counter] = {}

# ctypes shorthands for C entry-point signatures.
PTR, INT, INT64, FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)


class _Meta:
    """:func:`on_card`'s outcome for operands on the meta device.  It is
    true, so a wrapper that does not test for it goes the card's way and
    fails there: it never runs the plain version."""

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:
        return "META"


META = _Meta()


def on_card(*tensors):
    """True when every operand lies on one CUDA device (launch the
    kernel), False when every operand lies on the CPU (run the plain
    version), :data:`META` when every operand lies on the meta device
    (return :func:`meta_result`).  Anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        (device,) = devices
        if device.type == "cuda":
            return True
        if device.type == "cpu":
            return False
        if device.type == "meta":
            return META
    raise ValueError(f"kernel operands must all lie on one CUDA device or "
                     f"all on the CPU, got {sorted(map(str, devices))}")


def meta_result(shape, dtype, operands, *, flops: float,
                transcendentals: float = 0.0):
    """A kernel's result on the meta device: an empty meta tensor of
    ``shape`` and ``dtype``, the kernel's work — its ``operands`` read and
    its result written once, ``flops`` — charged to the active cost
    walker (:func:`repro_torch.launch.hlo_analysis.active`), if any."""
    import torch

    from ..launch import hlo_analysis
    out = torch.empty(shape, dtype=dtype, device="meta")
    walker = hlo_analysis.active()
    if walker is not None:
        nbytes = sum(hlo_analysis.tensor_bytes(t) for t in (*operands, out))
        walker.kernel(flops=flops, nbytes=nbytes,
                      transcendentals=transcendentals)
    return out


def smem_ok(nbytes: int) -> bool:
    """Whether a block needing ``nbytes`` of shared memory can launch: the
    check that a kernel's tiling exists for a shape."""
    return nbytes <= SMEM_PER_BLOCK


def all_f32(graph, *bufs) -> bool:
    return all(np.dtype(graph.buffers[b].dtype) == np.float32 for b in bufs)


def dtype_code(t) -> int:
    """The C entry points' element-type switch for a tensor or a dtype: 0
    float32, 1 bfloat16."""
    import torch
    dtype = getattr(t, "dtype", t)
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                       "CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


class CudaLibrary:
    """One CUDA source under ``csrc/`` built into a shared library.

    ``functions`` maps each exported C entry point to its ctypes argument
    types; every entry point returns an ``int`` CUDA error code.
    ``launches`` counts successful :meth:`launch` calls, and
    ``entry_launches`` the same by entry point (a kernel apart from its
    helper passes); :meth:`reset_counts` zeroes both."""

    def __init__(self, source: str, functions: dict[str, Sequence]):
        self.source = CSRC / source
        self.functions = dict(functions)
        self.launches = 0
        self.entry_launches: Counter[str] = Counter()
        self.build_log = ""
        self._lib = None

    @property
    def path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in [self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(src.name.encode() + b"\0" + src.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> tuple[subprocess.Popen, Path] | None:
        """Start ``nvcc`` unless the library is already built; pair with
        :meth:`finish_build`.  Separate halves so several sources build in
        parallel (:func:`build_all`)."""
        path = self.path
        if path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, self.path)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.path))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.codo_cuda_error_string.argtypes = [ctypes.c_int]
            lib.codo_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, name: str, *args) -> None:
        """Call entry point ``name`` (one kernel launch); raise if it
        returned a CUDA error, count it otherwise."""
        lib = self.load()
        code = getattr(lib, name)(*args)
        if code != 0:
            msg = lib.codo_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.source.name}:{name} failed to launch: "
                               f"CUDA error {code} ({msg})")
        record = getattr(_RECORDING, "record", None)
        if record is None and _CAPTURING:
            import torch
            record = _CAPTURING.get(torch.cuda.current_stream().cuda_stream)
        if record is not None:
            record[(self, name)] += 1
        else:
            self.count(name)

    def count(self, name: str, n: int = 1) -> None:
        """Count ``n`` executed launches of entry point ``name``."""
        self.launches += n
        self.entry_launches[name] += n

    def reset_counts(self) -> None:
        self.launches = 0
        self.entry_launches.clear()


@contextlib.contextmanager
def recording_launches(record: Counter, stream: int | None = None):
    """Within this context the calling thread's launches are recorded into
    ``record`` (a Counter of (library, entry point)) instead of counted:
    the thread is capturing a CUDA graph, so the kernels are enqueued, not
    run.  With ``stream`` (the capturing stream's handle) so are the
    launches any other thread makes while that stream is its current one.
    Each replay of the graph then counts them (:meth:`CudaLibrary.count`)."""
    _RECORDING.record = record
    if stream is not None:
        _CAPTURING[stream] = record
    try:
        yield record
    finally:
        del _RECORDING.record
        if stream is not None:
            _CAPTURING.pop(stream, None)


def build_all(libraries: Sequence[CudaLibrary]) -> float:
    """Build every library not yet built, one ``nvcc`` each, all started
    together; returns the wall seconds."""
    t0 = time.perf_counter()
    started = [(lib, lib.start_build()) for lib in libraries]
    try:
        for lib, s in started:
            lib.finish_build(s)
    finally:                      # a failed build leaves no nvcc running
        for _lib, s in started:
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
    for lib in libraries:
        lib.load()
    return time.perf_counter() - t0
