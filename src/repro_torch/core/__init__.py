"""repro_torch.core — the CODO dataflow compiler, PyTorch port.

The passes, cost model, cache and routing are the reference's
framework-free code; the op bodies and the lowering run on torch tensors.

    from repro_torch.core import (DataflowGraph, codo_opt, CodoOptions,
                                  lower, graph_latency)
"""

from .cache import CacheStats, CompileCache
from .compiler import CodoOptions, CompiledDataflow, codo_opt
from .costmodel import H100, V5E, HwParams, graph_latency, routing_backend
from .frontend import GB, ShapedBuffer, TraceError, trace, trace_io, weight_init
from .graph import Buffer, DataflowGraph, Task
from .lowering import LoweredProgram, lower, verify_lowering, verify_routing
from .ops import OpSpec, UnknownOpError, materialize, op_impl, register_op
from .routing import XLA_FUSED, KernelPattern, route_plan

__all__ = [
    "Buffer", "CacheStats", "CodoOptions", "CompileCache", "CompiledDataflow",
    "DataflowGraph", "GB", "H100", "HwParams", "KernelPattern",
    "LoweredProgram", "OpSpec", "ShapedBuffer", "Task", "TraceError",
    "UnknownOpError", "V5E", "XLA_FUSED", "codo_opt", "graph_latency",
    "lower", "materialize", "op_impl", "register_op", "route_plan",
    "routing_backend", "trace", "trace_io", "verify_lowering",
    "verify_routing", "weight_init",
]
