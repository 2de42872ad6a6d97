"""repro_torch.core — the CODO dataflow compiler, PyTorch port.

The passes, cost model, cache and routing are the reference's
framework-free code; the op bodies and the lowering run on torch tensors.
Re-exports the reference ``repro.core``'s public names, plus the port's
own (``H100``, ``routing_backend``, the captured step runner) and the
sharding slice's (``verify_sharding``, the pipeline executor).

    from repro_torch.core import (DataflowGraph, codo_opt, CodoOptions,
                                  lower, graph_latency, autoschedule)
"""

from .artifact import (SCHEMA_VERSION, ArtifactError, ArtifactWarning,
                       artifact_summary, artifact_weights, export_artifact,
                       import_artifact, validate_artifact)
from .buffers import BufferPlan, determine_buffers, downgrade_to_pingpong
from .cache import CacheStats, CompileCache
from .capture import CaptureError, CapturedProgram
from .coarse import eliminate_coarse
from .compiler import (BatchJob, BatchResult, CodoOptions, CompiledDataflow,
                       PassBudgetError, ablation_jobs, batch_workloads,
                       codo_opt, codo_opt_batch, default_cache,
                       default_manager, enforce_pass_budgets,
                       kernel_workloads, verify_violation_free)
from .costmodel import (H100, V5E, GraphCost, HwParams, graph_latency,
                        routing_backend, sequential_latency, task_cost)
from .fine import eliminate_fine
from .frontend import (GB, ShapedBuffer, TraceError, Tracer, trace, trace_io,
                       weight_init)
from .graph import (FIFO, PINGPONG, Access, Buffer, DataflowGraph, Loop, Task,
                    conv2d_task, copy_task, ewise_task, full_index, idx,
                    matmul_task, pad_task, pool_task, reduce_task, retarget_fn)
from .lowering import (LOWER_CACHE_STATS, FusionGroup, LoweredProgram,
                       clear_lower_cache, fusion_groups, lower,
                       lower_artifact, register_group_kernel,
                       verify_lowering, verify_routing, verify_sharding)
from .offchip import TransferPlan, host_manifest, plan_offchip
from .ops import (OpSpec, UnknownOpError, materialize, op_impl, register_op,
                  registered_ops)
from .passes import (ABLATION_PRESETS, DEFAULT_PASS_BUDGETS,
                     PASS_RUN_COUNTS, CompileDiagnostics, Pass, PassManager,
                     PassRecord, default_passes)
from .patterns import (access_sig, arrival_order, coarse_violations,
                       fine_violations, violation_report)
from .pipeline import PipelineSchedule, pipeline_fn, reference_serial
from .reuse import generate_reuse_buffers, parallel_safety
from .routing import (XLA_FUSED, KernelPattern, RoutedKernel,
                      pallas_disabled, register_kernel_pattern,
                      registered_patterns, route_plan)
from .schedule import assign_stages, autoschedule

__all__ = [
    "ABLATION_PRESETS", "Access", "ArtifactError", "ArtifactWarning",
    "BatchJob", "BatchResult", "Buffer", "BufferPlan", "CacheStats",
    "CaptureError", "CapturedProgram", "CodoOptions", "CompileCache",
    "CompileDiagnostics", "CompiledDataflow", "DEFAULT_PASS_BUDGETS",
    "DataflowGraph", "FIFO", "FusionGroup", "GB", "GraphCost", "H100",
    "HwParams", "KernelPattern", "LOWER_CACHE_STATS", "Loop",
    "LoweredProgram", "OpSpec", "PASS_RUN_COUNTS", "PINGPONG", "Pass",
    "PassBudgetError", "PassManager", "PassRecord", "PipelineSchedule",
    "RoutedKernel",
    "SCHEMA_VERSION", "ShapedBuffer", "Task", "TraceError", "Tracer",
    "TransferPlan", "UnknownOpError", "V5E", "XLA_FUSED", "ablation_jobs",
    "access_sig", "arrival_order", "artifact_summary", "artifact_weights",
    "assign_stages", "autoschedule", "batch_workloads", "clear_lower_cache",
    "coarse_violations", "codo_opt", "codo_opt_batch", "conv2d_task",
    "copy_task", "default_cache", "default_manager", "default_passes",
    "determine_buffers", "downgrade_to_pingpong", "eliminate_coarse",
    "eliminate_fine", "enforce_pass_budgets", "ewise_task",
    "export_artifact", "fine_violations", "full_index", "fusion_groups",
    "generate_reuse_buffers", "graph_latency", "host_manifest", "idx",
    "import_artifact", "kernel_workloads", "lower", "lower_artifact",
    "materialize", "matmul_task", "op_impl", "pad_task", "pallas_disabled",
    "parallel_safety", "pipeline_fn", "plan_offchip", "pool_task",
    "reduce_task", "reference_serial",
    "register_group_kernel", "register_kernel_pattern", "register_op",
    "registered_ops", "registered_patterns", "retarget_fn", "route_plan",
    "routing_backend", "sequential_latency", "task_cost", "trace",
    "trace_io", "validate_artifact", "verify_lowering", "verify_routing",
    "verify_sharding", "verify_violation_free", "violation_report",
    "weight_init",
]
