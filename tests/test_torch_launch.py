"""The port's cost walker, the kernel wrappers on meta tensors and the
dry-run, against the JAX reference, on the CPU.

* The walker (``repro_torch.launch.hlo_analysis``) counts the two scan
  programs of ``tests/test_distributed.py`` — an 8-trip ``tanh(h @ w)``
  and the nested 8 x 4 ``g @ w`` with its gradient — written as torch
  loops, against the reference's walker over the compiled HLO; bytes by a
  hand count; an all-gather of placed leaves by the ring formula.
* Every kernel wrapper on meta tensors returns a meta result of the
  kernel's shape and type and charges its operands and result once,
  without calling its plain version; CPU tensors still run the plain
  version, and mixed devices still raise.
* The dry-run (``repro_torch.launch.dryrun``) on a (2, 2) mesh of meta
  positions at ``smoke()`` widths: every record key the reference's
  ``dryrun.py`` writes (read from its source with ``ast``: importing it
  would force 512 host devices on this process), the reference's
  ``model_flops`` / ``params`` / ``active_params``, a position's argument
  bytes, and a prefill's FLOPs on a 1 x 1 mesh against the reference
  walker's count of the reference's jitted prefill.
"""

import ast
import importlib
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ShapeSpec as RefShape  # noqa: E402
from repro.launch import hlo_analysis as ref_ha  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed.sharding import (P, NamedSharding,  # noqa: E402
                                              batch_specs, param_specs,
                                              place)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as ha  # noqa: E402
from repro_torch.launch.perf import roofline_row  # noqa: E402
from repro_torch.models import batch_spec  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# --------------------------------------------------------------------------
# The walker against the reference's
# --------------------------------------------------------------------------


def _ref_cost(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return ref_ha.analyze(jax.jit(fn).lower(*args).compile().as_text())


def test_walker_counts_the_scan_trips_as_the_reference():
    def ref(w, x):
        def body(h, _):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, x, None, length=8)
        return jnp.sum(h)

    def port(w, x):
        h = x
        for _ in range(8):
            h = torch.tanh(h @ w)
        return h.sum()

    want = _ref_cost(ref, (128, 128), (32, 128))
    got = ha.analyze(port, meta(128, 128), meta(32, 128))
    assert abs(got.flops - want.flops) / want.flops < 0.01
    assert got.flops == 8 * 2 * 32 * 128 * 128
    assert got.transcendentals == want.transcendentals == 8 * 32 * 128


def test_walker_counts_nested_loops_and_the_gradient_as_the_reference():
    def ref(w, x):
        def outer(h, _):
            def inner(g, _):
                return g @ w, None
            g, _ = jax.lax.scan(inner, h, None, length=4)
            return g, None
        h, _ = jax.lax.scan(outer, x, None, length=8)
        return jnp.sum(h)

    def port(w, x):
        h = x
        for _ in range(8):
            for _ in range(4):
                h = h @ w
        return h.sum()

    def port_grad(w, x):
        w = w.detach().requires_grad_(True)
        return torch.autograd.grad(port(w, x), w)

    fwd = _ref_cost(ref, (64, 64), (16, 64))
    bwd = _ref_cost(jax.grad(ref), (64, 64), (16, 64))
    got = ha.analyze(port, meta(64, 64), meta(16, 64))
    got_bwd = ha.analyze(port_grad, meta(64, 64), meta(16, 64))
    assert abs(got.flops - fwd.flops) / fwd.flops < 0.01
    assert got_bwd.flops >= 2.5 * got.flops
    # Autograd does not differentiate the first product with respect to x,
    # which needs no gradient; the scan body computes it on every trip.
    # That one (16, 64) @ (64, 64) product is the whole difference (1.04 %).
    assert bwd.flops - got_bwd.flops == 2 * 16 * 64 * 64


def test_walker_charges_operands_and_result_of_each_op():
    a, w = meta(32, 64), meta(64, 16)
    out = meta(32, 16)

    def four_ops():
        y = a @ w
        z = torch.tanh(y)
        s = z * 2.0
        out[0:8].copy_(s[0:8])         # an in-place write into a slice

    cost = ha.analyze(four_ops)
    f = 4
    want = (f * (32 * 64 + 64 * 16 + 32 * 16)        # mm
            + 2 * f * 32 * 16                        # tanh
            + 2 * f * 32 * 16                        # mul by a scalar
            + 2 * f * 8 * 16)                        # copy_ into the slice
    assert cost.bytes == want
    assert cost.ops == 4
    assert cost.flops == 2 * 32 * 64 * 16


def test_walker_charges_an_expanded_operand_once():
    x, b = meta(64, 32), meta(32)
    cost = ha.analyze(lambda: x + b.expand(64, 32))
    assert cost.bytes == 4 * (64 * 32 + 32 + 64 * 32)


def test_gather_charges_the_ring_all_gather():
    mesh = dryrun.meta_mesh((2, 2), ("data", "model"))
    tree = {"w": meta(8, 4), "b": meta(8, 6)}
    specs = {"w": P("data", "model"), "b": P("data", None)}
    placed = place(tree, {k: NamedSharding(mesh, s) for k, s in specs.items()})
    with ha.CostWalker() as walker:
        from repro_torch.distributed.sharding import gather
        whole = gather(placed)
    assert tuple(whole["w"].shape) == (8, 4)
    got = walker.cost.collective
    # w over both axes: a group of 4; b over data: a group of 2
    assert got["all-gather"] == 3 / 4 * (8 * 4 * 4) + 1 / 2 * (8 * 6 * 4)
    assert got["count"] == 2
    assert walker.cost.bytes == 8 * 4 * 4 + 8 * 6 * 4     # results only
    assert ha.group_size(mesh, ("data",)) == 2
    assert ha.group_size(mesh, ("data", "model")) == 4


def test_collective_formulas_are_the_references():
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        for g in (2, 4, 16):
            assert ha._collective_moved(op, 1e6, g) == \
                ref_ha._collective_moved(op, 1e6, g)


# --------------------------------------------------------------------------
# Kernel wrappers on meta
# --------------------------------------------------------------------------

def _kernels():
    """(wrapper module, wrapper name, plain name, operands(device),
    result shape, FLOPs) of every kernel."""
    def ops(*shapes):
        return lambda device: [torch.rand(s, device=device) for s in shapes]

    gelu = (("gelu", {}),)
    return [
        ("flashattn.flashattn", "flash_attention", "flash_attention_plain",
         ops((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)), {},
         (1, 2, 8, 16), 4 * 2 * 8 * 8 * 16),
        ("streamfuse.chain", "fused_matmul_chain", "matmul_chain_plain",
         ops((8, 16), (16, 32), (32, 16)), {"ew": gelu}, (8, 16),
         2 * 8 * 32 * (16 + 16)),
        ("streamfuse.chain", "fused_matmul_grad", "matmul_grad_plain",
         ops((8, 16), (16, 32), (8, 32)),
         {"ew": (("gelu_grad", {}, 0),)}, (8, 32), 2 * 8 * 16 * 32),
        ("streamfuse.chain", "fused_softmax_matmul", "softmax_matmul_plain",
         ops((8, 16), (16, 4)), {}, (8, 4), 2 * 8 * 16 * 4),
        ("streamfuse.streamfuse", "fused_pad_conv_relu",
         "pad_conv_relu_plain", ops((2, 3, 8, 8), (4, 3, 3, 3)), {},
         (2, 4, 8, 8), 2 * 2 * 4 * 8 * 8 * 3 * 9),
        ("rglru.rglru", "rglru_scan", "rglru_scan_plain",
         ops((2, 8, 16), (2, 8, 16)), {}, (2, 8, 16), 2 * 2 * 8 * 16),
        ("ssd.ssd", "ssd_chunk_scan", "ssd_chunk_scan_plain",
         ops((3, 4, 2, 5), (3, 4, 1, 1)), {}, (3, 4, 2, 5), 2 * 3 * 4 * 2 * 5),
        ("matmul.matmul", "matmul", "matmul_plain", ops((8, 16), (16, 4)),
         {}, (8, 4), 2 * 8 * 16 * 4),
    ]


KERNELS = _kernels()


@pytest.mark.parametrize("case", KERNELS, ids=[k[1] for k in KERNELS])
def test_wrapper_on_meta_charges_the_kernel_and_never_runs_plain(
        case, monkeypatch):
    mod_name, fn_name, plain_name, operands, kw, shape, flops = case
    mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")

    def refuse(*a, **k):
        raise AssertionError(f"{plain_name} ran on meta tensors")

    monkeypatch.setattr(mod, plain_name, refuse)
    args = operands("meta")
    with ha.CostWalker() as walker:
        out = getattr(mod, fn_name)(*args, **kw)
    assert out.device.type == "meta"
    assert tuple(out.shape) == shape and out.dtype == torch.float32
    assert walker.cost.bytes == 4 * (sum(a.numel() for a in args)
                                     + math.prod(shape))
    assert walker.cost.flops == flops and walker.cost.ops == 1
    # outside a walker the meta result comes back all the same
    assert tuple(getattr(mod, fn_name)(*args, **kw).shape) == shape


@pytest.mark.parametrize("case", KERNELS, ids=[k[1] for k in KERNELS])
def test_wrapper_on_the_cpu_runs_plain_and_mixed_devices_raise(
        case, monkeypatch):
    mod_name, fn_name, plain_name, operands, kw, shape, _ = case
    mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
    plain = getattr(mod, plain_name)
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(mod, plain_name, counted)
    args = operands("cpu")
    out = getattr(mod, fn_name)(*args, **kw)
    assert calls == [1] and tuple(out.shape) == shape
    assert out.device.type == "cpu"
    mixed = [args[0].to("meta"), *args[1:]]
    with pytest.raises(ValueError, match="one CUDA device"):
        getattr(mod, fn_name)(*mixed, **kw)


def test_on_card_has_a_meta_outcome():
    assert common.on_card(meta(2), meta(3)) is common.META
    assert bool(common.META)          # a forgotten test goes the card's way
    assert common.on_card(torch.zeros(2)) is False


# --------------------------------------------------------------------------
# The dry-run
# --------------------------------------------------------------------------

def _reference_record_keys() -> tuple[set, set, set]:
    """The record keys (top level, ``memory``, ``collective``) that the
    reference's ``run_cell`` writes on its ``ok`` path, read from its
    source."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py")
                     .read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    top, memory, coll = set(), set(), set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", "") == "rec"):
            top |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "update"):
            top |= {k.arg for k in node.keywords}
            for k in node.keywords:
                if k.arg == "memory":
                    memory |= {m.arg for m in k.value.keywords}
        if isinstance(node, ast.Subscript) and isinstance(
                node.slice, ast.Constant) and isinstance(node.ctx, ast.Store):
            owner = getattr(node.value, "id", "")
            if owner == "rec":
                top.add(node.slice.value)
            elif owner == "coll":
                coll.add(node.slice.value)
            elif getattr(node.value.slice, "value", "") == "memory":
                memory.add(node.slice.value)
    off_path = {"skip_reason", "error", "traceback"}
    return top - off_path, memory, coll


SMOKE_CELLS = [ShapeSpec("train_4k", 64, 8, "train"),
               ShapeSpec("prefill_32k", 64, 4, "prefill"),
               ShapeSpec("decode_32k", 64, 4, "decode")]


@pytest.fixture(scope="module")
def smoke_records():
    mesh = dryrun.meta_mesh((2, 2), ("data", "model"))
    return {(arch, s.kind): dryrun.run_cell(
                arch, s.name, "2x2", mesh=mesh,
                cfg=get_config(arch).smoke(), shape=s, accum=2)
            for arch in ("gpt2-medium", "mamba2-780m") for s in SMOKE_CELLS}


@pytest.mark.parametrize("arch", ["gpt2-medium", "mamba2-780m"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_record_has_every_reference_key(smoke_records, arch, kind):
    rec = smoke_records[(arch, kind)]
    assert rec["status"] == "ok", rec.get("traceback")
    top, memory, coll = _reference_record_keys()
    assert {"status", "flops_per_device", "collective", "hlo_bytes"} <= top
    assert {"argument_bytes", "peak_per_device"} <= memory
    assert coll == {"total"}
    assert top <= set(rec) and memory <= set(rec["memory"])
    assert {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute", "count", "total"} == set(rec["collective"])
    for key in ("xla_flops_raw", "xla_bytes_raw", "hlo_bytes", "compile_s"):
        assert rec[key] is None
    assert rec["memory"]["generated_code_bytes"] is None
    assert "hlo_bytes" in rec["note"]
    assert rec["replicated_model_compute"] is False
    assert rec["ops"] > 0 and rec["flops_per_device"] > 0
    assert rec["collective"]["total"] == sum(
        v for k, v in rec["collective"].items() if k not in ("count", "total"))
    m = rec["memory"]
    assert m["peak_per_device"] == (m["argument_bytes"] + m["temp_bytes"]
                                    + m["output_bytes"] - m["alias_bytes"])
    assert rec["chips"] == 4 and rec["mesh_shape"] == {"data": 2, "model": 2}
    row = roofline_row(rec)
    assert row.status == "ok" and row.compute_s > 0 and row.fits_hbm


@pytest.mark.parametrize("arch", ["gpt2-medium", "mamba2-780m"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_model_flops_and_counts_are_the_references(smoke_records,
                                                          arch, kind):
    rec = smoke_records[(arch, kind)]
    cfg = ref_config(arch).smoke()
    shape = next(s for s in SMOKE_CELLS if s.kind == kind)
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    assert rec["model_flops"] == (6.0 if kind == "train" else 2.0) * n * tokens
    assert rec["params"] == cfg.param_count()
    assert rec["active_params"] == n


@pytest.mark.parametrize("arch", ["gpt2-medium", "mamba2-780m"])
def test_dryrun_argument_bytes_are_one_positions_shards(smoke_records, arch):
    mesh = dryrun.meta_mesh((2, 2), ("data", "model"))
    cfg = get_config(arch).smoke()
    shapes = tf.param_shapes(cfg)
    pspecs = param_specs(shapes, mesh, cfg)
    from repro_torch.models.layers import tree_leaves

    def share(tree, specs, itemsize=None):
        return sum(math.prod(NamedSharding(mesh, s).shard_shape(t.shape))
                   * (itemsize or t.element_size())
                   for t, s in zip(tree_leaves(tree), tree_leaves(specs)))

    params = share(shapes, pspecs)
    batch = batch_spec(cfg, SMOKE_CELLS[0])
    want = {"params": params,
            "opt": 2 * share(shapes, pspecs, 4) + 4,   # m, v and the step
            "batch": share(batch, batch_specs(batch, mesh))}
    rec = smoke_records[(arch, "train")]
    assert rec["memory"]["argument_parts"] == want
    assert rec["memory"]["argument_bytes"] == sum(want.values())
    assert rec["memory"]["alias_bytes"] == want["params"] + want["opt"]


def test_dryrun_skips_what_the_reference_skips():
    rec = dryrun.run_cell("gpt2-medium", "long_500k", "single")
    assert rec["status"] == "skipped" and "quadratic" in rec["skip_reason"]


def test_dryrun_cli_writes_the_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "production_meta_mesh",
                        lambda multi_pod=False: dryrun.meta_mesh(
                            (2, 2), ("data", "model")))
    monkeypatch.setattr(dryrun, "run_cell", _smoke_run_cell(dryrun.run_cell))
    assert dryrun.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(tmp_path)]) == 0
    assert "ok " in capsys.readouterr().out
    assert (tmp_path / "mamba2-780m__decode_32k__single.json").is_file()


def _smoke_run_cell(run_cell):
    def run(arch, shape, mesh_kind, **kw):
        return run_cell(arch, shape, mesh_kind, cfg=get_config(arch).smoke(),
                        shape=ShapeSpec(shape, 64, 4, "decode"))
    return run


# The reference walker counts dots only; the port's walker also charges
# the scan kernels' multiply-adds (2 a state element a chunk), which the
# reference's jnp scan spends in elementwise ops.  On mamba2-780m's smoke
# prefill that is 0.12 % of its FLOPs; gpt2-medium runs no kernel.
PREFILL_TOL = {"gpt2-medium": 0.0, "mamba2-780m": 2e-3}


@pytest.mark.parametrize("arch", sorted(PREFILL_TOL))
def test_prefill_flops_on_one_position_match_the_reference_walker(arch):
    from repro.models import batch_spec as ref_batch_spec
    from repro.models import transformer as ref_tf
    from repro.serving.generator import build_prefill_step
    rcfg = ref_config(arch).smoke()
    txt = jax.jit(build_prefill_step(rcfg)).lower(
        ref_tf.param_shapes(rcfg),
        ref_batch_spec(rcfg, RefShape("prefill_32k", 64, 4, "prefill"))
    ).compile().as_text()
    want = ref_ha.analyze(txt).flops
    rec = dryrun.run_cell(arch, "prefill_32k", "1x1",
                          mesh=dryrun.meta_mesh((1, 1), ("data", "model")),
                          cfg=get_config(arch).smoke(),
                          shape=ShapeSpec("prefill_32k", 64, 4, "prefill"))
    got = rec["flops_per_device"]
    assert got >= want
    assert (got - want) / want <= PREFILL_TOL[arch]
    assert rec["flops_one_device"] == got      # one position: the share is 1


def test_repeated_meta_blocks_are_charged_as_run():
    """A (2, 1) mesh splits the batch into two blocks of one row count:
    on meta the second is charged the first's recorded cost, so the whole
    step's work equals the 1 x 1 mesh's one block of the whole batch."""
    cfg = get_config("gpt2-medium").smoke()
    shape = ShapeSpec("prefill_32k", 64, 4, "prefill")
    one = dryrun.run_cell("gpt2-medium", shape.name, "1x1",
                          mesh=dryrun.meta_mesh((1, 1), ("data", "model")),
                          cfg=cfg, shape=shape)
    two = dryrun.run_cell("gpt2-medium", shape.name, "2x1",
                          mesh=dryrun.meta_mesh((2, 1), ("data", "model")),
                          cfg=cfg, shape=shape)
    assert two["blocks"] == 2
    # a data block is half the rows: the products of half the batch
    assert two["flops_per_device"] == pytest.approx(
        one["flops_per_device"] / 2, rel=1e-9)
    assert two["flops_one_device"] == pytest.approx(
        one["flops_one_device"], rel=1e-9)
    assert np.isclose(two["memory"]["argument_parts"]["batch"],
                      one["memory"]["argument_parts"]["batch"] / 2)
