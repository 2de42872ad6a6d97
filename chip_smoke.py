#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

In order, and failing (non-zero exit, no result line) at the first
problem:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every kernel of the main path from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together) and prints the time;
3. holds each kernel against its plain PyTorch version on the card, at
   the kernel sweep's shapes and at the main path's own, printing the max
   error beside its stated tolerance, and times kernel, plain version,
   bound and a library yardstick;
4. drives the main path — ``codo_torch.compile(gpt2_block_fn, (S, 1024))``
   with the default cost gate, distinct seeded weights bound through
   ``params_from_numpy`` — at S=128 and S=1024: four requests each, the
   launch counters zeroed just before and read just after, then
   ``verify()`` against the task-by-task oracle on the card;
5. prints the card line, the ``kernels`` JSON line and, last, the
   ``{"ok": true, "device": ...}`` line.

The full record (every check, every timing) goes to
``chiprun_out/chip_smoke.json``.  Imports nothing of JAX or the JAX
package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
D_MODEL = 1024                  # GPT-2 medium width
SEQS = (128, 1024)
REQUESTS = 4
SEED = 0
# Published peaks of one H100 SXM (data sheet): float32 outside the tensor
# cores, and device memory bandwidth.  Both kernels run float32 FMAs.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Tolerances, kernel against plain version on the card.  The kernels and
# cuBLAS sum float32 products in different orders; the sweep shapes keep
# tests/test_kernels.py's bands, the D=1024 shapes allow for K-term sums
# (K up to 4096): typical error ~sqrt(K)·u·|terms| ≈ 1e-5, bound 1e-4.
TOL = {"f32": 2e-5, "bf16": 2e-2, "f32_wide": 1e-4}
# verify() band on the card: the oracle runs each matmul through cuBLAS,
# the routed path through the two kernels, whose sums over K=1024 and
# N1=4096 run in another order — 1e-5 (the reference's CPU band) is not a
# bound for that; 1e-4 is ~sqrt(4096)·u·|h|·|w| with headroom.
VERIFY_BAND = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after warm-up; operands stay L2-warm between calls)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel, iters: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = time_ms(plain, iters)
    k1 = time_ms(kernel, iters)
    k2 = time_ms(kernel, iters)
    p2 = time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check(record: list, name: str, got, want, tol: float) -> float:
    import torch
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite values")
    err = max_err(got, want)
    scale = float(want.float().abs().max())
    ok = err <= tol * (1.0 + scale)
    print(f"  {name:<48s} max_abs_err {err:.3e}  tol {tol:.0e}·(1+{scale:.2f})"
          f"  {'ok' if ok else 'FAIL'}")
    record.append({"case": name, "max_abs_err": err, "tol": tol,
                   "max_abs_ref": scale, "ok": ok})
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


def check_flash(record: list) -> None:
    import torch
    from repro_torch.kernels.flashattn import (flash_attention,
                                               flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for B, Hq, Hkv, S, hd in [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64),
                              (1, 8, 1, 256, 128), (2, 2, 2, 384, 32)]:
        for causal, window in [(True, 0), (False, 0), (True, 128)]:
            for dtype, tol in [(torch.float32, TOL["f32"]),
                               (torch.bfloat16, TOL["bf16"])]:
                q = torch.randn(B, Hq, S, hd, generator=g, device="cuda")
                k = torch.randn(B, Hkv, S, hd, generator=g, device="cuda")
                v = torch.randn(B, Hkv, S, hd, generator=g, device="cuda")
                q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
                kw = dict(causal=causal, window=window)
                check(record, f"flash {B}x{Hq}/{Hkv}x{S}x{hd} c={int(causal)} "
                      f"w={window} {str(dtype)[6:]}",
                      flash_attention(q, k, v, **kw),
                      flash_attention_plain(q, k, v, **kw), tol)
    q, k, v = (torch.randn(1, 3, 100, 40, generator=g, device="cuda")
               for _ in range(3))
    check(record, "flash ragged 1x3x100x40 c=1", flash_attention(q, k, v),
          flash_attention_plain(q, k, v), TOL["f32"])


def flash_route_operands(S: int, g):
    """The routed chain's operands at width D: q (S, D), kᵀ (D, S) handed
    over as a transposed view, v (S, D); single head, hd = D."""
    import torch
    q = torch.randn(S, D_MODEL, generator=g, device="cuda")
    kt = torch.randn(D_MODEL, S, generator=g, device="cuda")
    v = torch.randn(S, D_MODEL, generator=g, device="cuda")
    return q[None, None], kt.transpose(-1, -2)[None, None], v[None, None]


def chain_route_operands(S: int, g):
    import torch
    a = torch.randn(S, D_MODEL, generator=g, device="cuda")
    w1 = torch.randn(D_MODEL, 4 * D_MODEL, generator=g,
                     device="cuda") / math.sqrt(D_MODEL)
    w2 = torch.randn(4 * D_MODEL, D_MODEL, generator=g,
                     device="cuda") / math.sqrt(4 * D_MODEL)
    return a, w1, w2


GELU = (("gelu", {}),)
C = 1.0 / math.sqrt(D_MODEL // 16)     # gpt2_block's score scale


def check_chain(record: list) -> None:
    import torch
    from repro_torch.kernels.streamfuse import (fused_matmul_chain,
                                                matmul_chain_plain)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for S in SEQS:
        a, w1, w2 = chain_route_operands(S, g)
        for tail_name, ew in [("gelu", GELU),
                              ("relu+scale", (("relu", {}),
                                              ("scale", {"s": 0.5})))]:
            check(record, f"mmchain {S}x{D_MODEL}x{4 * D_MODEL}x{D_MODEL} "
                  f"{tail_name}", fused_matmul_chain(a, w1, w2, ew=ew),
                  matmul_chain_plain(a, w1, w2, ew=ew), TOL["f32_wide"])
    a, w1, w2 = (torch.randn(*s, generator=g, device="cuda") * 0.3
                 for s in [(100, 96), (96, 200), (200, 72)])
    ew = (("affine", {"a": 1.0, "b": 4.0}), ("rdivc", {"c": 2.0}))
    check(record, "mmchain ragged 100x96x200x72 affine+rdivc",
          fused_matmul_chain(a, w1, w2, ew=ew),
          matmul_chain_plain(a, w1, w2, ew=ew), TOL["f32"])
    a, w1, w2 = ((torch.randn(*s, generator=g, device="cuda") * 0.1).bfloat16()
                 for s in [(128, 256), (256, 512), (512, 128)])
    check(record, "mmchain 128x256x512x128 gelu bf16",
          fused_matmul_chain(a, w1, w2, ew=GELU),
          matmul_chain_plain(a, w1, w2, ew=GELU), TOL["bf16"])


def measure_kernels(S: int, record: dict) -> dict:
    """Kernel, plain and library times at the main path's shapes for S,
    with the max error there."""
    import torch
    from repro_torch.kernels.flashattn import (flash_attention,
                                               flash_attention_plain)
    from repro_torch.kernels.streamfuse import (fused_matmul_chain,
                                                matmul_chain_plain)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    iters = 20 if S <= 128 else 5
    out = {}

    q, k, v = flash_route_operands(S, g)
    kw = dict(causal=False, window=0, scale=C)
    err = check(record["checks"], f"flash route 1x1x{S}x{D_MODEL} scale={C}",
                flash_attention(q, k, v, **kw),
                flash_attention_plain(q, k, v, **kw), TOL["f32_wide"])
    ms, plain = in_turns(lambda: flash_attention_plain(q, k, v, **kw),
                         lambda: flash_attention(q, k, v, **kw), iters)
    library = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, scale=C), iters)
    b, by = bound_ms(4.0 * S * S * D_MODEL, 4.0 * 4 * S * D_MODEL)
    out["flash"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                        bound_by=by, library_ms=library)

    a, w1, w2 = chain_route_operands(S, g)
    err = check(record["checks"], f"mmchain route {S}x{D_MODEL}x"
                f"{4 * D_MODEL}x{D_MODEL} gelu",
                fused_matmul_chain(a, w1, w2, ew=GELU),
                matmul_chain_plain(a, w1, w2, ew=GELU), TOL["f32_wide"])
    ms, plain = in_turns(lambda: matmul_chain_plain(a, w1, w2, ew=GELU),
                         lambda: fused_matmul_chain(a, w1, w2, ew=GELU), iters)

    def library_chain():
        h = torch.nn.functional.gelu(a @ w1, approximate="tanh")
        return h @ w2

    library = time_ms(library_chain, iters)
    n1 = 4 * D_MODEL
    b, by = bound_ms(2.0 * S * n1 * (D_MODEL + D_MODEL),
                     4.0 * (S * D_MODEL + D_MODEL * n1 + n1 * D_MODEL
                            + S * D_MODEL))
    out["mmchain"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                          bound_by=by, library_ms=library)
    for name, m in out.items():
        print(f"  S={S} {name:<8s} kernel {m['ms']:.4f} ms  plain "
              f"{m['plain_ms']:.4f} ms  library {m['library_ms']:.4f} ms  "
              f"bound {m['bound_ms']:.4f} ms ({m['bound_by']})")
    return out


def main_path(S: int, record: dict) -> dict:
    """codo_torch.compile(gpt2_block_fn, (S, D)) with the default gate:
    four requests with the launch counters zeroed just before, then
    verify() on the card."""
    import numpy as np
    import torch

    import codo_torch
    from repro_torch.kernels.flashattn import LIBRARY as FLASH
    from repro_torch.kernels.streamfuse import LIBRARY as CHAIN
    from repro_torch.models.dataflow_models import gpt2_block_fn

    t0 = time.perf_counter()
    program = codo_torch.compile(gpt2_block_fn, (S, D_MODEL))
    rng = np.random.default_rng(SEED + S)
    weights = {b.name: (rng.standard_normal(b.shape) / math.sqrt(b.shape[0])
                        ).astype(np.float32) for b in program.graph.weights()}
    if len({w.tobytes() for w in weights.values()}) != len(weights):
        fail("bound weights are not distinct")
    program.bind(**codo_torch.params_from_numpy(weights, program.graph,
                                                program.device))
    kernels = [g.kernel for g in program.lower().groups]
    compile_s = time.perf_counter() - t0
    if kernels != ["pallas:flashattn.mha+streamfuse.mmchain"]:
        fail(f"S={S}: expected one group routed to both kernels, got "
             f"{kernels}")
    xs = [rng.standard_normal((S, D_MODEL)).astype(np.float32)
          for _ in range(REQUESTS)]
    program(xs[0])                                  # warm (allocator, libs)
    torch.cuda.synchronize()

    FLASH.launches = CHAIN.launches = 0
    outs, walls = [], []
    for x in xs:
        t = time.perf_counter()
        y = program(x)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
        outs.append(y)
    launches = {"flash": FLASH.launches, "mmchain": CHAIN.launches}

    for y in outs:
        if tuple(y.shape) != (S, D_MODEL) or not bool(torch.isfinite(y).all()):
            fail(f"S={S}: output not finite or not ({S}, {D_MODEL})")
    if len({float(y.double().sum()) for y in outs}) != REQUESTS:
        fail(f"S={S}: distinct requests gave identical outputs")
    if launches["flash"] < REQUESTS or launches["mmchain"] < REQUESTS:
        fail(f"S={S}: a kernel of the path did not run each request: "
             f"{launches}")
    program.verify(xs[1], rtol=VERIFY_BAND, atol=VERIFY_BAND)
    env = program.make_env(xs[1])
    err = max_err(program.lower()(env)[program.output_names[0]],
                  program.source.execute(env)[program.output_names[0]])
    print(f"  S={S}: group {kernels[0]}; {REQUESTS} requests, wall "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms; launches {launches}; "
          f"verify max_abs_err {err:.3e} within {VERIFY_BAND:.0e}")
    result = {"S": S, "kernels": kernels, "compile_s": compile_s,
              "request_ms": walls, "launches": launches,
              "verify_max_abs_err": err, "verify_band": VERIFY_BAND}
    if S == SEQS[0]:
        # The same program on the CPU (plain versions): same answer.
        cpu = codo_torch.compile(gpt2_block_fn, (S, D_MODEL), device="cpu")
        cpu.bind(**weights)
        cpu_err = max_err(outs[0].cpu(), cpu(xs[0]))
        print(f"  S={S}: card vs the port on the CPU max_abs_err "
              f"{cpu_err:.3e}")
        if not cpu_err <= VERIFY_BAND * (1 + float(outs[0].abs().max())):
            fail(f"S={S}: card and CPU disagree ({cpu_err:.3e})")
        result["cpu_max_abs_err"] = cpu_err
    result["profile"] = profile_request(program, xs[2])
    return result


def profile_request(program, x) -> list:
    """Device time by kernel name over one request (torch.profiler; a
    second try when the first records no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    env = program.make_env(x)
    run = program.lower()
    rows: list = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(env)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            dev = getattr(e, "device_time_total", None)
            if dev is None:
                dev = getattr(e, "cuda_time_total", 0.0)
            if dev and getattr(e, "device_type", None) == \
                    torch.autograd.DeviceType.CUDA:
                rows.append({"name": e.key[:80], "count": e.count,
                             "device_us": float(dev)})
        if rows:
            break
    rows.sort(key=lambda r: -r["device_us"])
    total = sum(r["device_us"] for r in rows)
    print(f"    profile: {total:.1f} us on the device, by kernel: "
          + "; ".join(f"{r['name'][:40]} {r['device_us']:.1f} us"
                      for r in rows[:6]))
    return rows


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    for var in ("CODO_FORCE_PALLAS", "CODO_DISABLE_PALLAS", "CODO_BACKEND"):
        os.environ.pop(var, None)          # the default gate, no forcing
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    t_start = time.perf_counter()
    record: dict = {"checks": []}

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import common, flashattn, streamfuse
    libs = {"flash": flashattn.LIBRARY, "mmchain": streamfuse.LIBRARY}
    build_s = common.build_all(list(libs.values()))
    print(f"build: {build_s:.1f} s for {len(libs)} kernels (nvcc, parallel)")
    for lib in libs.values():
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {lib.source.name}: {line.strip()}")
    record["build_s"] = build_s

    print("kernels against their plain versions:")
    check_flash(record["checks"])
    check_chain(record["checks"])
    measured = {}
    for S in SEQS:
        measured[S] = measure_kernels(S, record)
    record["measured"] = {str(s): m for s, m in measured.items()}

    print("main path: codo_torch.compile(gpt2_block_fn, (S, 1024)):")
    runs = {S: main_path(S, record) for S in SEQS}
    record["main_path"] = {str(s): r for s, r in runs.items()}

    source = {"flash": ("flash_attention", "src/repro_torch/csrc/flashattn.cu",
                        "src/repro/kernels/flashattn/flashattn.py:96"),
              "mmchain": ("fused_matmul_chain", "src/repro_torch/csrc/chain.cu",
                          "src/repro/kernels/streamfuse/chain.py:79")}
    entries = []
    for S in SEQS:
        for key, (fn, src, replaces) in source.items():
            m = measured[S][key]
            entries.append({
                "name": f"{fn}[S={S}]", "route": "cuda", "source": src,
                "replaces": replaces, "launches": runs[S]["launches"][key],
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    record["kernels"] = entries
    record["card"] = card
    record["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"total {record['seconds']:.1f} s")

    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
