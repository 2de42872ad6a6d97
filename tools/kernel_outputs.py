"""Kernel outputs on the card from one checkout, for comparing two
checkouts in one session.

``save`` imports ``repro_torch`` from the checkout at ``--root`` (its own
sources, built into its own ``build/kernels/``) and, on seeded operands:

* runs ``rglru_scan`` at RecurrentGemma-9B's route (2, 2048, 4096) at
  chunks 16, 32, 64 and 128, on ragged shapes and in bfloat16, and writes
  the outputs with ``torch.save``;
* prints the error against float64 of ``flash_attention`` and
  ``fused_matmul_chain`` at gpt2_block's routes (D = 1024, S = 128 and
  1024; q, kᵀ as a transposed view and v; the FFN fc → gelu → fc), with
  PyTorch's float32 (SDPA, matmul → gelu → matmul) beside them.

``compare`` reads two saved files and prints, for each rglru case,
whether the outputs are equal bit for bit and the largest difference; it
exits 1 if any case differs.  The operands come from a CUDA generator, so
run both checkouts on one card with one PyTorch::

    python3 tools/kernel_outputs.py save --root build/parent --out build/a.pt
    python3 tools/kernel_outputs.py save --root . --out build/b.pt
    python3 tools/kernel_outputs.py compare build/a.pt build/b.pt
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

# (B, S, D, chunk, dtype name): the route, shorter and longer chunks than
# the route's, ragged sequences and a bfloat16 case.
RGLRU_CASES = [(2, 2048, 4096, 64, "float32"), (2, 2048, 4096, 32, "float32"),
               (2, 2048, 4096, 16, "float32"), (2, 2048, 4096, 128, "float32"),
               (2, 100, 40, 16, "float32"), (2, 77, 24, 128, "float32"),
               (3, 1000, 520, 64, "float32"), (2, 256, 64, 64, "bfloat16")]
D_MODEL = 1024
SEQS = (128, 1024)
SCALE = 1.0 / math.sqrt(D_MODEL // 16)    # gpt2_block's score scale
SEED = 18


def _err(x, y) -> float:
    return float((x.double() - y.double()).abs().max())


def precision(g) -> None:
    """flash_attention and fused_matmul_chain against float64 at
    gpt2_block's routes, PyTorch's float32 beside them."""
    import torch
    from repro_torch.kernels.flashattn import flash_attention
    from repro_torch.kernels.streamfuse import fused_matmul_chain
    for S in SEQS:
        q = torch.randn(1, 1, S, D_MODEL, generator=g, device="cuda")
        kt = torch.randn(D_MODEL, S, generator=g, device="cuda")
        v = torch.randn(1, 1, S, D_MODEL, generator=g, device="cuda")
        k = kt.t()[None, None]
        got = flash_attention(q, k, v, causal=False, window=0, scale=SCALE)
        exact = torch.softmax(q.double() @ k.double().transpose(-1, -2)
                              * SCALE, -1) @ v.double()
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=SCALE)
        print(f"  flash S={S} hd={D_MODEL}: kernel vs float64 "
              f"{_err(got, exact):.3e}, SDPA float32 {_err(sdpa, exact):.3e} "
              f"(scale {float(exact.abs().max()):.3f})")
        a = torch.randn(S, D_MODEL, generator=g, device="cuda")
        w1 = torch.randn(D_MODEL, 4 * D_MODEL, generator=g,
                         device="cuda") / math.sqrt(D_MODEL)
        w2 = torch.randn(4 * D_MODEL, D_MODEL, generator=g,
                         device="cuda") / math.sqrt(4 * D_MODEL)
        gelu = (("gelu", {}),)
        got = fused_matmul_chain(a, w1, w2, ew=gelu)
        f = torch.nn.functional.gelu
        exact = f(a.double() @ w1.double(), approximate="tanh") @ w2.double()
        plain = f(a @ w1, approximate="tanh") @ w2
        print(f"  mmchain S={S} {D_MODEL}x{4 * D_MODEL}x{D_MODEL} gelu: "
              f"kernel vs float64 {_err(got, exact):.3e}, cuBLAS float32 "
              f"{_err(plain, exact):.3e} (scale "
              f"{float(exact.abs().max()):.3f})")


def save(root: Path, out: Path) -> None:
    import torch
    sys.path.insert(0, str(root.resolve() / "src"))
    from repro_torch.kernels.rglru import rglru_scan
    if not torch.cuda.is_available():
        raise SystemExit("kernel_outputs: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for B, S, D, chunk, dtype in RGLRU_CASES:
        a = 0.5 + 0.499 * torch.rand(B, S, D, generator=g, device="cuda")
        b = 0.1 * torch.randn(B, S, D, generator=g, device="cuda")
        a, b = a.to(getattr(torch, dtype)), b.to(getattr(torch, dtype))
        results[f"rglru {B}x{S}x{D} chunk={chunk} {dtype}"] = rglru_scan(
            a, b, chunk=chunk).cpu()
    print(f"kernel_outputs: {root}")
    precision(g)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(results, out)
    print(f"kernel_outputs: {len(results)} rglru cases -> {out}")


def compare(first: Path, second: Path) -> int:
    import torch
    x, y = torch.load(first), torch.load(second)
    differ = 0
    for case in x:
        same = torch.equal(x[case], y[case])
        differ += not same
        print(f"  {case:<36s} bit-identical {same}  max diff "
              f"{_err(x[case], y[case]):.3e}")
    print(f"kernel_outputs: {len(x) - differ} of {len(x)} cases "
          f"bit-identical")
    return 1 if differ else 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    s = sub.add_parser("save")
    s.add_argument("--root", type=Path, required=True)
    s.add_argument("--out", type=Path, required=True)
    c = sub.add_parser("compare")
    c.add_argument("files", type=Path, nargs=2)
    args = parser.parse_args()
    if args.mode == "save":
        save(args.root, args.out)
        return 0
    return compare(*args.files)


if __name__ == "__main__":
    raise SystemExit(main())
