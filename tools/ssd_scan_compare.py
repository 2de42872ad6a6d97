"""``ssd_chunk_scan``'s kernels on the card, one source against another.

Builds ``csrc/ssd_scan.cu`` of this checkout and, beside it, the sources
named on the command line, each into its own library under
``build/ssd_scan_compare/``:

* ``--parent PATH``: another checkout's ``ssd_scan.cu`` (for instance a
  ``git archive`` of the parent commit unpacked under ``build/``), timed
  by its forward entry point and by the backward composed around that
  forward (flip g and decay, scan, flip back, Σ μ·h in float32), as the
  port ran it before the reverse kernel;
* ``--variant U_FWD,BLOCKS_FWD,U_BWD,BLOCKS_BWD`` (repeatable): this
  checkout's source with those look-ahead and launch-bound constants.

Each library's outputs are held against the plain versions of
``repro_torch.kernels.ssd`` (float32, 1e-5 forward, 2e-5 of each
output's scale backward) at the LM path's shapes, then timed: the device
time of 20 back-to-back calls captured in one CUDA graph and replayed (no
host time; L2-warm), and one call after 100 MB are written (L2-cold),
bracketed by CUDA events with the device held back until the host has
queued it.  ptxas's registers and spill stores are printed for each
library.  Run it on the card from the repository root::

    git archive <parent> | tar -x -C build/parent
    python3 tools/ssd_scan_compare.py \\
        --parent build/parent/src/repro_torch/csrc/ssd_scan.cu \\
        --variant 4,6,4,4 --variant 2,8,2,6

The record goes to ``build/ssd_scan_compare/record.json``; every number
in it is also printed.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(16, 96, 64, 128), (8, 96, 64, 128), (8, 48, 64, 128),
          (2, 48, 64, 128)]
CONSTANTS = ("U_FWD", "BLOCKS_FWD", "U_BWD", "BLOCKS_BWD")
FLUSH_BYTES = 100 * 2**20
GRAPH_CALLS, REPLAYS, COLD_CALLS = 20, 5, 10
SEED = 28


def _library(name: str, text: str, functions: dict):
    from repro_torch.kernels import common
    folder = ROOT / "build" / "ssd_scan_compare" / name
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "ssd_scan.cu").write_text(text)
    lib = common.CudaLibrary("ssd_scan.cu", functions)
    lib.source = folder / "ssd_scan.cu"
    return lib


def _with_constants(text: str, values) -> str:
    for key, value in zip(CONSTANTS, values):
        text, n = re.subn(rf"constexpr int {key} = \d+;",
                          f"constexpr int {key} = {value};", text)
        if n != 1:
            raise SystemExit(f"ssd_scan.cu has no constant {key}")
    return text


def _forward(lib, st, dec):
    import torch

    from repro_torch.kernels import common
    out = torch.empty_like(st)
    nc, BH, P, N = st.shape
    lib.launch("codo_ssd_chunk_scan", common.dtype_code(st), st.data_ptr(),
               dec.data_ptr(), out.data_ptr(), nc, BH, P * N,
               common.stream_of(st))
    return out


def _backward(lib, g, dec, h):
    import torch

    from repro_torch.kernels import common
    if "codo_ssd_chunk_scan_backward" not in lib.functions:
        mu = _forward(lib, g.flip(0), dec.flip(0)).flip(0)
        return mu, (mu * h).sum(dim=(-2, -1), keepdim=True)
    ds, dd = torch.empty_like(g), torch.empty_like(dec)
    nc, BH, P, N = g.shape
    lib.launch("codo_ssd_chunk_scan_backward", common.dtype_code(g),
               g.data_ptr(), dec.data_ptr(), h.data_ptr(), ds.data_ptr(),
               dd.data_ptr(), nc, BH, P * N, common.stream_of(g))
    return ds, dd


def _graph_ms(fn) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (REPLAYS * GRAPH_CALLS)


def _cold_ms(fn, flush) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(COLD_CALLS)]
    for start, end in events:
        flush.zero_()
        torch.cuda._sleep(300_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / COLD_CALLS


def _scaled(got, want) -> float:
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale else err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/ssd_scan_compare.py")
    ap.add_argument("--parent", type=Path,
                    help="another checkout's csrc/ssd_scan.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="U_FWD,BLOCKS_FWD,U_BWD,BLOCKS_BWD")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.ssd import ssd as sd
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run on the card")
    source = (common.CSRC / "ssd_scan.cu").read_text()
    libs = {"this": sd.LIBRARY}
    if args.parent:
        libs["parent"] = _library("parent", args.parent.read_text(), {
            "codo_ssd_chunk_scan": sd.LIBRARY.functions[
                "codo_ssd_chunk_scan"]})
    for v in args.variant:
        values = [int(x) for x in v.split(",")]
        libs[v] = _library("v" + "_".join(map(str, values)),
                           _with_constants(source, values),
                           dict(sd.LIBRARY.functions))
    # one build a distinct source (a variant may repeat this checkout's)
    common.build_all(list({lib.path: lib for lib in libs.values()}.values()))
    record = {"card": torch.cuda.get_device_name(0), "libraries": {},
              "shapes": {}}
    for name, lib in libs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                           lib.build_log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             lib.build_log)]
        record["libraries"][name] = {"registers": regs, "spill_stores": spills}
        print(f"{name}: registers {regs}, spill stores {spills}")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for shape in SHAPES:
        nc, BH = shape[:2]
        st = 0.1 * torch.randn(shape, generator=g, device="cuda")
        dec = 0.5 + 0.49 * torch.rand((nc, BH, 1, 1), generator=g,
                                      device="cuda")
        cot = 0.1 * torch.randn(shape, generator=g, device="cuda")
        h = sd.ssd_chunk_scan_plain(st, dec)
        want = sd.ssd_chunk_scan_backward_plain(cot, dec, h)
        text = "x".join(map(str, shape))
        rows = record["shapes"][text] = {}
        for name, lib in libs.items():
            fwd_err = float((_forward(lib, st, dec) - h).abs().max())
            bwd_err = max(_scaled(a, b) for a, b in
                          zip(_backward(lib, cot, dec, h), want))
            if not (fwd_err <= 1e-5 * (1 + float(h.abs().max()))
                    and bwd_err <= 2e-5):
                raise SystemExit(f"{name} {text}: forward error {fwd_err}, "
                                 f"backward {bwd_err} of scale")
            row = rows[name] = {}
            for kind, fn in (("forward", lambda: _forward(lib, st, dec)),
                             ("backward", lambda: _backward(lib, cot, dec,
                                                            h))):
                row[kind] = {"graph_ms": _graph_ms(fn),
                             "cold_ms": _cold_ms(fn, flush)}
            print(f"{text} {name:>9s}: forward graph "
                  f"{row['forward']['graph_ms']:.4f} cold "
                  f"{row['forward']['cold_ms']:.4f} | backward graph "
                  f"{row['backward']['graph_ms']:.4f} cold "
                  f"{row['backward']['cold_ms']:.4f}")
    folder = ROOT / "build" / "ssd_scan_compare"
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "record.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
