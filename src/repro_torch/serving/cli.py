"""The serving CLI of the PyTorch port: a request loop against a
compiled-design artifact through the
:class:`~repro_torch.serving.runtime.ServingRuntime` (dynamic batching,
worker pool, hot-swap), on the card unless ``--device`` says otherwise.

Artifact serving — no recompile, no model code: ``codo_torch.load`` a
versioned JSON artifact (``docs/artifact_format.md``, written by either
package) into a ``CompiledProgram`` and run a request loop against it.  By
default each request gets random inputs; production-style serving feeds
real tensors from an npz archive (one array per input buffer, validated
against the artifact's buffer table):

    PYTHONPATH=src python -m repro_torch.serving.cli \\
        --artifact design.json --requests 8 --inputs batch.npz \\
        [--device cpu]

LM token generation: ``--arch`` serves a catalog architecture
(``repro_torch.configs``) with seeded random weights through the
:class:`~repro_torch.serving.generator.Generator` (its decode step
captured into a CUDA graph on the card), ``--smoke`` at its reduced
config:

    PYTHONPATH=src python -m repro_torch.serving.cli --arch gpt2-medium \\
        [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


class InputError(ValueError):
    """An --inputs npz archive does not match the artifact's buffers."""


def load_input_env(path: str, graph) -> dict:
    """Load real input arrays for ``graph`` from an ``.npz`` archive.

    Every ``input`` buffer must be present with the exact declared shape;
    dtypes are normalized *before* validation: arrays are cast to the
    buffer dtype (an information-losing cast — e.g. float64 data into a
    float32 buffer, or int labels into a float buffer — is allowed), and a
    non-numeric array that cannot cast is an :class:`InputError`, never a
    raw traceback.  Weight buffers may optionally be supplied too; unknown
    array names are an error, so a typo'd key cannot silently fall back to
    random data.  Every failure mode — unreadable archive, pickled object
    arrays, 0-d scalars, shape or name mismatches — reports as
    :class:`InputError` (CLI exit code 2).
    """
    try:
        with np.load(path) as npz:
            arrays = {k: npz[k] for k in npz.files}
    except InputError:
        raise
    except Exception as e:      # OSError, BadZipFile, pickle-disabled, ...
        raise InputError(f"{path}: not a readable npz archive "
                         f"({type(e).__name__}: {e})") from e
    bindable = {b.name: b for b in graph.buffers.values()
                if b.kind in ("input", "weight")}
    unknown = sorted(set(arrays) - set(bindable))
    if unknown:
        raise InputError(f"{path}: unknown array names {unknown}; "
                         f"bindable buffers: {sorted(bindable)}")
    missing = sorted(b.name for b in graph.inputs() if b.name not in arrays)
    if missing:
        raise InputError(f"{path}: missing input arrays {missing} "
                         f"(inputs: {sorted(b.name for b in graph.inputs())})")
    env = {}
    for name, arr in arrays.items():
        buf = bindable[name]
        # Normalize the dtype first: validation below then reasons about
        # clean, buffer-typed arrays only.
        try:
            arr = np.asarray(arr).astype(np.dtype(buf.dtype), copy=False)
        except (TypeError, ValueError) as e:
            raise InputError(
                f"{path}: array {name!r} (dtype {np.asarray(arr).dtype}) "
                f"does not cast to buffer dtype "
                f"{np.dtype(buf.dtype).name}: {e}") from e
        if arr.ndim == 0 and tuple(buf.shape):
            raise InputError(
                f"{path}: array {name!r} is 0-d (a Python scalar saved "
                f"with np.savez?); buffer {name!r} expects shape "
                f"{tuple(buf.shape)}")
        if tuple(arr.shape) != tuple(buf.shape):
            raise InputError(f"{path}: array {name!r} has shape "
                             f"{tuple(arr.shape)}, buffer expects "
                             f"{tuple(buf.shape)}")
        env[name] = arr
    return env


def serve_artifact(args) -> int:
    """Serve straight from an imported artifact: the design the compiler
    exported is the unit of deployment — this launcher never sees the
    model-building code that produced it.  Requests flow through the
    :class:`ServingRuntime` on ``args.device``: same-model requests inside
    one batching window coalesce into a leading-batch-dim execution."""
    from repro_torch.core.artifact import artifact_summary
    from repro_torch.models.dataflow_models import random_inputs

    from .runtime import ServeConfig, ServingRuntime

    print(artifact_summary(args.artifact))
    cfg = ServeConfig.from_env(workers=args.workers,
                               batch_window_ms=args.batch_window_ms,
                               max_batch=max(1, args.max_batch))
    with ServingRuntime(cfg, device=args.device or None) as rt:
        handle = rt.add_model("artifact", args.artifact)
        program = handle.program
        if cfg.workers == 0:
            print(program.lower().summary())

        if args.inputs:
            env = load_input_env(args.inputs, program.graph)
            try:
                program.make_env(**env)     # validate before serving
            except (KeyError, TypeError, ValueError) as e:
                # Anything load_input_env's checks missed still reports as
                # the documented InputError (exit 2), never a traceback.
                raise InputError(f"{args.inputs}: {e}") from e
            envs = [env] * args.requests
            print(f"serving real inputs from {args.inputs} "
                  f"({sorted(env)})")
        else:
            # Inputs only: the weights are the model's (bound from the
            # artifact's payload, or the deterministic initializer) — and
            # identical-keyed requests coalesce into batched dispatches.
            envs = [{n: random_inputs(program.graph, seed=args.seed + i)[n]
                     for n in program.input_names}
                    for i in range(args.requests)]

        t0 = time.time()
        futs = [rt.submit("artifact", **env) for env in envs]
        outs = [f.result(timeout=600) for f in futs]
        dt = time.time() - t0
        s = rt.stats
        print(f"{args.requests} requests on {rt.device} in "
              f"{dt * 1e3:.1f} ms ({args.requests / max(dt, 1e-9):.1f} "
              f"req/s); {s.batches} dispatches, {s.batched_requests} "
              f"batched / {s.fallback_requests} per-request; outputs "
              f"{sorted(program.output_names)}")
        if len(outs) != args.requests:
            raise RuntimeError(f"{len(outs)} answers to {args.requests} "
                               f"requests")
    return 0


def serve_lm(args) -> int:
    """Generate tokens for ``args.requests`` seeded prompts with the
    weights drawn from ``args.seed`` on ``args.device`` (the card unless
    it says otherwise); prints each request's tokens, then the decode
    steps, the tokens a second and the device."""
    import torch

    from repro_torch.api import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    from .generator import Generator, Request

    device = resolve_device(args.device or None)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    params = tf.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    gen = Generator(cfg, params, batch=args.batch, cache_len=args.cache_len)

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        gen.submit(Request(rid, prompt=list(
            rng.integers(1, cfg.vocab, size=args.prompt_len)),
            max_new=args.max_new))

    t0 = time.time()
    finished = gen.run(max_steps=args.cache_len - 1)
    dt = time.time() - t0
    for r in sorted(finished, key=lambda r: r.rid):
        print(f"req {r.rid}: {len(r.out)} tokens -> {r.out[:8]}...")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    print(f"{len(finished)}/{args.requests} finished; {gen.steps} decode "
          f"steps, {gen.tokens_out} tokens, "
          f"{gen.tokens_out / max(dt, 1e-9):.1f} tok/s on {where}")
    return 0


def main(argv=None) -> int:
    from .runtime import ServeConfig
    env = ServeConfig.from_env()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="",
                    help="LM architecture to serve (token generation)")
    ap.add_argument("--artifact", default="",
                    help="serve a compiled-design JSON artifact "
                         "(see docs/artifact_format.md)")
    ap.add_argument("--inputs", default="",
                    help="with --artifact: npz archive of real input "
                         "tensors (one array per input buffer; shapes/"
                         "dtypes validated) instead of random data")
    ap.add_argument("--device", default="",
                    help="device to serve on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=env.workers,
                    help="serving worker processes (0 = in-process; "
                         "default CODO_SERVE_WORKERS)")
    ap.add_argument("--batch-window-ms", type=float,
                    default=env.batch_window_ms,
                    help="dynamic-batching window "
                         "(default CODO_SERVE_BATCH_WINDOW_MS)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="dispatch a window early at this group size")
    args = ap.parse_args(argv)

    if bool(args.arch) == bool(args.artifact):
        ap.error("exactly one of --arch or --artifact is required")
    if args.inputs and not args.artifact:
        ap.error("--inputs only applies to --artifact serving")
    if args.artifact and args.requests < 1:
        ap.error("--requests must be >= 1 when serving an artifact")
    try:
        return serve_artifact(args) if args.artifact else serve_lm(args)
    except InputError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
