"""Model zoo facade + batch construction for every (arch × shape) cell.

The port's copy of ``repro/models/__init__.py``, plus
:func:`params_from_numpy`, which carries a reference parameter (or cache)
tree into the port's.  The LM modules import torch; the workload builders
(:mod:`.dataflow_models`) do not, so the LM names load at first use.
"""

from __future__ import annotations

import numpy as np

_LAZY = ("cache_len_for", "decode_step", "forward", "init_cache",
         "init_params", "loss_fn", "param_count", "param_shapes", "prefill")


def __getattr__(name):
    if name in _LAZY:
        from . import transformer
        return getattr(transformer, name)
    if name in ("layers", "rglru", "ssm", "transformer"):
        import importlib
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _resolve(device):
    from ..api import resolve_device
    return resolve_device(device)


def batch_spec(cfg, shape) -> dict:
    """Meta-tensor stand-ins (the reference's ``ShapeDtypeStruct``s) for
    every model input of this cell."""
    import torch

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": spec((B,), i32)}
    s_text = S - cfg.n_patches if cfg.n_patches else S
    out = {"tokens": spec((B, s_text), i32)}
    if shape.kind == "train":
        out["labels"] = spec((B, s_text), i32)
    if cfg.n_patches:
        out["patch_embeds"] = spec((B, cfg.n_patches, cfg.d_model),
                                   cfg.tdtype)
    if cfg.enc_dec:
        out["frames"] = spec((B, cfg.enc_frames, cfg.d_model), cfg.tdtype)
    return out


def _float_tensor(a: np.ndarray, dtype, device):
    """A float64 draw as ``dtype`` on ``device``, rounded through float32
    (as ``jnp.asarray`` rounds it with 64-bit mode off)."""
    import torch
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        device=device, dtype=dtype)


def make_batch(cfg, *, batch: int, seq: int, kind: str, seed: int = 0,
               device=None) -> dict:
    """Concrete synthetic batch (smoke tests / examples), the reference's
    numpy draws in its order, so the two packages' batches agree bit for
    bit.  The audio/vision frontends are stubs: frames/patch embeddings
    are generated directly.  On the card unless ``device`` says
    otherwise."""
    import torch
    device = _resolve(device)
    rng = np.random.default_rng(seed)

    def ints(shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(
            np.int32)).to(device)

    if kind == "decode":
        return {"tokens": ints((batch,))}
    s_text = seq - cfg.n_patches if cfg.n_patches else seq
    out = {"tokens": ints((batch, s_text))}
    if kind == "train":
        out["labels"] = ints((batch, s_text))
    if cfg.n_patches:
        out["patch_embeds"] = _float_tensor(
            rng.standard_normal((batch, cfg.n_patches, cfg.d_model)) * 0.02,
            cfg.tdtype, device)
    if cfg.enc_dec:
        out["frames"] = _float_tensor(
            rng.standard_normal((batch, cfg.enc_frames, cfg.d_model)) * 0.02,
            cfg.tdtype, device)
    return out


def params_from_numpy(tree, *, device=None, dtype=None):
    """A nest of dicts of numpy arrays (a reference parameter or cache
    tree after ``jax.device_get``) as the same nest of tensors on
    ``device`` (the card unless it says otherwise).  Each leaf keeps its
    dtype, or takes ``dtype`` where it is floating.  numpy ``bfloat16``
    leaves (``ml_dtypes``, which ``torch.from_numpy`` rejects) go through
    float32, which holds them exactly."""
    import torch
    device = _resolve(device)

    def leaf(a):
        a = np.asarray(a)
        bf16 = a.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(a.astype(np.float32) if bf16 else a))
        if bf16:
            t = t.to(torch.bfloat16)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return leaf(x)

    return walk(tree)


__all__ = ["batch_spec", "cache_len_for", "decode_step", "forward",
           "init_cache", "init_params", "layers", "loss_fn", "make_batch",
           "param_count", "param_shapes", "params_from_numpy", "prefill",
           "rglru", "ssm", "transformer"]
