"""Token generation of the port (``repro_torch.serving.generator``) and
``serve --arch`` against the JAX reference, on the CPU.

For every catalog architecture at its ``smoke()`` config the reference
draws the parameters, ``params_from_numpy`` carries them across, and
both ``Generator``s serve the same seeded requests (more requests than
slots, so finished slots are refilled): the tokens of every request,
the decode steps and the tokens counted must be identical.  Then the
serve step on the CPU (eager, bit for bit ``decode_step``), the serving
CLI's ``--arch`` on the CPU and its default device, and the deprecated
aliases.  The decode step's CUDA graph runs only on the card
(``chip_smoke.py``'s LM phase).
"""

import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import models as RM  # noqa: E402
from repro.configs import CONFIGS as REF_CONFIGS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.serving import generator as ref_gen  # noqa: E402
from repro_torch import models as M  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import cli  # noqa: E402
from repro_torch.serving import generator as gen  # noqa: E402

ARCHS = sorted(REF_CONFIGS)


def _requests(module, cfg, n=5, prompt_len=4, max_new=4, seed=11):
    rng = np.random.default_rng(seed)
    return [module.Request(rid, prompt=list(rng.integers(1, cfg.vocab,
                                                         size=prompt_len)),
                           max_new=max_new) for rid in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_generator_tokens_match_reference(arch):
    rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    rp = RM.init_params(rcfg, jax.random.PRNGKey(3))
    tp = M.params_from_numpy(jax.device_get(rp), device="cpu")
    theirs = ref_gen.Generator(rcfg, rp, batch=2, cache_len=32)
    if rcfg.enc_dec:
        # The reference's encoder-decoder cache holds one array as both k
        # and v, which its donating step refuses ("donate the same buffer
        # twice"): its step runs undonated here, the same function.
        theirs.step_fn = jax.jit(ref_gen.build_serve_step(rcfg))
    ours = gen.Generator(cfg, tp, batch=2, cache_len=32)
    for g, module in ((theirs, ref_gen), (ours, gen)):
        for req in _requests(module, cfg):
            g.submit(req)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # XLA:CPU cannot donate buffers
        want = theirs.run(max_steps=31)
    got = ours.run(max_steps=31)
    assert [(r.rid, r.out) for r in got] == [(r.rid, r.out) for r in want]
    assert len(got) == 5
    assert (ours.steps, ours.tokens_out) == (theirs.steps, theirs.tokens_out)
    assert int(ours.cache["pos"]) == int(theirs.cache["pos"]) == ours.steps


def test_serve_step_on_the_cpu_is_decode_step():
    cfg = get_config("recurrentgemma-9b").smoke()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    step = gen.ServeStep(cfg, params, cache, batch=2)
    # Every env entry is bound: captured where it lies, never copied.
    assert step.program.bound == set(step.env)
    assert step.env["cache/pos"] is cache["pos"]
    plain = M.init_cache(cfg, 2, 16, device="cpu")
    toks = np.array([3, 9], np.int32)
    for _ in range(3):
        nxt, logits = step(toks)
        want, plain = M.decode_step(params, torch.from_numpy(toks), plain,
                                    cfg)
        assert torch.equal(logits, want)
        assert torch.equal(nxt, torch.argmax(want, -1).to(torch.int32))
        toks = nxt.numpy()
    assert step.program.graphs() == 0          # nothing captured on the CPU
    for a, b in zip(M.layers.tree_leaves(cache),
                    M.layers.tree_leaves(plain)):
        assert torch.equal(a, b)


def test_serve_arch_on_the_cpu(capsys):
    assert cli.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                     "--requests", "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "3/3 finished" in out and "tok/s on cpu" in out
    assert out.count("req ") == 3


def test_serve_arch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--arch", "gpt2-medium", "--smoke"])


@pytest.mark.parametrize("make", [
    lambda cfg: M.init_params(cfg, torch.Generator().manual_seed(0)),
    lambda cfg: M.init_cache(cfg, 2, 16),
    lambda cfg: M.layers.init_kv_cache(cfg, 2, 16, 1),
    lambda cfg: M.rglru.init_rglru_cache(cfg, 2, 1),
    lambda cfg: M.ssm.init_ssm_cache(cfg, 2, 1)],
    ids=["init_params", "init_cache", "init_kv_cache", "init_rglru_cache",
         "init_ssm_cache"])
def test_trees_default_to_the_card(monkeypatch, make):
    """A parameter tree or a cache with no device asked for goes to the
    card (and there is none here); the CPU only when asked for."""
    cfg = get_config("mamba2-780m").smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(cfg)


def test_captured_signature_keys_bound_entries_by_address():
    """A bound entry is captured where it lies, so the graph is keyed on
    its data pointer; a copied entry only on its layout."""
    from repro_torch.core.capture import _signature
    a, b = torch.zeros(4), torch.zeros(4)
    dev = torch.device("cuda")
    assert _signature(dev, {"x": a}) == _signature(dev, {"x": b})
    bound = frozenset({"x"})
    assert _signature(dev, {"x": a}, bound) != _signature(dev, {"x": b},
                                                          bound)
    assert _signature(dev, {"x": a}, bound) == _signature(dev, {"x": a},
                                                          bound)


@pytest.mark.parametrize("alias,names", [
    ("repro_torch.serving.serve", ("Generator", "Request",
                                   "build_serve_step")),
    ("repro_torch.launch.serve", ("main", "serve_lm", "InputError"))])
def test_deprecated_aliases_warn_and_reexport(alias, names):
    with pytest.warns(DeprecationWarning, match="deprecated"):
        module = importlib.reload(importlib.import_module(alias))
    for name in names:
        assert hasattr(module, name)
