"""The port's pipeline executor (``repro_torch.core.pipeline``) on a
("stage", 4) debug mesh of the CPU, against its own serial oracle (bit
for bit) and the reference's ``reference_serial``, on the reference
example's 4-stage MLP (``examples/pipeline_parallel.py``: D=32, eight
microbatches of four rows, ``tanh(x·w + b)``, w ~ 0.5·N(0, 1), b = 0),
with seeded numpy inputs in both packages.  Against the reference the band
is the port's documented one for transcendental kinds (rtol 1e-6 / atol
2e-6, ``tests/test_torch_ops.py``): torch's and XLA's ``tanh`` and
float32 products differ in the last bits, by 1.3e-6–1.8e-6 over the four
stages on these seeds, serial run against serial run."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro_torch.core.pipeline import (PipelineSchedule,  # noqa: E402
                                       pipeline_fn, reference_serial)
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402

D, NMB, MB, STAGES = 32, 8, 4, 4


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _ref_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return ({"w": (rng.standard_normal((STAGES, D, D)) * 0.5
                   ).astype(np.float32),
             "b": np.zeros((STAGES, D), np.float32)},
            rng.standard_normal((NMB, MB, D)).astype(np.float32))


def _torch(params, x):
    return ({k: torch.as_tensor(v) for k, v in params.items()},
            torch.as_tensor(x))


@pytest.mark.parametrize("seed", [0, 1])
def test_pipeline_is_bit_for_bit_the_serial_run(seed):
    params, x = _torch(*_arrays(seed))
    mesh = make_debug_mesh((STAGES,), ("stage",), device="cpu")
    y = pipeline_fn([_stage] * STAGES, mesh)(params, x)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert torch.equal(y, reference_serial([_stage] * STAGES, params, x))


def test_pipeline_within_the_transcendental_band_of_the_reference():
    arrays, x = _arrays()
    params, xt = _torch(arrays, x)
    mesh = make_debug_mesh((STAGES,), ("stage",), device="cpu")
    y = pipeline_fn([_stage] * STAGES, mesh)(params, xt)
    want = ref_pipeline.reference_serial(
        [_ref_stage] * STAGES, {k: jnp.asarray(v) for k, v in arrays.items()},
        jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-6,
                               atol=2e-6)


def test_pipeline_takes_distinct_stage_functions_on_a_2d_mesh():
    """Stages may differ; on a mesh with another axis the stages are the
    positions at coordinate 0 of it."""
    params, x = _torch(*_arrays(2))
    fns = [_stage, lambda p, h: _stage(p, h) * 2.0, _stage,
           lambda p, h: h + p["b"]]
    mesh = make_debug_mesh((2, STAGES), ("data", "stage"), device="cpu")
    y = pipeline_fn(fns, mesh)(params, x)
    assert torch.equal(y, reference_serial(fns, params, x))
    with pytest.raises(ValueError, match="stage functions"):
        pipeline_fn(fns[:3], mesh)


@pytest.mark.parametrize("stages, nmb", [(4, 8), (1, 5), (8, 2)])
def test_schedule_ticks_and_bubble_match_the_reference(stages, nmb):
    ours = PipelineSchedule(num_stages=stages, num_microbatches=nmb)
    theirs = ref_pipeline.PipelineSchedule(num_stages=stages,
                                           num_microbatches=nmb)
    assert ours.ticks == theirs.ticks == nmb + stages - 1
    assert ours.bubble_fraction == theirs.bubble_fraction
