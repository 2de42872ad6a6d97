"""``import codo_torch`` — alias for :mod:`repro_torch.api`, the PyTorch
port of the ``codo`` frontend (``src/codo.py``):

.. code-block:: python

    import codo_torch

    def model(x):
        h = codo_torch.F.fc(x, 512, relu=True)
        return codo_torch.F.fc(h, 512) + x

    program = codo_torch.compile(model, (64, 512))            # on the card
    y = program(x_tensor)
    cpu = codo_torch.compile(model, (64, 512), device="cpu")  # on the CPU

    step = codo_torch.compile(loss_fn, (64, 512), (64, 512), grad=True)
    params, state, metrics = step.step(params, state, x, target)
"""

from repro_torch.api import (CodoOptions, CompiledProgram,  # noqa: F401
                             CompiledTrainStep, F, ShapedBuffer, TraceError,
                             buffer, compile, load, params_from_numpy, trace,
                             train_state_from_numpy)

__all__ = ["CodoOptions", "CompiledProgram", "CompiledTrainStep", "F",
           "ShapedBuffer", "TraceError", "buffer", "compile", "load",
           "params_from_numpy", "trace", "train_state_from_numpy"]
