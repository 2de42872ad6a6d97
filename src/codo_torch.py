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
"""

from repro_torch.api import (CodoOptions, CompiledProgram, F,  # noqa: F401
                             ShapedBuffer, TraceError, buffer, compile, load,
                             params_from_numpy, trace)

__all__ = ["CodoOptions", "CompiledProgram", "F", "ShapedBuffer",
           "TraceError", "buffer", "compile", "load", "params_from_numpy",
           "trace"]
