"""Workload builders of the PyTorch port (see :mod:`.dataflow_models`)."""
