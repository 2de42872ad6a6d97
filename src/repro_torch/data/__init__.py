"""repro_torch.data — the deterministic synthetic LM data pipeline
(:mod:`~repro_torch.data.pipeline`), numpy batches."""

from .pipeline import DataConfig, Prefetcher, SyntheticLM

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM"]
