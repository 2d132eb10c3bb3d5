"""The training data pipeline (a copy of ``repro.data``)."""

from .pipeline import PrefetchLoader, SyntheticLMData

__all__ = ["PrefetchLoader", "SyntheticLMData"]
