"""LM serving: port of ``repro.serve`` (a batched engine and a continuous
batcher over the dense LMs of ``repro_torch.models``)."""

from ..runtime.runtime import Request
from .engine import ServeEngine
from .scheduler import ContinuousBatcher

__all__ = ["ContinuousBatcher", "Request", "ServeEngine"]
