"""LM serving: port of ``repro.serve`` (a batched engine over every model
family of ``repro_torch.models``, and a continuous batcher over the
token-prompt families)."""

from ..runtime.runtime import Request
from .engine import ServeEngine
from .scheduler import ContinuousBatcher

__all__ = ["ContinuousBatcher", "Request", "ServeEngine"]
