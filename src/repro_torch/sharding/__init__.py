"""Sharding rules of the port: per parameter name, batch and cache key, the
reference's PartitionSpec as a tuple of axis names, and its DTensor
placements.  Port of ``repro.sharding``."""

from .rules import (abstract_model, batch_axes, batch_specs, cache_specs,
                    opt_specs, param_specs, placements)

__all__ = ["abstract_model", "batch_axes", "batch_specs", "cache_specs",
           "opt_specs", "param_specs", "placements"]
