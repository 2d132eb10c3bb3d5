"""The optimizer of the port's training (port of ``repro.optim``)."""

from .adamw import OptState, adamw_init, adamw_update, cosine_schedule

__all__ = ["OptState", "adamw_init", "adamw_update", "cosine_schedule"]
