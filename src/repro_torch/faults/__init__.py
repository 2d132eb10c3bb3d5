"""Deterministic fault injection + recovery for the CM stack.

``schedule``: seeded, replayable fault timelines (core death, link
down/degraded) honored bit-identically by both simulator engines.
``planes``: crossbar-level value faults (stuck cells, conductance drift,
Gaussian read noise) as ComputePlane wrappers.
``recovery``: retry backoff policy and mapping re-solve with failed cores
excluded, used by ``runtime.CmServer`` for graceful degradation.

Port copy of ``repro.faults``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from .planes import FaultyPlane
from .recovery import (RemapResult, RetryPolicy, remap_program,
                       trace_remap_events)
from .schedule import (CoreFault, FaultSchedule, LinkFault,
                       sample_schedule)

__all__ = [
    "CoreFault",
    "LinkFault",
    "FaultSchedule",
    "sample_schedule",
    "FaultyPlane",
    "RetryPolicy",
    "RemapResult",
    "remap_program",
    "trace_remap_events",
]
