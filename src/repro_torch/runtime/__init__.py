"""Request-level CM serving runtime (arrival-driven, multi-tenant).

``CmServer`` + seeded arrival processes turn the cycle-accurate simulator
into a serving testbed: latency percentiles under open-loop load sweeps,
closed-loop think-time populations, FIFO/priority admission with bounded
in-flight images, and weight-stationary multi-tenant co-residency via
``core.place_tenants``.

Port copy of ``repro.runtime``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from .runtime import (CmRequest, CmServer, Request, ServeReport,
                      load_sweep, split_stats)
from .workload import (ClosedLoopClients, poisson_arrivals, rate_sweep,
                       uniform_arrivals)

__all__ = [
    "CmRequest", "CmServer", "Request", "ServeReport", "load_sweep", "split_stats",
    "ClosedLoopClients", "poisson_arrivals", "rate_sweep",
    "uniform_arrivals",
]
# fault injection + recovery live in repro_torch.faults (FaultSchedule,
# RetryPolicy, remap_program); CmServer takes them via faults=/retry=.
