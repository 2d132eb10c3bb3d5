"""Observability layer: stall attribution, timeline tracing,
and serving-runtime telemetry — always deterministic, zero-cost when off.

This package must stay importable without ``repro_torch.core`` (the simulator
imports it at module level); submodules therefore defer any
``repro_torch.core`` imports into function bodies.

Port copy of ``repro.obs``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from .critical import (CriticalPath, critical_path, propose_moves,
                       static_bottleneck)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .stalls import (CATEGORIES, DEAD, DEP_WAIT, DPU_BUSY, DRAINED, FAILED,
                     GCU_STARVED, INFLIGHT_BOUND, LINK_DELAY, StallBreakdown,
                     classify_unassigned, dep_key, in_flight)
from .trace import TraceRecorder

__all__ = [
    "CATEGORIES", "DEAD", "DEP_WAIT", "DPU_BUSY", "DRAINED", "FAILED",
    "GCU_STARVED", "INFLIGHT_BOUND", "LINK_DELAY",
    "Counter", "CriticalPath", "Gauge", "Histogram", "MetricsRegistry",
    "StallBreakdown", "TraceRecorder",
    "classify_unassigned", "critical_path", "dep_key", "in_flight",
    "propose_moves", "static_bottleneck",
]
