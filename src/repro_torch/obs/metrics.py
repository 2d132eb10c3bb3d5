"""Pull-style metrics registry for the serving runtime.

All values are integers in *simulated cycles* (or dimensionless counts) —
never wall-clock.  ``CmServer`` populates a registry while serving;
``ServeReport``, ``load_sweep`` and the benchmarks pull from
``snapshot()`` instead of threading ad-hoc dicts around.

Three instrument kinds, deliberately minimal:

* :class:`Counter` — monotonically increasing int (``inc``).
* :class:`Gauge` — last-write-wins int (``set``).
* :class:`Histogram` — stores exact observations (cycle counts are small
  ints; runs are bounded by ``max_cycles``), so percentiles are computed
  exactly with the same nearest-rank rule ``ServeReport.percentile`` has
  always used — no bucketing error.

Port copy of ``repro.obs.metrics``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def set(self, v: int) -> None:
        self.value = int(v)


class Histogram:
    """Exact-observation histogram over integer cycle values."""

    __slots__ = ("values",)

    def __init__(self) -> None:
        self.values: List[int] = []

    def observe(self, v: int) -> None:
        self.values.append(int(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def total(self) -> int:
        return sum(self.values)

    def percentile(self, q: float) -> int:
        """Nearest-rank percentile (matches ``ServeReport.percentile``)."""
        if not self.values:
            return 0
        vs = sorted(self.values)
        idx = min(len(vs) - 1, max(0, int(round(q / 100.0 * (len(vs) - 1)))))
        return vs[idx]

    def summary(self) -> Dict[str, int]:
        return {"count": self.count, "total": self.total,
                "p50": self.percentile(50), "p99": self.percentile(99),
                "max": max(self.values) if self.values else 0}


class MetricsRegistry:
    """Named counters/gauges/histograms with a deterministic snapshot."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram()
        return h

    def snapshot(self) -> Dict[str, Any]:
        """Nested plain-dict view, keys sorted — JSON-stable."""
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._histograms.items())},
        }

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, indent=2)
