"""Deterministic fault schedules for the CM simulator.

A :class:`FaultSchedule` is a *timeline*, not a random process: every fault
names the exact cycle it takes effect, so a degraded run is as replayable as
a healthy one — both simulator engines honor the same schedule and must stay
bit-identical on every counter (``tests/test_faults.py``).  Randomness lives
only in :func:`sample_schedule`, which draws a schedule from seeded fault
*rates* once, up front; after that the simulation is deterministic.

Fault kinds (the characteristic analog-CM failure modes, PAPERS.md):

``CoreFault``
    The core executes no iteration at any cycle >= ``cycle``.  Its pipeline
    stage stalls; downstream consumers starve and the affected requests are
    detected via deadlines (``Simulator.run(deadlines=...)``), never
    simulated forever.

``LinkFault``
    From ``cycle`` on, the inter-chip link is ``down`` (messages sent while
    down are dropped, deterministically, in both engines) or *degraded*
    (``latency_add`` extra wire cycles, ``width_shrink`` dividing the bytes
    moved per cycle).  The parameters in effect for a message are those at
    its **send cycle**.  Faults only ever degrade (validated), so message
    arrival order per stream is preserved — the property the event engine's
    frontier ramps rely on.

Crossbar-level faults (stuck cells, conductance drift) are value faults, not
timing faults: they ride the compute plane via :class:`repro_torch.faults.planes.
FaultyPlane` and never appear in this timeline.

Port copy of ``repro.faults.schedule``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.hwspec import LinkSpec


@dataclasses.dataclass(frozen=True)
class CoreFault:
    """Core ``core`` is dead (executes nothing) from ``cycle`` on."""

    core: int
    cycle: int

    def __post_init__(self):
        if self.core < 0:
            raise ValueError(f"core must be >= 0, got {self.core}")
        if self.cycle < 0:
            raise ValueError(f"fault cycle must be >= 0, got {self.cycle}")


@dataclasses.dataclass(frozen=True)
class LinkFault:
    """Inter-chip link (src_chip, dst_chip) fails or degrades at ``cycle``.

    ``down=True`` drops every message sent at cycles >= ``cycle``.
    Otherwise the link keeps working with ``latency_add`` extra cycles of
    wire latency and its per-cycle width divided by ``width_shrink``.
    Degradations stack across faults on the same link (cycle order).
    """

    src_chip: int
    dst_chip: int
    cycle: int
    down: bool = False
    latency_add: int = 0
    width_shrink: int = 1

    def __post_init__(self):
        if self.cycle < 0:
            raise ValueError(f"fault cycle must be >= 0, got {self.cycle}")
        if self.latency_add < 0:
            raise ValueError("latency_add must be >= 0 (faults only "
                             f"degrade), got {self.latency_add}")
        if self.width_shrink < 1:
            raise ValueError("width_shrink must be >= 1 (faults only "
                             f"degrade), got {self.width_shrink}")

    @property
    def key(self) -> Tuple[int, int]:
        return (self.src_chip, self.dst_chip)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An immutable, fully deterministic fault timeline."""

    core_faults: Tuple[CoreFault, ...] = ()
    link_faults: Tuple[LinkFault, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "core_faults", tuple(self.core_faults))
        object.__setattr__(self, "link_faults", tuple(self.link_faults))

    def is_empty(self) -> bool:
        return not self.core_faults and not self.link_faults

    # ---------------------------------------------------------------- cores
    def dead_at(self) -> Dict[int, int]:
        """Earliest death cycle per faulted core."""
        out: Dict[int, int] = {}
        for f in self.core_faults:
            if f.core not in out or f.cycle < out[f.core]:
                out[f.core] = f.cycle
        return out

    def dead_cores(self, by_cycle: int = None) -> frozenset:
        """Cores dead at or before ``by_cycle`` (all faulted cores when
        ``by_cycle`` is None) — what a detector at that cycle can know."""
        da = self.dead_at()
        if by_cycle is None:
            return frozenset(da)
        return frozenset(c for c, d in da.items() if d <= by_cycle)

    # ---------------------------------------------------------------- links
    def link_keys(self) -> frozenset:
        return frozenset(f.key for f in self.link_faults)

    def link_timeline(self, key: Tuple[int, int], base: LinkSpec):
        """Piecewise link state: ``(breaks, states)`` with ``states[i]``
        (a ``(down, LinkSpec)`` pair) in effect for send cycles in
        ``[breaks[i-1], breaks[i])`` (``states[0]`` from cycle 0).  Faults
        on the same link compose cumulatively in cycle order; ``down`` is
        sticky.
        """
        faults = sorted((f for f in self.link_faults if f.key == key),
                        key=lambda f: f.cycle)
        breaks: List[int] = []
        states: List[Tuple[bool, LinkSpec]] = [(False, base)]
        for f in faults:
            down, spec = states[-1]
            down = down or f.down
            spec = spec.degraded(f.latency_add, f.width_shrink)
            if breaks and breaks[-1] == f.cycle:
                states[-1] = (down, spec)     # same-cycle faults merge
            else:
                breaks.append(f.cycle)
                states.append((down, spec))
        return np.asarray(breaks, np.int64), states

    def link_state(self, key: Tuple[int, int], cycle: int,
                   base: LinkSpec) -> Tuple[bool, LinkSpec]:
        """(down, effective LinkSpec) for a message sent at ``cycle``."""
        breaks, states = self.link_timeline(key, base)
        return states[int(np.searchsorted(breaks, cycle, side="right"))]


def sample_schedule(n_cores: int, horizon: int,
                    core_fault_rate: float = 0.0,
                    links: Sequence[Tuple[int, int]] = (),
                    link_fault_rate: float = 0.0,
                    link_latency_add: int = 8,
                    link_width_shrink: int = 2,
                    seed: int = 0) -> FaultSchedule:
    """Draw a :class:`FaultSchedule` from seeded per-element fault rates.

    Each core dies with probability ``core_fault_rate`` at a uniform cycle
    in ``[horizon // 4, horizon)``; each listed link degrades with
    probability ``link_fault_rate`` likewise.  All randomness is consumed
    here — the resulting schedule (and therefore the degraded run) is
    deterministic.
    """
    for name, rate in (("core_fault_rate", core_fault_rate),
                       ("link_fault_rate", link_fault_rate)):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"{name} must be in [0, 1], got {rate}")
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    rng = np.random.default_rng(seed)
    lo = horizon // 4
    core_faults = []
    for c in range(n_cores):
        if rng.random() < core_fault_rate:
            core_faults.append(
                CoreFault(core=c, cycle=int(rng.integers(lo, horizon))))
    link_faults = []
    for (a, b) in links:
        if rng.random() < link_fault_rate:
            link_faults.append(LinkFault(
                src_chip=a, dst_chip=b,
                cycle=int(rng.integers(lo, horizon)),
                latency_add=link_latency_add,
                width_shrink=link_width_shrink))
    return FaultSchedule(core_faults=tuple(core_faults),
                         link_faults=tuple(link_faults))
