"""The autotuner's design space: candidate configurations and axis bounds.

A candidate is a :class:`TuneConfig` — one point in the cross product of
the search axes the compiler exposes:

  * ``replicate`` — per-stage replica factors (``compile_model``'s
    round-robin ``i mod k`` split), stored as a *sorted* tuple of
    ``(anchor, k)`` pairs so equal plans hash equal;
  * ``chips`` / ``topology`` — mesh scale-out: how many chips and which
    chip-level link topology (``make_mesh``);
  * ``chip_cuts`` — explicit contiguous cut boundaries for
    ``partition_chips(cuts=)``, overriding the byte-minimizing DP;
  * ``tenant_order`` — the placement permutation ``place_tenants`` packs
    co-resident models in (multi-model workloads only).

Configs are frozen/hashable (the search dedupes against a seen-set) and
round-trip through plain-JSON dicts with sorted keys, which is what makes
the committed ``configs/tuned/*.json`` artifacts byte-reproducible.

:class:`SearchSpace` bounds the axes and fixes the funnel widths (batch
per round, simulation shortlist).  It is recorded verbatim in the tuned
artifact so a reproduction run searches the identical space.

Port copy of ``repro.tune.space``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_tune.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """One candidate compiler configuration (see module docstring)."""

    replicate: Tuple[Tuple[str, int], ...] = ()
    chips: int = 1
    topology: str = "chain"
    chip_cuts: Optional[Tuple[int, ...]] = None
    tenant_order: Optional[Tuple[int, ...]] = None

    def replicate_plan(self) -> Dict[str, int]:
        """The plan dict ``compile_model(replicate=)`` consumes."""
        return dict(self.replicate)

    def with_replica(self, anchor: str, k: int) -> "TuneConfig":
        """This config with ``anchor``'s replica factor set to ``k``
        (``k <= 1`` removes the entry)."""
        plan = self.replicate_plan()
        if k <= 1:
            plan.pop(anchor, None)
        else:
            plan[anchor] = int(k)
        return dataclasses.replace(self, replicate=plan_key(plan))

    def key(self) -> str:
        """Compact canonical label (trajectory rows, tie-breaking)."""
        parts = []
        if self.replicate:
            parts.append("repl[" + ",".join(
                f"{a}x{k}" for a, k in self.replicate) + "]")
        if self.chips != 1:
            parts.append(f"chips{self.chips}:{self.topology}")
        if self.chip_cuts is not None:
            parts.append("cuts(" + ",".join(map(str, self.chip_cuts)) + ")")
        if self.tenant_order is not None:
            parts.append("order(" + ",".join(map(str, self.tenant_order))
                         + ")")
        return "+".join(parts) if parts else "base"

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "replicate": {a: k for a, k in self.replicate},
            "chips": self.chips,
            "topology": self.topology,
            "chip_cuts": (list(self.chip_cuts)
                          if self.chip_cuts is not None else None),
            "tenant_order": (list(self.tenant_order)
                             if self.tenant_order is not None else None),
        }

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "TuneConfig":
        return TuneConfig(
            replicate=plan_key(d.get("replicate") or {}),
            chips=int(d.get("chips", 1)),
            topology=str(d.get("topology", "chain")),
            chip_cuts=(tuple(int(c) for c in d["chip_cuts"])
                       if d.get("chip_cuts") is not None else None),
            tenant_order=(tuple(int(t) for t in d["tenant_order"])
                          if d.get("tenant_order") is not None else None),
        )


def plan_key(plan: Dict[str, int]) -> Tuple[Tuple[str, int], ...]:
    """Canonical (sorted, k>1 only) tuple form of a replication plan."""
    return tuple(sorted((str(a), int(k)) for a, k in plan.items()
                        if int(k) > 1))


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Axis bounds + funnel widths of one search (recorded in artifacts).

    ``max_repl_k`` caps per-stage replica factors (the per-stage iteration
    count caps them further); ``chip_counts`` / ``topologies`` bound the
    mesh axes (``(1,)`` keeps the search on the given chip).  ``batch`` is
    how many candidates one round considers, ``shortlist`` how many of the
    round's statically-ranked survivors are actually simulated, and
    ``explore_temp`` the starting annealing temperature (relative to the
    incumbent's cycle count) for accepting a worse simulated candidate as
    the next round's move base — 0 disables uphill acceptance.
    """

    max_repl_k: int = 8
    chip_counts: Tuple[int, ...] = (1,)
    topologies: Tuple[str, ...] = ("chain",)
    batch: int = 8
    shortlist: int = 3
    explore_temp: float = 0.05
    temp_decay: float = 0.5

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "max_repl_k": self.max_repl_k,
            "chip_counts": list(self.chip_counts),
            "topologies": list(self.topologies),
            "batch": self.batch,
            "shortlist": self.shortlist,
            "explore_temp": self.explore_temp,
            "temp_decay": self.temp_decay,
        }

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "SearchSpace":
        return SearchSpace(
            max_repl_k=int(d.get("max_repl_k", 8)),
            chip_counts=tuple(int(c) for c in d.get("chip_counts", (1,))),
            topologies=tuple(str(t) for t in d.get("topologies", ("chain",))),
            batch=int(d.get("batch", 8)),
            shortlist=int(d.get("shortlist", 3)),
            explore_temp=float(d.get("explore_temp", 0.05)),
            temp_decay=float(d.get("temp_decay", 0.5)),
        )


@dataclasses.dataclass(frozen=True)
class TuneWorkload:
    """What one candidate is costed on: ``n_images`` seeded random inputs
    (per tenant, round-robin interleaved on multi-model searches) run
    under ``schedule`` on the event engine; the score is
    ``SimStats.cycles``.  Seeded and wall-clock-free, so the score of a
    config is a pure function of (config, workload) — the determinism the
    committed-artifact contract rests on."""

    n_images: int = 4
    schedule: str = "pipelined"
    seed: int = 0

    def to_json_dict(self) -> Dict[str, Any]:
        return {"n_images": self.n_images, "schedule": self.schedule,
                "seed": self.seed}

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "TuneWorkload":
        return TuneWorkload(n_images=int(d.get("n_images", 4)),
                            schedule=str(d.get("schedule", "pipelined")),
                            seed=int(d.get("seed", 0)))
