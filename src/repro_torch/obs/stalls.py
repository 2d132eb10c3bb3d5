"""Stall attribution: every idle core-cycle classified into a closed taxonomy.

The observability contract: when ``Simulator.run(..., stalls=True)``
is requested, every cycle of every resident core over the whole run
``[0, SimStats.cycles)`` falls into exactly one bucket — it executed an
iteration (``busy``) or it idled for exactly one *attributed* reason:

``dep-wait:<value>:p<src>``
    The core's next iteration waits on the LCU frontier of ``<value>`` fed
    by producer partition ``<src>`` (one bucket per producer replica — a
    consumer of a k-replicated value holds k frontiers and the blocking one
    is named).  On the sequential schedule the producer-completion gate
    reports through the same key.
``gcu-starved``
    Waiting on the GCU: either the input-stream frontier (src partition -1)
    has not delivered the next needed pixel, or the core has no current
    image because the GCU is still streaming some other image / no request
    of its tenant has arrived yet.
``link-delay``
    The blocking frontier's unlocking data is *on the wire*: a cross-chip
    (or fault-degraded) message to this frontier was sent but needs more
    than the paper's one-cycle hop (``sent < t < arrive``).  Under healthy
    intra-chip links this is structurally zero — transfer takes exactly one
    cycle, which is charged to the producer as ``dep-wait``.
``inflight-bound``
    The core has no image and the GCU is idle with an *arrived* candidate it
    may not admit because ``max_inflight`` started-but-incomplete images are
    outstanding — the admission bound, not the stream rate, is binding.
``dead`` / ``failed``
    Fault taxonomy: the core is past its injected death cycle / its current
    image was deadline-failed and the cycle is spent on a doomed request.
``drained``
    No remaining work: every image of the core's tenant has been started or
    failed and the core finished all of its assigned ones (includes the
    natural pipeline tail).
``dpu-busy``
    Reserved.  The simulator's core model issues the crossbar MxV *and* the
    full DPU instruction sequence within the one-cycle iteration (paper
    §2), so a core is never stalled behind its own DPU; the category is
    part of the closed taxonomy for forward compatibility with a split
    crossbar/DPU timing model and is always 0 today.

Accounting identity (checked by :meth:`StallBreakdown.check`): per core,
``busy + sum(stall categories) == SimStats.cycles`` — exact, both engines.

Everything in this module is engine-agnostic and pure (numpy only): the
reference engine classifies per cycle inline (the oracle), the event engine
reconstructs the identical breakdown from its frontier ramps and stream
logs, and both meet here for the shared taxonomy + the GCU-side
classification predicate so the two code paths cannot drift.

Port copy of ``repro.obs.stalls``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

INF_CYCLE = 1 << 62

DEAD = "dead"
FAILED = "failed"
DRAINED = "drained"
GCU_STARVED = "gcu-starved"
INFLIGHT_BOUND = "inflight-bound"
LINK_DELAY = "link-delay"
DPU_BUSY = "dpu-busy"              # reserved: structurally 0 (see module doc)
DEP_WAIT = "dep-wait"

#: The closed taxonomy (dep-wait expands to one key per value/producer).
CATEGORIES = (DEP_WAIT, GCU_STARVED, LINK_DELAY, DPU_BUSY, INFLIGHT_BOUND,
              DEAD, FAILED, DRAINED)


def dep_key(value: str, src_part: int) -> str:
    """Bucket name for a frontier/gate wait on ``value`` from ``src_part``.

    The GCU input stream (producer partition -1) is GCU starvation, not a
    core dependency."""
    if src_part == -1:
        return GCU_STARVED
    return f"{DEP_WAIT}:{value}:p{src_part}"


def in_flight(intervals: Optional[Sequence[Tuple[int, int]]], t: int) -> bool:
    """Is some delayed message of this frontier on the wire at cycle ``t``?

    ``intervals`` holds (send, arrive) pairs recorded ONLY for messages whose
    flight exceeds the paper's one-cycle hop (cross-chip transfer delay or a
    fault-degraded link); membership is the open interval ``send < t <
    arrive`` so the normal hop never counts.  Both engines record the same
    message set, so the predicate is engine-invariant by construction."""
    if not intervals:
        return False
    return any(s < t < a for s, a in intervals)


def classify_unassigned(t: int, tenant: int, n_images: int,
                        arrivals: Sequence[int], tenants: Sequence[int],
                        gcu_start: Dict[int, int],
                        gcu_send_end: Dict[int, int],
                        failed_cycle: Dict[int, int]) -> str:
    """Classify an idle cycle of a core with *no current image*.

    Shared by both engines (the reference calls it per cycle with its
    so-far dicts, the event engine post hoc with the final dicts — every
    predicate filters by ``<= t``, so the two views agree exactly).

    * no unstarted, unfailed image of the core's tenant remains -> DRAINED
      (the core's work is over; the pipeline is draining or empty);
    * otherwise, if the GCU is idle at ``t`` yet an arrived, unstarted,
      unfailed candidate (any tenant) exists, admission must be blocked on
      the in-flight bound -> INFLIGHT_BOUND (the reference admits whenever
      idle + candidate + below bound, so idleness with a candidate implies
      the bound binds);
    * otherwise the core waits on the GCU stream (busy with another image,
      or no candidate has arrived yet) -> GCU_STARVED.
    """
    pending = False
    candidate = False
    for i in range(n_images):
        if gcu_start.get(i, INF_CYCLE) > t \
                and failed_cycle.get(i, INF_CYCLE) > t:
            if tenants[i] == tenant:
                pending = True
            if arrivals[i] <= t:
                candidate = True
    if not pending:
        return DRAINED
    streaming = any(s <= t <= gcu_send_end[i]
                    for i, s in gcu_start.items() if s <= t)
    if not streaming and candidate:
        return INFLIGHT_BOUND
    return GCU_STARVED


@dataclasses.dataclass
class StallBreakdown:
    """Per-core, per-category idle-cycle attribution of one run.

    ``cycles`` is the run length (``SimStats.cycles``); ``busy[c]`` the
    executed cycles of core ``c``; ``stalls[c]`` maps taxonomy buckets to
    idle cycles; ``stage_of_core`` names each core's pipeline stage (the
    replica-group leader's first node, ``t<k>:``-prefixed when
    multi-tenant); ``gcu_busy`` counts the cycles the shared GCU DMA spent
    streaming input pixels."""

    cycles: int
    busy: Dict[int, int]
    stalls: Dict[int, Dict[str, int]]
    stage_of_core: Dict[int, str]
    gcu_busy: int = 0

    def check(self) -> None:
        """Assert the exact accounting identity, per core."""
        for cid in self.stalls:
            total = self.busy.get(cid, 0) + sum(self.stalls[cid].values())
            if total != self.cycles:
                raise AssertionError(
                    f"core {cid}: busy {self.busy.get(cid, 0)} + stalls "
                    f"{dict(self.stalls[cid])} = {total} != run cycles "
                    f"{self.cycles}")

    def total(self, category: str) -> int:
        """Summed cycles of one bucket (exact key) across all cores."""
        return sum(s.get(category, 0) for s in self.stalls.values())

    def by_stage(self) -> Dict[str, Dict[str, int]]:
        """Roll cores up into stages; replicas of one stage aggregate.

        Each stage dict carries ``busy`` plus the stall buckets (summed
        over the stage's cores)."""
        out: Dict[str, Dict[str, int]] = {}
        for cid, cats in self.stalls.items():
            stage = self.stage_of_core.get(cid, f"core{cid}")
            agg = out.setdefault(stage, {"busy": 0})
            agg["busy"] += self.busy.get(cid, 0)
            for cat, n in cats.items():
                agg[cat] = agg.get(cat, 0) + n
        return out

    def table(self) -> str:
        """Human-readable per-core breakdown (categories as columns)."""
        cats: List[str] = sorted({c for s in self.stalls.values() for c in s})
        head = (f"{'core':>5} {'stage':>14} {'busy':>7} "
                + " ".join(f"{c:>18}" for c in cats))
        lines = [head]
        for cid in sorted(self.stalls):
            row = self.stalls[cid]
            lines.append(
                f"{cid:>5} {self.stage_of_core.get(cid, '?'):>14} "
                f"{self.busy.get(cid, 0):>7} "
                + " ".join(f"{row.get(c, 0):>18}" for c in cats))
        lines.append(f"total cycles={self.cycles}  gcu_busy={self.gcu_busy}")
        return "\n".join(lines)
