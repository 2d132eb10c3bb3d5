"""Critical-path analysis: name the binding pipeline resource of a run.

``critical_path(stats)`` ranks every resource a run exercised — each
pipeline stage (max busy cycles over its replica cores: replicas run in
parallel, so the slowest replica bounds the stage), the shared GCU input
stream, and each mesh link — and names the most-occupied one.  On a
steady-state pipelined run the most-occupied resource is the one whose
service time sets the iteration interval, i.e. exactly the stage
``plan_replication``'s static cost model targets; ``static_bottleneck``
re-derives that prediction from the partition graph so tests can
cross-check the dynamic measurement against the static pick.

No module-level ``repro_torch.core`` imports: ``repro_torch.core.__init__`` pulls in
the simulator, which imports this package — partition helpers are imported
inside the functions that need them.

Port copy of ``repro.obs.critical``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

_KIND_RANK = {"stage": 0, "gcu": 1, "link": 2}


@dataclasses.dataclass
class CriticalPath:
    """Ranked resource occupancy of one run; ``bottleneck`` is rank 0."""

    kind: str                      # "stage" | "gcu" | "link"
    name: str                      # stage anchor, "gcu-stream", or "a->b"
    busy: int                      # occupied cycles of the binding resource
    cycles: int                    # run length
    ranking: List[Tuple[str, str, int]]   # (kind, name, busy), descending

    @property
    def utilization(self) -> float:
        return self.busy / self.cycles if self.cycles else 0.0

    def table(self) -> str:
        lines = [f"{'rank':>4} {'kind':>6} {'resource':>22} {'busy':>9} "
                 f"{'util':>6}"]
        for r, (kind, name, busy) in enumerate(self.ranking):
            u = busy / self.cycles if self.cycles else 0.0
            lines.append(f"{r:>4} {kind:>6} {name:>22} {busy:>9} {u:>6.2f}")
        return "\n".join(lines)


def critical_path(stats: Any) -> CriticalPath:
    """Name the binding stage/link/GCU segment of a finished run.

    Requires ``stats.stalls`` (run with ``stalls=True``) for the stage ->
    core mapping and the GCU busy count.  Ties break deterministically:
    stage before GCU before link, then lexicographic name."""
    sb = stats.stalls
    if sb is None:
        raise ValueError(
            "critical_path needs stall attribution: run the simulator "
            "with stalls=True")
    stage_busy: Dict[str, int] = {}
    for cid, b in sb.busy.items():
        stage = sb.stage_of_core.get(cid, f"core{cid}")
        stage_busy[stage] = max(stage_busy.get(stage, 0), b)

    cands: List[Tuple[str, str, int]] = [
        ("stage", name, busy) for name, busy in stage_busy.items()]
    cands.append(("gcu", "gcu-stream", sb.gcu_busy))
    for key, ls in stats.links.items():
        cands.append(("link", f"{key[0]}->{key[1]}", int(ls.busy)))

    cands.sort(key=lambda c: (-c[2], _KIND_RANK[c[0]], c[1]))
    kind, name, busy = cands[0]
    return CriticalPath(kind=kind, name=name, busy=busy,
                        cycles=sb.cycles, ranking=cands)


def propose_moves(cp: CriticalPath, max_moves: int = 3
                  ) -> List[Tuple[str, str]]:
    """Ranked move targets for a design-space search: up to ``max_moves``
    distinct ``(kind, name)`` pairs from the occupancy ranking, most-binding
    first.  This is the dynamic counterpart of attacking
    ``static_bottleneck``'s pick — a tuner replicates a named ``stage``
    (the name is the stage anchor, usable directly as a
    ``replicate={anchor: k}`` key), re-cuts or re-links around a named
    ``link``, and treats ``gcu`` as the signal that the input stream — not
    any stage — binds, so replication moves are wasted there.  Tenant
    prefixes (``t<k>:``) are stripped so stage names match graph node
    names.  Zero-busy resources are never proposed."""
    out: List[Tuple[str, str]] = []
    seen = set()
    for kind, name, busy in cp.ranking:
        if busy <= 0:
            break  # ranking is busy-descending: nothing left to attack
        if kind == "stage" and ":" in name:
            name = name.split(":", 1)[1]
        if (kind, name) in seen:
            continue
        seen.add((kind, name))
        out.append((kind, name))
        if len(out) >= max_moves:
            break
    return out


def static_bottleneck(pg: Any,
                      dma_pixels_per_cycle: Optional[int] = None) -> str:
    """``plan_replication``'s view of the same question: which stage's
    per-image service time (``ceil(iterations / replica count)``) bounds
    the pipeline, or ``"gcu-stream"`` when the input-streaming floor does.
    Returns the stage anchor (its leader partition's first node name) —
    comparable to ``critical_path(...).name``.

    One deliberate asymmetry vs the measurement: the static floor counts
    every element of the input tensor (C*H*W, mirroring
    ``plan_replication``), while the simulated GCU streams H*W pixels per
    image, so for C > 1 inputs the static model over-weights the stream.
    On balanced pipelines this can make the static pick ``"gcu-stream"``
    where ``critical_path`` names a stage tied at the same busy count —
    cross-checks should compare occupancy, not just the name, under
    ties."""
    from ..core.partition import GCU_PARTITION, partition_iterations

    g = pg.graph
    floor = 1
    if dma_pixels_per_cycle and g.inputs:
        pixels = 1
        for x in g.values[g.inputs[0]].shape:
            pixels *= int(x)
        floor = max(1, -(-pixels // int(dma_pixels_per_cycle)))

    best_name, best_svc = "gcu-stream", floor
    for p in pg.partitions:
        if p.idx == GCU_PARTITION:
            continue
        if p.repl_group is not None and p.repl_group != p.idx:
            continue  # replica group: count the leader once
        svc = -(-partition_iterations(pg, p) // p.repl_k)
        if svc > best_svc:  # ties keep the GCU / the earlier stage
            best_name, best_svc = p.nodes[0].name, svc
    return best_name
