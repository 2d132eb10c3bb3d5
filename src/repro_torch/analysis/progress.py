"""Pass 2 — deadlock-freedom / progress.

The runtime's only blocking constructs are the LCU admission gates: a
consumer core stalls an iteration until every dependency automaton's
frontier admits it (broadcast gates are the all-or-nothing special case,
and per-replica deps are a conjunction of k frontiers).  Statically that
induces a stage-level wait-for graph — consumer partition waits on
producer partition — which must be acyclic (the GCU input stream, stage
``-1``, waits on nothing and roots the order).  A cycle is a guaranteed
deadlock under the paper's dataflow execution: every stage in it holds
back the writes the next one needs (``wait-cycle``).

Acyclicity alone is not progress: a gate must also *lift* by the end of
its producer's stream, else the consumer's tail iterations stall forever
even though no cycle exists.  For each dep we replay the full residue
stream through :func:`repro_torch.core.poly.frontier_limit_ramp` and require the
final admitted limit to reach the consumer's last executed iteration rank
(``gate-never-lifts``).  Cross-chip gates additionally need their writes
actually delivered: every send with an off-chip destination must have been
materialized as an :class:`~repro_torch.core.lowering.InterChipStream`
(``missing-dma-stream``), or the consumer waits on data that never
arrives.

Port copy of ``repro.analysis.progress``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import poly
from ..core.lowering import AcceleratorProgram
from .diagnostics import AnalysisDiagnostic
from .model import CoreModel


def _err(check: str, message: str, core: Optional[int] = None,
         value: Optional[str] = None) -> AnalysisDiagnostic:
    return AnalysisDiagnostic(check=check, severity="error", message=message,
                              core=core, value=value)


def build_wait_graph(prog: AcceleratorProgram
                     ) -> Dict[int, List[Tuple[int, int, str]]]:
    """Stage-level wait-for edges: partition -> [(src_partition, core, value)].

    Self-edges (a partition's own recurrence through its iteration order)
    are excluded — stream order within a core is total and trivially makes
    progress; only cross-stage gates can deadlock.
    """
    graph: Dict[int, List[Tuple[int, int, str]]] = {}
    for cid, cfg in sorted(prog.cores.items()):
        p = cfg.partition_idx
        graph.setdefault(p, [])
        for v, lc in sorted(cfg.lcu.items()):
            for dp in lc.deps:
                s = dp.src_partition
                if s < 0 or s == p:
                    continue  # GCU roots the order; self-waits can't cycle
                graph[p].append((s, cid, v))
    return graph


def _find_cycle(graph: Dict[int, List[Tuple[int, int, str]]]
                ) -> Optional[List[int]]:
    """First wait-for cycle (as a partition list), by iterative DFS."""
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[int, int] = {}
    for root in sorted(graph):
        if color.get(root, WHITE) != WHITE:
            continue
        stack: List[Tuple[int, int]] = [(root, 0)]
        path: List[int] = []
        while stack:
            node, i = stack.pop()
            if i == 0:
                color[node] = GREY
                path.append(node)
            succs = graph.get(node, [])
            advanced = False
            while i < len(succs):
                nxt = succs[i][0]
                i += 1
                c = color.get(nxt, WHITE)
                if c == GREY:
                    return path[path.index(nxt):] + [nxt]
                if c == WHITE:
                    stack.append((node, i))
                    stack.append((nxt, 0))
                    advanced = True
                    break
            if not advanced:
                color[node] = BLACK
                path.pop()
    return None


def _max_executed_rank(bounds: Tuple[int, ...], k: int, r: int) -> int:
    """Flat rank of the consumer's last executed iteration (-1 if none)."""
    total = int(np.prod(bounds))
    if total == 0 or r >= total:
        return -1
    return r + ((total - 1 - r) // k) * k


def _check_totality(models: List[CoreModel]) -> List[AnalysisDiagnostic]:
    out: List[AnalysisDiagnostic] = []
    for cm in models:
        last = _max_executed_rank(cm.bounds, int(cm.cfg.repl_k),
                                  int(cm.cfg.repl_r))
        if last < 0:
            continue
        for v in sorted(cm.values):
            vm = cm.values[v]
            for dm in vm.deps:
                t = dm.lcu_dep.table
                if t is None or tuple(t.reader_bounds) != tuple(cm.bounds):
                    continue  # pass 1 reports codegen-table-mismatch
                if t.never_constrains:
                    continue
                if len(dm.writers):
                    tr = t.rank[tuple(dm.wlocs.T)]
                    wr = np.full(len(dm.writers), -1, np.int64)
                    np.maximum.at(wr, dm.w_idx, tr)
                    _, limits = poly.frontier_limit_ramp(
                        wr, t.d_lexmin_rank, t.d_lexmax_rank)
                    final = int(limits[-1])
                else:
                    final = t.d_lexmin_rank - 1  # gate stuck pre-stream
                if final < poly.INF_RANK and final < last:
                    src = ("the GCU stream" if dm.src_partition < 0
                           else f"partition {dm.src_partition}")
                    out.append(_err(
                        "gate-never-lifts",
                        f"input {v!r}: after {src}'s entire write stream "
                        f"the gate only admits ranks <= {final}, but this "
                        f"core executes up to rank {last} — its tail "
                        f"iterations stall forever", core=cm.core_id,
                        value=v))
    return out


def _check_dma_streams(prog: AcceleratorProgram) -> List[AnalysisDiagnostic]:
    if prog.mesh is None:
        return []
    have = {(s.value, s.src_core, s.dst_core) for s in prog.dma_streams}
    out: List[AnalysisDiagnostic] = []
    for cid, cfg in sorted(prog.cores.items()):
        src_chip = prog.mesh.chip_of(cid)
        for spec in cfg.sends:
            for dst in sorted(spec.dst_cores):
                if prog.mesh.chip_of(dst) == src_chip:
                    continue
                if (spec.value, cid, dst) not in have:
                    out.append(_err(
                        "missing-dma-stream",
                        f"cross-chip send {spec.value!r} core {cid} -> "
                        f"{dst} has no InterChipStream — the consumer's "
                        f"gate waits on writes that are never delivered",
                        core=dst, value=spec.value))
    return out


def progress_diagnostics(prog: AcceleratorProgram, models: List[CoreModel]
                         ) -> Tuple[List[AnalysisDiagnostic],
                                    Dict[str, object]]:
    """Run pass 2; returns (diagnostics, metrics)."""
    out: List[AnalysisDiagnostic] = []
    graph = build_wait_graph(prog)
    cycle = _find_cycle(graph)
    if cycle is not None:
        out.append(_err(
            "wait-cycle",
            "stage wait-for graph has a cycle: "
            + " -> ".join(f"partition {p}" for p in cycle)
            + " — every stage in it withholds the writes the next one "
              "gates on (guaranteed deadlock)"))
    out.extend(_check_totality(models))
    out.extend(_check_dma_streams(prog))
    n_edges = sum(len(v) for v in graph.values())
    return out, {"wait_edges": n_edges, "wait_stages": len(graph)}
