"""Static model of a lowered program, rebuilt from first principles.

The verifier never trusts the compiled LCU artifacts it is checking:
write/read access relations are re-derived from the graph via the same
shared builders lowering uses (:func:`repro_torch.core.lowering.build_write_specs`
/ :func:`partition_read_relations`), producer replica residues come from
the *as-run* ``CoreConfig.repl_k``/``repl_r`` fields the simulator
executes, and every relation is enumerated into an execution-ordered
stream (:func:`repro_torch.core.poly.relation_stream`).  The passes in
``dependences``/``progress``/``resources`` then compare the compiled
frontier tables and generated evaluators against this model.

Model construction is total: a unit that cannot be modeled (unmapped
producer, crashed relation rebuild) records a diagnostic instead of
raising, so mutation-corrupted programs still get the rest of their report.

Port copy of ``repro.analysis.model``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core import poly
from ..core.lowering import (AcceleratorProgram, CoreConfig, LcuArrayConfig,
                             LcuDep, build_write_specs, graph_aliases,
                             partition_read_relations)
from .diagnostics import AnalysisDiagnostic


def _mixed_radix(extents: Tuple[int, ...]) -> np.ndarray:
    radix = np.ones(max(len(extents), 1), np.int64)
    for d in range(len(extents) - 2, -1, -1):
        radix[d] = radix[d + 1] * extents[d + 1]
    return radix[:len(extents)]


@dataclasses.dataclass
class DepModel:
    """One dependency automaton's as-run ground truth.

    ``writers``/``w_idx``/``wlocs`` is the producer's write stream under
    its *runtime* residue filter (``CoreConfig.repl_k``/``repl_r`` of the
    producing core, not whatever the dep was compiled against); ``dom`` is
    the residue-restricted writer iteration domain used for the exact
    partition checks (``Set.subtract``/``intersect`` on both backends).
    """

    lcu_dep: LcuDep
    src_partition: int
    producer_core: Optional[int]        # None for the GCU stream (-1)
    repl_k: int
    repl_r: int
    prod_bounds: Tuple[int, ...]
    writers: np.ndarray                 # (n_events, nd_iter), lex order
    w_idx: np.ndarray                   # (n_pairs,) event index per pair
    wlocs: np.ndarray                   # (n_pairs, nd_array)
    dom: Any                            # poly Set of writer iterations


@dataclasses.dataclass
class ValueModel:
    """One (consumer core, LCU input array) unit."""

    value: str
    shape: Tuple[int, ...]
    lc: LcuArrayConfig
    w1: Any                             # full producer write relation (Map)
    rel: Any                            # consumer read relation (Map)
    readers: np.ndarray                 # (n_readers, nd_iter), lex order
    r_idx: np.ndarray                   # (n_pairs,) reader index per pair
    rlocs: np.ndarray                   # (n_pairs, nd_array)
    reader_ranks: np.ndarray            # (n_readers,), ascending
    full_written: np.ndarray            # bool over flattened array locs
    deps: List[DepModel]


@dataclasses.dataclass
class CoreModel:
    core_id: int
    cfg: CoreConfig
    bounds: Tuple[int, ...]
    recomputed_reads: Tuple[str, ...]   # values the partition actually reads
    values: Dict[str, ValueModel]


def _err(check: str, message: str, core: Optional[int] = None,
         value: Optional[str] = None) -> AnalysisDiagnostic:
    return AnalysisDiagnostic(check=check, severity="error", message=message,
                              core=core, value=value)


def _build_dep(prog: AcceleratorProgram, w1: Any, dep: LcuDep,
               input_bounds: Tuple[int, ...]
               ) -> Tuple[Optional[DepModel], Optional[str]]:
    """Model one dependency; returns ``(model, problem)`` where ``problem``
    is a message when the dep dangles (producer unmapped)."""
    s = dep.src_partition
    if s < 0:
        prod_bounds: Tuple[int, ...] = input_bounds
        k, r, pcore = 1, 0, None
    else:
        pcore = prog.mapping.get(s)
        if pcore is None or pcore not in prog.cores:
            return None, (f"dep on partition {s} which is unmapped / has no "
                          "core — the gate waits on iterations no producer "
                          "executes")
        pcfg = prog.cores[pcore]
        prod_bounds = tuple(pcfg.iter_bounds)
        k, r = int(pcfg.repl_k), int(pcfg.repl_r)
    w1_d = poly.restrict_writes_mod(w1, prod_bounds, k, r)
    writers, w_idx, wlocs = poly.relation_stream(w1_d)
    return DepModel(lcu_dep=dep, src_partition=s, producer_core=pcore,
                    repl_k=k, repl_r=r, prod_bounds=prod_bounds,
                    writers=writers, w_idx=w_idx, wlocs=wlocs,
                    dom=w1_d.domain()), None


def build_model(prog: AcceleratorProgram
                ) -> Tuple[List[CoreModel], List[AnalysisDiagnostic]]:
    """Rebuild the static model of every (core, LCU input) unit.

    Returns the per-core models plus the diagnostics discovered during
    modeling itself: ``lcu-coverage`` (the compiled LCU set disagrees with
    the recomputed read set), ``dangling-dep`` (a dep's producer is
    unmapped), and ``verifier-crash`` for units that cannot be rebuilt.
    """
    graph = prog.pgraph.graph
    pg = prog.pgraph
    aliases = graph_aliases(graph)
    write_specs = build_write_specs(graph, pg, aliases)
    input_shape = graph.values[graph.inputs[0]].shape
    input_bounds = tuple(int(x) for x in input_shape[1:])

    models: List[CoreModel] = []
    diags: List[AnalysisDiagnostic] = []
    for cid, cfg in sorted(prog.cores.items()):
        try:
            part = pg.partitions[cfg.partition_idx]
            bounds = tuple(int(b) for b in cfg.iter_bounds)
            reads, _pads = partition_read_relations(graph, pg, part, bounds,
                                                    aliases)
        except Exception as e:
            diags.append(_err("verifier-crash",
                              f"cannot rebuild read relations: {e!r}",
                              core=cid))
            continue
        if set(reads) != set(cfg.lcu):
            missing = sorted(set(reads) - set(cfg.lcu))
            extra = sorted(set(cfg.lcu) - set(reads))
            diags.append(_err(
                "lcu-coverage",
                f"compiled LCU set disagrees with the partition's reads: "
                f"missing automata for {missing}, spurious automata for "
                f"{extra}", core=cid))
        vmodels: Dict[str, ValueModel] = {}
        rbound_radix = _mixed_radix(bounds)
        for v in sorted(cfg.lcu):
            if v not in reads:
                continue  # flagged above; nothing to model against
            try:
                lc = cfg.lcu[v]
                shape = tuple(int(x) for x in graph.values[v].shape)
                w1 = write_specs[v].isl_write("WR")
                rel = reads[v]
                readers, r_idx, rlocs = poly.relation_stream(rel)
                reader_ranks = (readers @ rbound_radix
                                if len(readers) else
                                np.zeros(0, np.int64))
                full_written = np.zeros(int(np.prod(shape)), bool)
                _w, _wi, flocs = poly.relation_stream(w1)
                if len(flocs):
                    full_written[flocs @ _mixed_radix(shape)] = True
                deps: List[DepModel] = []
                for d in lc.deps:
                    dm, problem = _build_dep(prog, w1, d, input_bounds)
                    if dm is None:
                        diags.append(_err("dangling-dep",
                                          f"input {v!r}: {problem}",
                                          core=cid, value=v))
                        continue
                    deps.append(dm)
                vmodels[v] = ValueModel(
                    value=v, shape=shape, lc=lc, w1=w1, rel=rel,
                    readers=readers, r_idx=r_idx, rlocs=rlocs,
                    reader_ranks=reader_ranks, full_written=full_written,
                    deps=deps)
            except Exception as e:
                diags.append(_err("verifier-crash",
                                  f"cannot model input {v!r}: {e!r}",
                                  core=cid, value=v))
        models.append(CoreModel(core_id=cid, cfg=cfg, bounds=bounds,
                                recomputed_reads=tuple(sorted(reads)),
                                values=vmodels))
    return models, diags
