"""Pass 1 — dependency soundness / race freedom.

For every compiled dependency automaton this pass statically replays the
producer's write stream (in execution order, under the as-run replica
residue) against the compiled frontier ramp
(:func:`repro_torch.core.poly.frontier_limit_ramp` — the single admitted-limit
definition both simulator engines use) and compares each post-write
admitted limit against an *independent* oracle threshold derived straight
from the access relations: the prefix-max, over rank-sorted dependent
readers of this consumer's residue class, of each reader's last required
write event.  The compiled ramp admitting any rank beyond the oracle's
threshold is a provable read-before-write race (``frontier-unsound``).

Why per-dep checking suffices under replication: a consumer's admission is
the AND over all per-replica frontiers, and the replica streams partition
the writer domain (checked here exactly, via ``Set.subtract`` /
``Set.intersect`` on both polyhedral backends — ``replica-residues`` /
``dangling-dep``).  Each dep's oracle only requires the writes *its own*
stream carries, so if every dep individually never over-admits, the merged
admission never admits a read before any of its writers regardless of how
the k producer streams interleave at runtime.

Checks emitted:
  frontier-unsound        ramp admits a reader rank before its writer
  codegen-table-mismatch  generated-code S disagrees with the compiled
                          table (or the table targets the wrong reader box)
  replica-residues        two deps' writer domains overlap (two unordered
                          writers for a cell)
  dangling-dep            writer iterations no dep covers, or dependent
                          reads no dep gates (plus unmapped producers,
                          found at model build)

Port copy of ``repro.analysis.dependences``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import poly
from .diagnostics import AnalysisDiagnostic
from .model import CoreModel, DepModel, ValueModel, _mixed_radix


def _err(check: str, message: str, core: Optional[int] = None,
         value: Optional[str] = None) -> AnalysisDiagnostic:
    return AnalysisDiagnostic(check=check, severity="error", message=message,
                              core=core, value=value)


def _dep_label(dm: DepModel) -> str:
    if dm.src_partition < 0:
        return "GCU stream"
    lab = f"partition {dm.src_partition}"
    if dm.repl_k > 1:
        lab += f" (residue {dm.repl_r} mod {dm.repl_k})"
    return lab


def _check_dep_soundness(cm: CoreModel, vm: ValueModel, dm: DepModel,
                         cls_mask: np.ndarray) -> List[AnalysisDiagnostic]:
    """Replay one dep's write stream against its compiled ramp."""
    out: List[AnalysisDiagnostic] = []
    cid, v = cm.core_id, vm.value
    t = dm.lcu_dep.table
    if t is None:
        return [_err("codegen-table-mismatch",
                     f"dep on {_dep_label(dm)} has no compiled frontier "
                     "table", core=cid, value=v)]
    if tuple(t.reader_bounds) != tuple(cm.bounds):
        return [_err("codegen-table-mismatch",
                     f"dep on {_dep_label(dm)}: table reader bounds "
                     f"{tuple(t.reader_bounds)} != consumer iteration box "
                     f"{tuple(cm.bounds)}", core=cid, value=v)]

    shape_radix = _mixed_radix(vm.shape)
    n_locs = int(np.prod(vm.shape))

    # oracle: per written location, the index of its final write event in
    # THIS dep's stream; per dependent reader of this core's residue class,
    # the latest event it requires; prefix-max over rank-sorted readers.
    wtime = np.full(n_locs, -1, np.int64)
    if len(dm.wlocs):
        np.maximum.at(wtime, dm.wlocs @ shape_radix, dm.w_idx)
    T = np.full(len(vm.readers), -1, np.int64)
    if len(vm.rlocs):
        np.maximum.at(T, vm.r_idx, wtime[vm.rlocs @ shape_radix])
    sel = cls_mask & (T >= 0)
    ranks_c = vm.reader_ranks[sel]          # ascending (readers lex-sorted)
    pm = np.maximum.accumulate(T[sel]) if len(ranks_c) else T[:0]

    if t.never_constrains:
        if len(ranks_c):
            out.append(_err(
                "frontier-unsound",
                f"dep on {_dep_label(dm)}: table never constrains but "
                f"{len(ranks_c)} iterations of this core read its writes "
                f"(first: rank {int(ranks_c[0])})", core=cid, value=v))
        return out

    # pre-stream admission: before any write the frontier admits every
    # rank < d_lexmin_rank; none of those may depend on a write
    if len(ranks_c) and t.d_lexmin_rank > int(ranks_c[0]):
        out.append(_err(
            "frontier-unsound",
            f"dep on {_dep_label(dm)}: ramp admits rank "
            f"{t.d_lexmin_rank - 1} before any write, but rank "
            f"{int(ranks_c[0])} already depends on write event "
            f"{int(pm[0])}", core=cid, value=v))

    if not len(dm.writers):
        return out
    # machinery ramp: per write event, the max table rank of its locations
    tr = t.rank[tuple(dm.wlocs.T)] if len(dm.wlocs) else np.zeros(0, np.int64)
    wr = np.full(len(dm.writers), -1, np.int64)
    np.maximum.at(wr, dm.w_idx, tr)
    _, limits = poly.frontier_limit_ramp(wr, t.d_lexmin_rank,
                                         t.d_lexmax_rank)
    if not len(ranks_c):
        return out  # no dependent reads in this class: any limit is sound
    # oracle threshold after event i: (first reader whose prefix
    # requirement exceeds i) - 1, or INF once all are satisfied
    pos = np.searchsorted(pm, np.arange(len(dm.writers)), side="right")
    thr = np.where(pos < len(ranks_c),
                   ranks_c[np.minimum(pos, len(ranks_c) - 1)] - 1,
                   poly.INF_RANK)
    bad = np.nonzero(limits > thr)[0]
    if len(bad):
        i = int(bad[0])
        lim = int(limits[i])
        out.append(_err(
            "frontier-unsound",
            f"dep on {_dep_label(dm)}: after write event {i} "
            f"(iteration {tuple(int(x) for x in dm.writers[i])}) the ramp "
            f"admits rank {'INF' if lim >= poly.INF_RANK else lim} but the "
            f"Appendix-A oracle only allows rank {int(thr[i])}",
            core=cid, value=v))
    return out


def _check_codegen_parity(cm: CoreModel, vm: ValueModel,
                          dm: DepModel) -> List[AnalysisDiagnostic]:
    """Generated-code S (paper §3.4) must agree with the compiled table
    (§3.5 / the vectorized event-engine form) on every written location."""
    t = dm.lcu_dep.table
    if t is None or tuple(t.reader_bounds) != tuple(cm.bounds):
        return []  # already reported by the soundness check
    if not len(dm.wlocs):
        return []
    try:
        evaluator = dm.lcu_dep.make_frontier().eval
    except Exception as e:
        return [_err("codegen-table-mismatch",
                     f"dep on {_dep_label(dm)}: generated source does not "
                     f"compile: {e!r}", core=cm.core_id, value=vm.value)]
    for loc in np.unique(dm.wlocs, axis=0):
        key = tuple(int(x) for x in loc)
        j = evaluator(*key)
        erank = -1 if j is None else poly.iter_rank(j, t.reader_bounds)
        trank = int(t.rank[key])
        if erank != trank:
            return [_err(
                "codegen-table-mismatch",
                f"dep on {_dep_label(dm)}: at location {key} the generated "
                f"evaluator yields rank {erank} but the compiled table "
                f"holds {trank}", core=cm.core_id, value=vm.value)]
    return []


def _check_residues(cm: CoreModel, vm: ValueModel) -> List[AnalysisDiagnostic]:
    """Replica residues must partition the writer domain exactly."""
    out: List[AnalysisDiagnostic] = []
    cid, v = cm.core_id, vm.value
    full_dom = vm.w1.domain()
    doms = [dm.dom for dm in vm.deps]
    # exact coverage: every writer iteration belongs to some dep's stream
    un = None
    for d in doms:
        un = d if un is None else un.union(d)
    uncovered = full_dom if un is None else full_dom.subtract(un)
    if not uncovered.is_empty():
        pt = poly.single_point(uncovered)
        out.append(_err(
            "dangling-dep",
            f"writer iteration {pt} of {v!r} is covered by no dependency "
            f"automaton — its writes would never gate this consumer",
            core=cid, value=v))
    # exact disjointness: no cell with two unordered writers
    for i in range(len(doms)):
        for j in range(i + 1, len(doms)):
            inter = doms[i].intersect(doms[j])
            if not inter.is_empty():
                pt = poly.single_point(inter)
                out.append(_err(
                    "replica-residues",
                    f"writer iteration {pt} of {v!r} belongs to both "
                    f"{_dep_label(vm.deps[i])} and "
                    f"{_dep_label(vm.deps[j])} — replica residues do not "
                    f"partition the writer domain", core=cid, value=v))
    return out


def _check_read_coverage(cm: CoreModel, vm: ValueModel,
                         cls_mask: np.ndarray) -> List[AnalysisDiagnostic]:
    """Every produced location this core reads must be gated by some dep."""
    if not len(vm.rlocs):
        return []
    shape_radix = _mixed_radix(vm.shape)
    covered = np.zeros(len(vm.full_written), bool)
    for dm in vm.deps:
        if len(dm.wlocs):
            covered[dm.wlocs @ shape_radix] = True
    pair_sel = cls_mask[vm.r_idx]
    needed = np.zeros(len(vm.full_written), bool)
    needed[vm.rlocs[pair_sel] @ shape_radix] = True
    miss = needed & vm.full_written & ~covered
    if not miss.any():
        return []
    flat = int(np.nonzero(miss)[0][0])
    loc = tuple(int(x) for x in np.unravel_index(flat, vm.shape))
    return [_err(
        "dangling-dep",
        f"location {loc} of {vm.value!r} is written by the producer and "
        f"read by this core, but no dependency automaton orders the read "
        f"after the write", core=cm.core_id, value=vm.value)]


def dependence_diagnostics(models: List[CoreModel]
                           ) -> Tuple[List[AnalysisDiagnostic],
                                      Dict[str, int]]:
    """Run pass 1 over a program model; returns (diagnostics, metrics)."""
    out: List[AnalysisDiagnostic] = []
    n_deps = n_events = 0
    for cm in models:
        k_c, r_c = int(cm.cfg.repl_k), int(cm.cfg.repl_r)
        for v in sorted(cm.values):
            vm = cm.values[v]
            cls_mask = ((vm.reader_ranks % k_c) == r_c
                        if len(vm.reader_ranks) else
                        np.zeros(0, bool))
            try:
                for dm in vm.deps:
                    n_deps += 1
                    n_events += len(dm.writers)
                    out.extend(_check_dep_soundness(cm, vm, dm, cls_mask))
                    out.extend(_check_codegen_parity(cm, vm, dm))
                out.extend(_check_residues(cm, vm))
                out.extend(_check_read_coverage(cm, vm, cls_mask))
            except Exception as e:
                out.append(_err("verifier-crash",
                                f"dependence check crashed: {e!r}",
                                core=cm.core_id, value=v))
    return out, {"deps_checked": n_deps, "write_events_replayed": n_events}
