"""Mapping the partition graph onto the chip (paper §3.1).

"We map the partition graph to the CM accelerator, i.e., mapping each
partition to a CM core and each edge to a connection in the interconnect
topology, by expressing the problem as a set of constraints in the Z3 SMT
solver."

Constraints:
  * each partition on a distinct core;
  * for every partition edge (p, q), (core(p), core(q)) must be an edge of the
    interconnect graph;
  * per-core resource constraints (crossbar width, SRAM footprint) are checked
    up front since cores are homogeneous.

Port copy of ``repro.core.mapping``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

from typing import Dict, Optional

try:
    import z3
    HAVE_Z3 = True
except ModuleNotFoundError:  # gate the dep: complete backtracking search
    z3 = None
    HAVE_Z3 = False

from .hwspec import ChipMesh, ChipSpec
from .partition import GCU_PARTITION, PartitionedGraph, partition_chips


class MappingError(Exception):
    pass


def _xbar_dims(pg: PartitionedGraph, pidx: int) -> Optional[tuple]:
    xbar = pg.partitions[pidx].crossbar
    if xbar is None:
        return None
    g = pg.graph
    if xbar.op == "conv2d":
        fl, c, fh, fw = g.values[xbar.inputs[1]].shape
        return (fl, c * fh * fw)
    od, idim = g.values[xbar.inputs[1]].shape
    return (od, idim)


def sram_footprint(pg: PartitionedGraph, pidx: int) -> int:
    """Bytes of core-local state: cross-partition input arrays + accumulators."""
    g = pg.graph
    total = 0
    for v in pg.cross_edges_into(pidx):
        total += g.values[v].nbytes
    for node in pg.partitions[pidx].nodes:
        if node.op in ("maxpool2d", "avgpool2d", "global_avgpool"):
            total += g.values[node.outputs[0]].nbytes  # accumulator
    return total


def check_resources(pg: PartitionedGraph, chip: ChipSpec) -> None:
    for p in pg.partitions:
        dims = _xbar_dims(pg, p.idx)
        if dims is not None:
            rows, cols = dims
            if rows > chip.core.width or cols > chip.core.width:
                raise MappingError(
                    f"partition {p.idx}: crossbar op {p.crossbar.name} needs "
                    f"{rows}x{cols} > width {chip.core.width} "
                    "(paper §3.5: requires graph transformation)")
        need = sram_footprint(pg, p.idx)
        if need > chip.core.sram_bytes:
            raise MappingError(
                f"partition {p.idx}: SRAM footprint {need}B > "
                f"{chip.core.sram_bytes}B")


def map_partitions(pg: PartitionedGraph, chip: ChipSpec,
                   timeout_ms: int = 30_000,
                   exclude_cores=()) -> Dict[int, int]:
    """partition idx -> core id, via Z3 (or exhaustive backtracking when the
    solver is unavailable).  Raises MappingError when UNSAT.

    ``exclude_cores`` withholds core ids from the placement — the fault-
    recovery path re-solves a tenant's mapping with its dead cores (and any
    cores other tenants occupy) excluded."""
    check_resources(pg, chip)
    part_ids = list(range(len(pg.partitions)))
    edges = [(s, d) for (s, d) in pg.edges if s != GCU_PARTITION]
    return _solve_chip(part_ids, edges, chip, timeout_ms,
                       exclude_cores=exclude_cores,
                       groups=tuple(pg.replica_groups.values()))


def map_partitions_mesh(pg: PartitionedGraph, mesh: ChipMesh,
                        chip_assign: Optional[Dict[int, int]] = None,
                        timeout_ms: int = 30_000,
                        exclude_cores=()) -> Dict[int, int]:
    """partition idx -> *global* core id over a multi-chip mesh.

    Each chip's partitions are mapped onto that chip's cores independently
    (same constraint set as the single-chip problem); only *intra-chip*
    partition edges constrain the intra-chip placement — cut edges arrive
    through the inter-chip DMA path straight into the consumer core's SRAM,
    exactly like GCU input ("the GCU reaches every core through GMEM"), so
    they impose no interconnect constraint inside either chip.
    """
    check_resources(pg, mesh.chip)
    if chip_assign is None:
        chip_assign = partition_chips(pg, mesh)
    # global exclusions become per-chip local core ids
    excl_local: Dict[int, set] = {}
    for gc in exclude_cores:
        excl_local.setdefault(mesh.chip_of(gc), set()).add(
            mesh.local_core(gc))
    mapping: Dict[int, int] = {}
    for c in range(mesh.n_chips):
        parts = sorted(p for p, cc in chip_assign.items() if cc == c)
        if not parts:
            continue
        edges = [(s, d) for (s, d) in pg.edges
                 if s != GCU_PARTITION
                 and chip_assign[s] == c and chip_assign[d] == c]
        # symmetry breaking only orders the group members that landed on
        # this chip (the chip-level DP may cut through a replica group —
        # replicas never communicate, so that is legal)
        groups = tuple(tuple(m for m in g if chip_assign.get(m) == c)
                       for g in pg.replica_groups.values())
        local = _solve_chip(parts, edges, mesh.chip, timeout_ms,
                            exclude_cores=excl_local.get(c, ()),
                            groups=tuple(g for g in groups if len(g) > 1))
        for p, lc in local.items():
            mapping[p] = mesh.global_core(c, lc)
    return mapping


def _solve_chip(part_ids, edges, chip: ChipSpec,
                timeout_ms: int = 30_000,
                exclude_cores=(), groups=()) -> Dict[int, int]:
    """Place ``part_ids`` on one chip's cores: distinct cores, every edge in
    ``edges`` on an interconnect link.  Z3 when available, else exhaustive
    backtracking (partition graphs are small, so the search is exact).
    ``exclude_cores`` (dead/reserved cores) never receive a partition.
    ``groups`` lists replica groups (tuples of partition ids): members are
    fully interchangeable — identical edge sets, no intra-group edges — so
    ordering their core ids breaks the k! placement symmetry without losing
    satisfiability."""
    n_parts = len(part_ids)
    excluded = frozenset(int(c) for c in exclude_cores)
    avail = chip.n_cores - len(excluded & frozenset(range(chip.n_cores)))
    if n_parts > avail:
        raise MappingError(
            f"{n_parts} partitions > {avail} available cores"
            + (f" ({len(excluded)} excluded)" if excluded else ""))
    if not HAVE_Z3:
        return _map_backtracking(part_ids, edges, chip, excluded, groups)

    solver = z3.Solver()
    solver.set("timeout", timeout_ms)
    loc = {p: z3.Int(f"loc_{p}") for p in part_ids}
    for v in loc.values():
        solver.add(v >= 0, v < chip.n_cores)
        for c in sorted(excluded):
            solver.add(v != c)
    solver.add(z3.Distinct(*loc.values()))

    edge_pairs = sorted(chip.edges)
    for (src, dst) in edges:
        solver.add(z3.Or(*[
            z3.And(loc[src] == a, loc[dst] == b) for (a, b) in edge_pairs
        ]))
    for g in groups:
        for a, b in zip(g, g[1:]):
            solver.add(loc[a] < loc[b])

    if solver.check() != z3.sat:
        raise MappingError(
            f"Z3: no valid mapping of {n_parts} partitions onto "
            f"{chip.n_cores}-core chip with {len(chip.edges)} links"
            + (f" ({sorted(excluded)} excluded)" if excluded else ""))
    model = solver.model()
    return {p: model[loc[p]].as_long() for p in part_ids}


def _map_backtracking(part_ids, edges, chip: ChipSpec,
                      excluded: frozenset = frozenset(),
                      groups=()) -> Dict[int, int]:
    """Complete DFS over core assignments with the same constraint set as the
    Z3 encoding: distinct cores, every partition edge on an interconnect link,
    replica-group members core-ordered (symmetry breaking).
    No solution found == UNSAT."""
    order = sorted(part_ids)
    # all edges go forward (src < dst, partition.py invariant 2), so when
    # assigning dst every src is already placed
    preds: Dict[int, list] = {p: [] for p in order}
    for (src, dst) in edges:
        preds[dst].append(src)
    # replica group members are consecutive ascending ids, so the previous
    # member is always assigned first in the DFS order below
    prev_in_group: Dict[int, int] = {}
    for g in groups:
        for a, b in zip(g, g[1:]):
            prev_in_group[b] = a
    assign: Dict[int, int] = {}
    used = set()

    def ok(pidx: int, core: int) -> bool:
        for src in preds[pidx]:
            if src in assign and (assign[src], core) not in chip.edges:
                return False
        pv = prev_in_group.get(pidx)
        if pv is not None and pv in assign and assign[pv] >= core:
            return False
        return True

    def dfs(k: int) -> bool:
        if k == len(order):
            return True
        pidx = order[k]
        for core in range(chip.n_cores):
            if core in used or core in excluded or not ok(pidx, core):
                continue
            assign[pidx] = core
            used.add(core)
            if dfs(k + 1):
                return True
            used.discard(core)
            del assign[pidx]
        return False

    if not dfs(0):
        raise MappingError(
            f"no valid mapping of {len(order)} partitions onto "
            f"{chip.n_cores}-core chip with {len(chip.edges)} links"
            + (f" ({sorted(excluded)} excluded)" if excluded else ""))
    return dict(assign)
