"""Retry + remap recovery for the CM serving runtime.

Two pieces, both deterministic:

:class:`RetryPolicy` — capped exponential backoff *in cycles* for failed
requests.  ``backoff(attempt)`` is pure arithmetic, testable against a hand
oracle (``tests/test_faults.py``).

:func:`remap_program` — re-solve a tenant's mapping with its dead cores
(and any cores other tenants occupy) excluded, then re-lower.  Single
chip: the constraint solver simply never places a partition on an excluded
core, so spare cores on the same chip absorb the tenant.  Mesh: the tenant
migrates to a contiguous window of chips containing no excluded core (the
``distributed/elastic.py`` restart pattern), re-running the chip-level
partitioner per window until one fits.  The caller charges the explicit
reprogram cost — crossbars are analog and reprogramming them is the
expensive part — via ``RemapResult.n_crossbars``.

Port copy of ``repro.faults.recovery``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..core.compiler import CompileValidationError, validate_program
from ..core.hwspec import ChipMesh, ChipSpec, submesh
from ..core.lowering import AcceleratorProgram, lower
from ..core.mapping import MappingError, map_partitions, map_partitions_mesh
from ..core.partition import (PartitionError, partition_chips,
                              partition_graph, plan_replication,
                              replicate_partitions)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff, measured in simulator cycles.

    Retry ``attempt`` (1-based) of a failed request is re-admitted
    ``backoff(attempt)`` cycles after its failure was detected:
    ``min(backoff_cycles * backoff_factor**(attempt-1), max_backoff_cycles)``.
    ``max_retries`` bounds the attempts; after that the request is failed
    permanently.
    """

    max_retries: int = 3
    backoff_cycles: int = 64
    backoff_factor: int = 2
    max_backoff_cycles: int = 4096

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.backoff_cycles < 0:
            raise ValueError(f"backoff_cycles must be >= 0, got "
                             f"{self.backoff_cycles}")
        if self.backoff_factor < 1:
            raise ValueError(f"backoff_factor must be >= 1, got "
                             f"{self.backoff_factor}")
        if self.max_backoff_cycles < self.backoff_cycles:
            raise ValueError("max_backoff_cycles must be >= backoff_cycles")

    def backoff(self, attempt: int) -> int:
        """Cycles to wait before retry ``attempt`` (1-based)."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        return min(self.backoff_cycles * self.backoff_factor ** (attempt - 1),
                   self.max_backoff_cycles)


@dataclasses.dataclass(frozen=True)
class RemapResult:
    """A re-solved tenant program plus what the recovery cost.

    ``cores`` is the new mapping's core set (never intersecting the
    excluded cores); ``n_crossbars`` counts the crossbar-bearing cores that
    must be (re)programmed — the unit the serving runtime's
    ``reprogram_cost_cycles`` penalty multiplies.
    """

    program: AcceleratorProgram
    cores: Tuple[int, ...]
    n_crossbars: int


def remap_program(graph, chip: ChipSpec = None, mesh: ChipMesh = None,
                  dead_cores=(), reserved_cores=(),
                  quantizer=None, replicate=None,
                  analyze: bool = False) -> RemapResult:
    """Re-compile ``graph`` onto the surviving cores.

    ``dead_cores`` are failed (global) core ids; ``reserved_cores`` are
    healthy but owned by other tenants.  Raises
    :class:`~repro_torch.core.mapping.MappingError` /
    :class:`~repro_torch.core.partition.PartitionError` when no spare capacity
    remains — the caller decides whether that tenant's requests fail
    permanently.

    ``replicate`` carries the tenant's bottleneck-replication request
    through recovery (same forms as ``compile_model``: ``"auto"`` or
    ``{node: k}``).  Recompiling re-lowers the round-robin split from
    scratch, so a dead replica core is simply never placed on again; when
    the surviving cores cannot host the full replica set, the largest
    ``k`` is decremented (k-1 round-robin, re-lowered) until the mapping
    fits — the degraded program remains bitwise value-correct, only
    slower.  ``"auto"`` re-plans directly against the surviving core
    budget instead.
    """
    excluded = sorted(set(int(c) for c in dead_cores)
                      | set(int(c) for c in reserved_cores))
    base_pg = partition_graph(graph)
    if replicate == "auto":
        total = mesh.n_cores_total if mesh is not None else chip.n_cores
        spec = mesh.chip if mesh is not None else chip
        plan = plan_replication(base_pg, total - len(excluded),
                                spec.dma_pixels_per_cycle)
    else:
        plan = dict(replicate) if replicate else {}
    while True:
        pg = replicate_partitions(base_pg, plan) if plan else base_pg
        try:
            if mesh is None:
                if chip is None:
                    raise ValueError("remap_program needs a chip or a mesh")
                mapping = map_partitions(pg, chip, exclude_cores=excluded)
                prog = lower(pg, mapping, quantizer=quantizer)
            else:
                prog = _remap_mesh(pg, mesh, frozenset(excluded), quantizer)
            break
        except (MappingError, PartitionError):
            live = {n: k for n, k in plan.items() if k > 1}
            if not live:
                raise
            worst = max(live, key=lambda n: (live[n], n))
            plan = dict(plan)
            plan[worst] = live[worst] - 1
            if plan[worst] <= 1:
                del plan[worst]
    # same post-mapping invariant guard as compile_model(validate=True);
    # analyze=True escalates to the full static verifier — a recovery
    # remap is exactly the compile path that never went through CI, so
    # proving race/deadlock freedom before serving resumes is cheap
    # insurance (same contract as compile_model(analyze=True))
    if analyze:
        from ..analysis import verify_program
        report = verify_program(prog, None if mesh is not None else chip)
        report.raise_if_errors(CompileValidationError)
    else:
        validate_program(prog, chip if mesh is None else None)
    cores = tuple(sorted(prog.cores))
    n_xbar = sum(1 for cfg in prog.cores.values()
                 if cfg.xbar_node is not None)
    return RemapResult(program=prog, cores=cores, n_crossbars=n_xbar)


def trace_remap_events(trace, events) -> None:
    """Emit recovery remap events as trace instants (``repro_torch.obs``).

    One ``remap-ok`` / ``remap-failed`` marker per event at the detection
    cycle, carrying the tenant, the dead cores and — for successful
    remaps — the new core set and the crossbar-reprogram bill, so a
    Perfetto timeline shows exactly when and why the pipeline migrated.
    """
    for ev in events:
        if ev.get("ok"):
            trace.add_instant("remap-ok", ev["cycle"],
                              tenant=ev["tenant"],
                              dead_cores=ev["dead_cores"],
                              new_cores=ev["new_cores"],
                              n_crossbars=ev["n_crossbars"],
                              reprogram_cycles=ev["reprogram_cycles"])
        else:
            trace.add_instant("remap-failed", ev["cycle"],
                              tenant=ev["tenant"],
                              dead_cores=ev["dead_cores"],
                              error=ev.get("error", ""))


def _remap_mesh(pg, mesh: ChipMesh, excluded: frozenset, quantizer):
    """Migrate the tenant to a contiguous window of untouched chips.

    Chip-granular like ``compiler._place_tenants_mesh``: scan windows of
    growing size, skipping any window containing an excluded core, and
    re-run the chip-level partitioner inside the first that fits.
    """
    cpc = mesh.chip.n_cores
    bad_chips = {c // cpc for c in excluded}
    need_min = -(-len(pg.partitions) // cpc)
    last_err = None
    for k in range(need_min, mesh.n_chips + 1):
        for lo in range(mesh.n_chips - k + 1):
            if any(c in bad_chips for c in range(lo, lo + k)):
                continue
            try:
                sub = submesh(mesh, lo, lo + k)
                local_assign = partition_chips(pg, sub)
            except PartitionError as e:
                last_err = e
                continue
            chip_assign = {p: c + lo for p, c in local_assign.items()}
            mapping = map_partitions_mesh(pg, mesh, chip_assign,
                                          exclude_cores=excluded)
            return lower(pg, mapping, quantizer=quantizer, mesh=mesh)
    raise MappingError(
        f"no fault-free chip window fits {len(pg.partitions)} partitions "
        f"(excluded cores {sorted(excluded)}, {mesh.n_chips} chips)"
        + (f"; last window error: {last_err}" if last_err else ""))
