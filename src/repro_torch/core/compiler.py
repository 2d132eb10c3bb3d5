"""cmnnc — end-to-end compilation (paper §3).

``compile_model(graph, chip)`` runs the full flow:
    partitioning (§3.1)  ->  Z3 mapping (§3.1)  ->  lowering (§3.2), which
    internally computes the Appendix-A ``S`` relations and generates the LCU
    automata code.

The result is an ``AcceleratorProgram``: the serializable bundle of per-unit
configurations the paper describes ("these configurations, bundled together
and serialized, initialize the accelerator").

Port of ``repro.core.compiler``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.  The
autotuner (``tune=``) is not ported yet, and asking for it raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

from .graph import Graph
from .hwspec import ChipMesh, ChipSpec, make_mesh, subchip, submesh
from .mapping import MappingError, map_partitions, map_partitions_mesh
from .lowering import AcceleratorProgram, lower
from .partition import (PartitionError, partition_chips, partition_graph,
                        plan_replication, replicate_partitions)
# only the leaf module: ..analysis.diagnostics imports nothing from the
# package, so this link cannot cycle no matter which package is imported
# first; the verifier itself (which needs the rest of repro_torch.core) is
# pulled in lazily by validate_program / compile_model
from ..analysis.diagnostics import AnalysisError


class CompileValidationError(AnalysisError):
    """A compiled program violates a post-mapping invariant.

    ``invariant`` names which one: ``"cores-on-chip"`` (a partition was
    mapped to a core id outside the chip/mesh), ``"cut-edge-link"`` (a
    cross-partition data edge has no interconnect link / mesh link under
    it), ``"sram-fits"`` (a core's static SRAM footprint — padded input
    buffers plus pool accumulators — exceeds the core spec), or
    ``"replica-group"`` (a k-replicated stage violates the replication
    contract: replicas on distinct cores with identical iteration bounds
    and residues exactly 0..k-1, every consumer holding one dependency
    automaton per replica).

    Since the static-verifier refactor this is a thin subclass of
    :class:`repro_torch.analysis.AnalysisError`; the checks themselves live in
    :mod:`repro_torch.analysis.structural` and run as part of
    :func:`repro_torch.analysis.verify_program`.
    """


def validate_program(prog: AcceleratorProgram,
                     chip: ChipSpec = None) -> None:
    """Check post-mapping invariants, raising :class:`CompileValidationError`
    naming the violated one (instead of failing deep inside the simulator).

    ``chip`` is required for single-chip programs (the program itself only
    records the mesh); mesh programs validate against ``prog.mesh``.

    Backward-compat wrapper over
    :func:`repro_torch.analysis.structural_diagnostics`: same checks, same order,
    same messages — first error raises.  For the full static verifier
    (dependences / progress / resources too) use
    :func:`repro_torch.analysis.verify_program`.
    """
    from ..analysis import structural_diagnostics
    diags = structural_diagnostics(prog, chip)
    for d in diags:
        if d.severity == "error":
            raise CompileValidationError(d.check, d.message)


def compile_model(graph: Graph, chip: ChipSpec, quantizer=None,
                  chips: int = 1, mesh: ChipMesh = None,
                  validate: bool = False, analyze: bool = False,
                  replicate=None, chip_cuts=None,
                  tune=None) -> AcceleratorProgram:
    """End-to-end compilation, optionally scaled out to a multi-chip mesh.

    ``chips=1`` (default) is the paper's single-chip flow, unchanged.
    ``chips=N`` builds a chain :class:`ChipMesh` of N copies of ``chip``
    (or uses ``mesh`` verbatim when given) and adds the chip-level pass:
    ``partition_chips`` cuts the partition chain across chips minimizing
    cross-chip bytes, ``map_partitions_mesh`` places each chip's partitions
    independently, and ``lower`` materializes the cut edges as inter-chip
    DMA streams — the LCU frontier tables are untouched (the polyhedral
    control logic is agnostic to *where* a dependence edge lands).

    ``validate=True`` runs :func:`validate_program` on the result — the
    post-mapping invariant checker that fails fast, by name, instead of
    deep inside a simulation.  ``analyze=True`` runs the full static
    verifier (:func:`repro_torch.analysis.verify_program`: dependency
    soundness, deadlock freedom, resource bounds) and raises
    :class:`CompileValidationError` on any error diagnostic.

    ``replicate`` turns on bottleneck-stage replication:
    ``"auto"`` runs :func:`partition.plan_replication` against the target's
    core budget and GCU stream rate, a ``{node_name: k}`` dict replicates
    the named stages explicitly (round-robin ``i mod k`` iteration split).

    ``chip_cuts`` (mesh flows only) overrides the chip partitioner's DP
    with explicit contiguous cut boundaries (``partition_chips(cuts=)``).

    ``tune`` (an autotuned configuration from ``repro.tune``) is not
    ported yet and raises ``NotImplementedError``.
    """
    if tune is not None:
        raise NotImplementedError(
            "compile_model(tune=...): the autotuner (repro.tune) is not "
            "ported yet; see ROADMAP.md, Queue 1, item 6 ('tune/')")
    if mesh is None and chips > 1:
        mesh = make_mesh(chips, chip=chip)
    if chip_cuts is not None and mesh is None:
        raise PartitionError(
            "chip_cuts given for a single-chip compile — cut points only "
            "exist on a mesh (pass chips=N or mesh=)")
    pg = partition_graph(graph)
    if replicate:
        if replicate == "auto":
            total = mesh.n_cores_total if mesh is not None else chip.n_cores
            base = mesh.chip if mesh is not None else chip
            plan = plan_replication(pg, total,
                                    base.dma_pixels_per_cycle)
        else:
            plan = dict(replicate)
        pg = replicate_partitions(pg, plan)
    if mesh is None:
        mapping = map_partitions(pg, chip)
        prog = lower(pg, mapping, quantizer=quantizer)
    else:
        chip_assign = partition_chips(pg, mesh, cuts=chip_cuts)
        mapping = map_partitions_mesh(pg, mesh, chip_assign)
        prog = lower(pg, mapping, quantizer=quantizer, mesh=mesh)
    if validate and not analyze:
        validate_program(prog, chip)
    if analyze:
        from ..analysis import verify_program
        report = verify_program(prog, chip)
        report.raise_if_errors(CompileValidationError)
    return prog


# ----------------------------------------------------- multi-tenant placement
@dataclasses.dataclass
class TenantPlacement:
    """Co-resident compiled programs on disjoint core sets of one chip/mesh.

    Weight-stationary residency: each tenant's crossbars are programmed once
    onto its own cores and never swapped, exactly like a single-tenant
    deployment — co-residency shares only the host GCU/DMA stream (and, on a
    mesh, the link fabric's accounting), so a tenant's *values* are bitwise
    those of the same program simulated alone; only timing can shift.
    """

    programs: List[AcceleratorProgram]
    core_ranges: List[Tuple[int, int]]     # per tenant: global core ids [lo, hi)
    chip: ChipSpec
    mesh: Optional[ChipMesh] = None

    @property
    def n_tenants(self) -> int:
        return len(self.programs)

    def tenant_of_core(self, core: int) -> int:
        for tk, (lo, hi) in enumerate(self.core_ranges):
            if lo <= core < hi:
                return tk
        raise KeyError(f"core {core} belongs to no tenant")


def place_tenants(graphs: Sequence[Graph], chip: ChipSpec,
                  mesh: Optional[ChipMesh] = None,
                  quantizer=None) -> TenantPlacement:
    """Compile several models for weight-stationary co-residency.

    Single chip: tenant ``j`` gets the next contiguous core window sized to
    its partition count; its mapping is solved against the window's induced
    interconnect (:func:`hwspec.subchip`) and offset to global core ids, so
    the per-tenant ``AcceleratorProgram`` is a valid stand-alone program on
    the shared chip.  Mesh: placement is chip-granular — tenant ``j`` gets a
    contiguous chip window (induced :func:`hwspec.submesh`), the chip-level
    partitioner runs inside the window, and the per-chip mapper + lowering
    run against the full mesh so cut edges ride the real links.

    The result's ``programs`` feed ``Simulator([...])`` / ``CmServer`` for a
    joint, contention-sharing simulation with separable per-tenant stats.
    """
    if mesh is not None:
        return _place_tenants_mesh(graphs, mesh, quantizer)
    programs: List[AcceleratorProgram] = []
    ranges: List[Tuple[int, int]] = []
    off = 0
    for j, g in enumerate(graphs):
        pg = partition_graph(g)
        need = len(pg.partitions)
        if off + need > chip.n_cores:
            raise MappingError(
                f"tenant {j} needs {need} cores but only "
                f"{chip.n_cores - off} of {chip.n_cores} remain")
        sub = subchip(chip, off, off + need)
        try:
            local = map_partitions(pg, sub)
        except MappingError as e:
            raise MappingError(
                f"tenant {j}: no mapping inside core window "
                f"[{off}, {off + need}): {e}") from e
        mapping = {p: c + off for p, c in local.items()}
        programs.append(lower(pg, mapping, quantizer=quantizer))
        ranges.append((off, off + need))
        off += need
    return TenantPlacement(programs=programs, core_ranges=ranges, chip=chip)


def _place_tenants_mesh(graphs, mesh: ChipMesh, quantizer) -> TenantPlacement:
    programs: List[AcceleratorProgram] = []
    ranges: List[Tuple[int, int]] = []
    cpc = mesh.chip.n_cores
    chip_off = 0
    for j, g in enumerate(graphs):
        pg = partition_graph(g)
        need_chips = -(-len(pg.partitions) // cpc)
        placed = None
        for k in range(need_chips, mesh.n_chips - chip_off + 1):
            try:
                sub = submesh(mesh, chip_off, chip_off + k)
                local_assign = partition_chips(pg, sub)
                placed = ({p: c + chip_off for p, c in local_assign.items()},
                          k)
                break
            except PartitionError:
                continue
        if placed is None:
            raise PartitionError(
                f"tenant {j}: no feasible chip window from chip {chip_off} "
                f"({mesh.n_chips - chip_off} chips left)")
        chip_assign, k = placed
        mapping = map_partitions_mesh(pg, mesh, chip_assign)
        programs.append(lower(pg, mapping, quantizer=quantizer, mesh=mesh))
        ranges.append((chip_off * cpc, (chip_off + k) * cpc))
        chip_off += k
    return TenantPlacement(programs=programs, core_ranges=ranges,
                           chip=mesh.chip, mesh=mesh)


def serialize_config(prog: AcceleratorProgram) -> str:
    """Serialized configuration bundle (initialization payload, paper §3)."""
    cores = {}
    for cid, cfg in prog.cores.items():
        cores[str(cid)] = dict(
            partition=cfg.partition_idx,
            iter_bounds=list(cfg.iter_bounds),
            repl_k=cfg.repl_k,
            repl_r=cfg.repl_r,
            xbar=(cfg.xbar_node.op if cfg.xbar_node else None),
            xbar_shape=(list(cfg.xbar_matrix.shape)
                        if cfg.xbar_matrix is not None else None),
            dpu_program=cfg.dpu_listing(),
            lcu={v: dict(src_partition=lc.src_partition,
                         pad=lc.pad,
                         shape=list(lc.shape),
                         s_code=lc.gen_src,
                         deps=[dict(src_partition=d.src_partition,
                                    s_code=d.gen_src)
                               for d in lc.deps])
                 for v, lc in cfg.lcu.items()},
        )
    bundle = dict(
        cores=cores,
        gcu=dict(input=prog.gcu.input_value,
                 input_shape=list(prog.gcu.input_shape),
                 dst_cores=prog.gcu.dst_cores,
                 outputs={k: list(v) for k, v in prog.gcu.outputs.items()}),
        mapping={str(k): v for k, v in prog.mapping.items()},
    )
    if prog.mesh is not None:
        bundle["mesh"] = dict(
            n_chips=prog.mesh.n_chips,
            cores_per_chip=prog.mesh.chip.n_cores,
            links=sorted(list(e) for e in prog.mesh.links),
            link=dict(latency=prog.mesh.link.latency,
                      width_bytes=prog.mesh.link.width_bytes),
            dma_streams=[dict(value=s.value, src_core=s.src_core,
                              dst_core=s.dst_core, src_chip=s.src_chip,
                              dst_chip=s.dst_chip)
                         for s in prog.dma_streams],
        )
    return json.dumps(bundle, indent=2)
