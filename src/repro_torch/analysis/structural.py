"""Structural (mapping-level) checks, ported from ``validate_program``.

The four historical post-mapping invariants — ``cores-on-chip``,
``cut-edge-link``, ``sram-fits``, ``replica-group`` — now emitted as
:class:`~repro_torch.analysis.diagnostics.AnalysisDiagnostic` lists instead of a
first-failure exception.  Check order and message text are preserved
exactly, so ``repro_torch.core.compiler.validate_program`` (the thin
backward-compat wrapper) raises the same error for the same program.

Unlike the legacy raise-on-first-error flow, a later check group runs even
when an earlier one found problems; each group is shielded so a program
mangled enough to crash one check still yields the earlier groups'
findings (reported as a ``verifier-crash`` diagnostic instead of an
exception escaping the verifier).

Port copy of ``repro.analysis.structural``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..core.hwspec import ChipSpec
from ..core.lowering import AcceleratorProgram
from ..core.simulator import static_core_sram_bytes
from .diagnostics import AnalysisDiagnostic


def _err(check: str, message: str, core: Optional[int] = None,
         value: Optional[str] = None) -> AnalysisDiagnostic:
    return AnalysisDiagnostic(check=check, severity="error", message=message,
                              core=core, value=value)


def resolve_chip(prog: AcceleratorProgram,
                 chip: Optional[ChipSpec]) -> ChipSpec:
    """The ChipSpec a program validates against (mesh programs carry it)."""
    if chip is None:
        if prog.mesh is None:
            raise ValueError("validate_program needs the ChipSpec for "
                             "single-chip programs")
        chip = prog.mesh.chip
    return chip


def _check_cores_on_chip(prog: AcceleratorProgram,
                         chip: ChipSpec) -> List[AnalysisDiagnostic]:
    mesh = prog.mesh
    total = mesh.n_cores_total if mesh is not None else chip.n_cores
    out: List[AnalysisDiagnostic] = []
    for p, c in sorted(prog.mapping.items()):
        if not 0 <= c < total:
            out.append(_err(
                "cores-on-chip",
                f"partition {p} mapped to core {c} outside [0, {total})"))
        elif c not in prog.cores:
            out.append(_err(
                "cores-on-chip",
                f"partition {p} mapped to core {c} with no CoreConfig"))
    for cid in prog.cores:
        if not 0 <= cid < total:
            out.append(_err(
                "cores-on-chip", f"core id {cid} outside [0, {total})",
                core=cid))
    return out


def _check_cut_edge_link(prog: AcceleratorProgram,
                         chip: ChipSpec) -> List[AnalysisDiagnostic]:
    # every cut edge rides a link: intra-chip edges need an interconnect
    # edge, cross-chip edges need a mesh link (GCU input, src_partition -1,
    # arrives through GMEM and needs neither)
    mesh = prog.mesh
    out: List[AnalysisDiagnostic] = []
    for cid, cfg in sorted(prog.cores.items()):
        for v, lc in cfg.lcu.items():
            for dp in lc.deps:
                if dp.src_partition < 0:
                    continue
                src = prog.mapping.get(dp.src_partition)
                if src is None:
                    out.append(_err(
                        "cut-edge-link",
                        f"core {cid} input {v!r} from unmapped partition "
                        f"{dp.src_partition}", core=cid, value=v))
                    continue
                if src == cid:
                    continue
                if mesh is not None:
                    ca, cb = mesh.chip_of(src), mesh.chip_of(cid)
                    if ca != cb:
                        if (ca, cb) not in mesh.links:
                            out.append(_err(
                                "cut-edge-link",
                                f"edge core {src} -> {cid} ({v!r}) needs "
                                f"mesh link ({ca}, {cb}) which does not "
                                f"exist", core=cid, value=v))
                        continue
                    la, lb = mesh.local_core(src), mesh.local_core(cid)
                    if (la, lb) not in mesh.chip.edges:
                        out.append(_err(
                            "cut-edge-link",
                            f"edge core {src} -> {cid} ({v!r}) has no "
                            f"interconnect edge ({la}, {lb}) on chip {ca}",
                            core=cid, value=v))
                elif (src, cid) not in chip.edges:
                    out.append(_err(
                        "cut-edge-link",
                        f"edge core {src} -> {cid} ({v!r}) has no "
                        f"interconnect edge on the chip", core=cid, value=v))
    return out


def _check_sram_fits(prog: AcceleratorProgram,
                     chip: ChipSpec) -> List[AnalysisDiagnostic]:
    # static SRAM footprint fits the core spec: padded float32 input buffers
    # + pool accumulators (what the simulator actually allocates per
    # in-flight image) — the single definition in simulator.py
    values = prog.pgraph.graph.values
    out: List[AnalysisDiagnostic] = []
    for cid, cfg in sorted(prog.cores.items()):
        need = static_core_sram_bytes(cfg, values)
        if need > chip.core.sram_bytes:
            out.append(_err(
                "sram-fits",
                f"core {cid}: static SRAM footprint {need}B > "
                f"{chip.core.sram_bytes}B spec", core=cid))
    return out


def _check_replica_groups(prog: AcceleratorProgram,
                          chip: ChipSpec) -> List[AnalysisDiagnostic]:
    # replica groups honor the replication contract: k distinct cores,
    # identical iteration boxes, residues exactly 0..k-1, and every consumer
    # of the group carries one dependency automaton per replica (the
    # max-merge over k interleaved producer streams needs all k frontiers)
    out: List[AnalysisDiagnostic] = []
    for leader, members in sorted(prog.pgraph.replica_groups.items()):
        k = len(members)
        cores = []
        missing = False
        for p in members:
            c = prog.mapping.get(p)
            if c is None or c not in prog.cores:
                out.append(_err(
                    "replica-group",
                    f"replica partition {p} of group {leader} has no core"))
                missing = True
                continue
            cores.append(c)
        if missing:
            continue
        if len(set(cores)) != k:
            out.append(_err(
                "replica-group",
                f"group {leader}: replicas share cores {sorted(cores)}"))
        cfgs = [prog.cores[c] for c in cores]
        if len({c.iter_bounds for c in cfgs}) != 1:
            out.append(_err(
                "replica-group",
                f"group {leader}: replicas disagree on iteration bounds"))
        if (sorted(c.repl_r for c in cfgs) != list(range(k))
                or any(c.repl_k != k for c in cfgs)):
            out.append(_err(
                "replica-group",
                f"group {leader}: residues "
                f"{sorted(c.repl_r for c in cfgs)} != 0..{k - 1} "
                f"or wrong modulus"))
        mset = frozenset(members)
        for cid, cfg in sorted(prog.cores.items()):
            for v, lc in cfg.lcu.items():
                hits = sorted(dp.src_partition for dp in lc.deps
                              if dp.src_partition in mset)
                if hits and hits != sorted(members):
                    out.append(_err(
                        "replica-group",
                        f"core {cid} input {v!r} depends on replicas "
                        f"{hits} of group {leader}, expected all of "
                        f"{sorted(members)}", core=cid, value=v))
    return out


_CHECKS: List[Callable[[AcceleratorProgram, ChipSpec],
                       List[AnalysisDiagnostic]]] = [
    _check_cores_on_chip,
    _check_cut_edge_link,
    _check_sram_fits,
    _check_replica_groups,
]


def structural_diagnostics(prog: AcceleratorProgram,
                           chip: Optional[ChipSpec] = None
                           ) -> List[AnalysisDiagnostic]:
    """Run the four structural invariant checks, collecting all findings.

    Raises ``ValueError`` (not a diagnostic) when ``chip`` is missing for a
    single-chip program — that is an API misuse, not a program property.
    """
    chip = resolve_chip(prog, chip)
    out: List[AnalysisDiagnostic] = []
    for check in _CHECKS:
        try:
            out.extend(check(prog, chip))
        except Exception as e:  # a broken program must not crash the verifier
            out.append(_err(
                "verifier-crash",
                f"{check.__name__} crashed on this program: {e!r}"))
    return out
