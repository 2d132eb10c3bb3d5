"""Entry point: run every static pass over a lowered program.

``verify_program`` is the one call sites use.  It resolves the ChipSpec,
rebuilds the static model once (shared by all passes), and runs, in order:

1. ``structural``   — the historical ``validate_program`` invariants
                      (cores-on-chip, cut-edge-link, sram-fits,
                      replica-group)
2. ``dependences``  — race freedom: compiled frontier ramps vs the
                      Appendix-A oracle, residue partitioning, coverage
3. ``progress``     — deadlock freedom: wait-for acyclicity, gate
                      totality, DMA-stream completeness
4. ``resources``    — SRAM high-water bound, link offered-load estimate

Everything lands in one :class:`~repro_torch.analysis.diagnostics.AnalysisReport`
whose ``backend`` records which polyhedral engine proved the result
(``"islpy"`` exact or ``"fisl"`` finite) — the guarantees are identical;
only the enumeration machinery differs, and the test suite pins verdict
parity between the two.

Port copy of ``repro.analysis.verifier``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..core import poly
from ..core.hwspec import ChipSpec
from ..core.lowering import AcceleratorProgram
from .diagnostics import AnalysisDiagnostic, AnalysisReport
from .dependences import dependence_diagnostics
from .model import build_model
from .progress import progress_diagnostics
from .resources import resource_diagnostics
from .structural import resolve_chip, structural_diagnostics

ALL_CHECKS: Tuple[str, ...] = ("structural", "dependences", "progress",
                               "resources")


def verify_program(prog: AcceleratorProgram,
                   chip: Optional[ChipSpec] = None, *,
                   max_inflight: int = 1,
                   checks: Sequence[str] = ALL_CHECKS) -> AnalysisReport:
    """Statically verify a lowered/mapped program; never raises on a broken
    program — findings come back as diagnostics (``report.raise_if_errors()``
    converts them when an exception is wanted).

    ``chip`` is required for single-chip programs (mesh programs carry
    theirs); ``max_inflight`` scales the SRAM high-water bound to the
    pipeline depth the serving runtime will use.
    """
    unknown = sorted(set(checks) - set(ALL_CHECKS))
    if unknown:
        raise ValueError(f"unknown checks {unknown}; pick from {ALL_CHECKS}")
    chip = resolve_chip(prog, chip)
    report = AnalysisReport(backend="islpy" if poly.HAVE_ISL else "fisl",
                            checks_run=tuple(c for c in ALL_CHECKS
                                             if c in checks))
    diags: list[AnalysisDiagnostic] = []
    if "structural" in checks:
        diags.extend(structural_diagnostics(prog, chip))
    need_model = any(c in checks for c in ("dependences", "progress",
                                           "resources"))
    if need_model:
        models, model_diags = build_model(prog)
        diags.extend(model_diags)
        report.metrics["cores_modeled"] = len(models)
        if "dependences" in checks:
            dd, dm = dependence_diagnostics(models)
            diags.extend(dd)
            report.metrics.update(dm)
        if "progress" in checks:
            pd, pm = progress_diagnostics(prog, models)
            diags.extend(pd)
            report.metrics.update(pm)
        if "resources" in checks:
            rd, rm = resource_diagnostics(prog, chip, models,
                                          max_inflight=max_inflight)
            diags.extend(rd)
            report.metrics.update(rm)
    report.diagnostics = diags
    return report
