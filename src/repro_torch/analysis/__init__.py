"""Static program verifier for lowered CM accelerator programs.

Proves, before any simulation: dependency soundness / race freedom (the
compiled frontier automata never admit a read before its Appendix-A
writer, and replica residues partition every writer domain exactly),
deadlock freedom (acyclic stage wait-for graph, every gate lifts by
stream end, every cross-chip gate has its DMA stream), and static
resource bounds (per-core SRAM high-water vs. capacity, link offered
load).  Works against both polyhedral backends — islpy exact and the
fisl finite fallback — with identical verdicts.

Entry point: :func:`verify_program`.  ``repro_torch.core.compiler`` routes
``validate_program`` / ``compile_model(..., analyze=True)`` through here.

Port copy of ``repro.analysis``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from .diagnostics import (AnalysisDiagnostic, AnalysisError, AnalysisReport,
                          SEVERITIES)
from .model import build_model
from .prefilter import PREFILTER_CHECKS, prefilter_program
from .resources import image_interval, sram_diagnostics
from .structural import resolve_chip, structural_diagnostics
from .verifier import ALL_CHECKS, verify_program

__all__ = [
    "ALL_CHECKS",
    "AnalysisDiagnostic",
    "AnalysisError",
    "AnalysisReport",
    "PREFILTER_CHECKS",
    "SEVERITIES",
    "build_model",
    "image_interval",
    "prefilter_program",
    "resolve_chip",
    "sram_diagnostics",
    "structural_diagnostics",
    "verify_program",
]
