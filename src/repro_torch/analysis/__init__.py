"""Static checks on lowered CM programs: the part of ``repro.analysis``
that ``compile_model``/``validate_program`` need (structured diagnostics and
the structural, mapping-level checks).  The full verifier (``verify_program``)
and the autotuner's prefilter are not ported yet.
"""

from .diagnostics import (AnalysisDiagnostic, AnalysisError, AnalysisReport,
                          SEVERITIES)
from .structural import resolve_chip, structural_diagnostics

__all__ = [
    "AnalysisDiagnostic",
    "AnalysisError",
    "AnalysisReport",
    "SEVERITIES",
    "resolve_chip",
    "structural_diagnostics",
]
