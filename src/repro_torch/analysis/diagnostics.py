"""Structured diagnostics for the static program verifier.

One :class:`AnalysisDiagnostic` per violated (or suspicious) property of a
lowered program, named by check so tests and callers can assert on the
class of problem rather than parse messages.  :class:`AnalysisReport`
bundles everything one ``verify_program`` run (not ported yet) found,
plus the static metrics (SRAM bounds, link loads) the passes computed on
the way.

This module deliberately imports nothing from the rest of the package:
``repro_torch.core.compiler`` derives its backward-compatible
``CompileValidationError`` from :class:`AnalysisError`, and keeping this
file dependency-free makes that import cycle-proof.

Port copy of ``repro.analysis.diagnostics``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

#: Diagnostic severities, strongest first.
SEVERITIES: Tuple[str, ...] = ("error", "warning")


class AnalysisError(Exception):
    """A verified program violates a statically-provable invariant.

    ``invariant`` names the violated check (e.g. ``"frontier-unsound"``,
    ``"sram-highwater"``, or one of the structural names
    ``"cores-on-chip"`` / ``"cut-edge-link"`` / ``"sram-fits"`` /
    ``"replica-group"``).  ``repro_torch.core.compiler.CompileValidationError``
    is a thin subclass kept for backward compatibility.
    """

    def __init__(self, invariant: str, message: str):
        super().__init__(f"[{invariant}] {message}")
        self.invariant = invariant


@dataclasses.dataclass(frozen=True)
class AnalysisDiagnostic:
    """One named finding of the static verifier.

    ``check`` is the stable machine-readable name (kebab-case);
    ``severity`` is ``"error"`` (the program is provably broken — it races,
    deadlocks, or cannot fit) or ``"warning"`` (a static estimate flags a
    hazard simulation would have to confirm, e.g. link offered load above
    1.0).  ``core``/``value`` locate the finding when it is attributable to
    one core / one LCU input array.
    """

    check: str
    severity: str
    message: str
    core: Optional[int] = None
    value: Optional[str] = None

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def __str__(self) -> str:
        where = ""
        if self.core is not None:
            where += f" core={self.core}"
        if self.value is not None:
            where += f" value={self.value!r}"
        return f"[{self.check}]{where} {self.message}"


@dataclasses.dataclass
class AnalysisReport:
    """Everything one ``verify_program`` run established.

    ``diagnostics`` preserves discovery order (structural checks first, in
    the historical ``validate_program`` order — the first error is the one
    the legacy API raises).  ``metrics`` carries the static bounds the
    passes computed even when no check fired (per-core SRAM bounds, link
    offered loads, counts), ``backend`` records which polyhedral engine ran
    (``"islpy"`` or ``"fisl"``), and ``checks_run`` which passes executed.
    """

    diagnostics: List[AnalysisDiagnostic] = dataclasses.field(
        default_factory=list)
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    backend: str = "unknown"
    checks_run: Tuple[str, ...] = ()

    def errors(self) -> List[AnalysisDiagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def warnings(self) -> List[AnalysisDiagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        """True when no *error* diagnostics were found."""
        return not self.errors()

    def checks(self) -> Tuple[str, ...]:
        """The distinct check names that fired, in discovery order."""
        seen: List[str] = []
        for d in self.diagnostics:
            if d.check not in seen:
                seen.append(d.check)
        return tuple(seen)

    def raise_if_errors(self, exc_type: type = AnalysisError) -> None:
        """Raise ``exc_type(first_error.check, all error messages)``."""
        errs = self.errors()
        if not errs:
            return
        detail = errs[0].message
        if len(errs) > 1:
            detail += f" (+{len(errs) - 1} more: " + "; ".join(
                f"[{d.check}] {d.message}" for d in errs[1:]) + ")"
        raise exc_type(errs[0].check, detail)

    def summary(self) -> str:
        n_err, n_warn = len(self.errors()), len(self.warnings())
        status = "OK" if self.ok else "FAIL"
        return (f"{status}: {n_err} errors, {n_warn} warnings "
                f"(backend={self.backend}, passes={','.join(self.checks_run)})")
