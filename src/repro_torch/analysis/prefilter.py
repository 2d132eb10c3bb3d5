"""Cheap candidate screen for design-space search (the autotuner's funnel).

``verify_program`` proves dependency soundness by enumerating every
relation stream and replaying every frontier ramp — worth paying once per
*shipped* program, far too expensive inside a search loop that considers
dozens of candidate configurations per second.  ``prefilter_program`` runs
only the passes that need no static model rebuild:

  * the structural invariants (cores-on-chip, cut-edge-link, sram-fits,
    replica-group) — any error means the candidate is wrong by
    construction and must be discarded without simulating it;
  * the static SRAM high-water bound per core (the same
    ``simulator.static_core_sram_bytes`` contract pass 3 uses).

Besides pass/fail, the report's metrics are the search's *feasibility
margins* — gradient-free signals a tuner can rank or mutate against:
``sram_bound_bytes`` (per core), ``sram_margin_bytes`` (the tightest
core's spare capacity; negative margins always come with an error
diagnostic), and ``image_interval_cycles`` (the static steady-state
per-image service of the slowest stage, the quantity the autotuner's
ranking stage orders candidates by before spending simulations).

Candidates that fail to *compile* at all (``PartitionError`` /
``MappingError``) never reach this function — the search catches those
even earlier, also for free.

Port copy of ``repro.analysis.prefilter``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..core import poly
from ..core.hwspec import ChipSpec
from ..core.lowering import AcceleratorProgram
from .diagnostics import AnalysisReport
from .resources import image_interval, sram_diagnostics
from .structural import resolve_chip, structural_diagnostics

#: The subset of the verifier's work a pre-filter run performs.
PREFILTER_CHECKS: Tuple[str, ...] = ("structural", "sram")


def prefilter_program(prog: AcceleratorProgram,
                      chip: Optional[ChipSpec] = None, *,
                      max_inflight: int = 1) -> AnalysisReport:
    """Screen one lowered candidate program without a model rebuild.

    Returns an :class:`AnalysisReport` whose error diagnostics mean
    "unsimulatable or wrong by construction — discard for free", and whose
    metrics carry the feasibility margins described in the module
    docstring.  A clean pre-filter is *not* the full verifier's guarantee:
    dependency soundness, deadlock freedom, and link loads are only
    checked by :func:`repro_torch.analysis.verify_program`.
    """
    chip = resolve_chip(prog, chip)
    report = AnalysisReport(backend="islpy" if poly.HAVE_ISL else "fisl",
                            checks_run=PREFILTER_CHECKS)
    diags = list(structural_diagnostics(prog, chip))
    sram_d, bounds = sram_diagnostics(prog, chip, max_inflight)
    diags.extend(sram_d)
    cap = chip.core.sram_bytes
    report.metrics["sram_bound_bytes"] = bounds
    report.metrics["sram_margin_bytes"] = min(
        (cap - b for b in bounds.values()), default=cap)
    report.metrics["image_interval_cycles"] = image_interval(prog, chip)
    report.diagnostics = diags
    return report
