"""Pass 3 — static resource bounds.

**SRAM high-water** (``sram-highwater``, error): every input buffer a
core's LCU tracks is live for the whole image (the frontier may admit the
last iteration only after the last write, so no chunk is reclaimable
before image end), and the pipelined runtime keeps up to ``max_inflight``
images resident per core.  The per-image footprint is
:func:`repro_torch.core.simulator.static_core_sram_bytes` — the simulator's own
allocation contract (padded float32 input planes + pool accumulators) — so
``footprint * max_inflight`` is a sound upper bound on the core's SRAM
high-water mark, checked against ``CoreSpec.sram_bytes``.  The bound for
every core lands in ``metrics["sram_bound_bytes"]`` even when it fits.

**Link offered load** (``link-load``, warning): for each inter-chip link,
the bytes all its DMA streams move per image (each producer iteration
ships its finalized locations as one message, ``4`` bytes per float32
element, rounded up to link beats) divided by the steady-state image
interval — the slowest stage's per-image cycle count (GCU pixel streaming
or the largest per-core iteration count).  Offered load above 1.0 means
the static schedule asks the link for more beat-slots than exist; that is
a hazard estimate, not a proof of failure (queueing may only add latency),
hence a warning.  Loads land in ``metrics["link_load"]``.

Port copy of ``repro.analysis.resources``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ..core.hwspec import ChipSpec
from ..core.lowering import AcceleratorProgram
from ..core.simulator import static_core_sram_bytes
from .diagnostics import AnalysisDiagnostic
from .model import CoreModel


def _n_local(bounds: Tuple[int, ...], k: int, r: int) -> int:
    total = int(np.prod(bounds))
    if r >= total:
        return 0
    return (total - r + k - 1) // k


def _image_interval(prog: AcceleratorProgram, chip: ChipSpec) -> int:
    """Steady-state cycles between images: the slowest pipeline stage."""
    graph = prog.pgraph.graph
    in_shape = graph.values[graph.inputs[0]].shape
    pixels = int(np.prod(in_shape[-2:]))
    t = math.ceil(pixels / chip.dma_pixels_per_cycle)
    for cfg in prog.cores.values():
        t = max(t, _n_local(tuple(cfg.iter_bounds), int(cfg.repl_k),
                            int(cfg.repl_r)))
    return max(t, 1)


def _check_sram(prog: AcceleratorProgram, chip: ChipSpec,
                max_inflight: int) -> Tuple[List[AnalysisDiagnostic],
                                            Dict[int, int]]:
    values = prog.pgraph.graph.values
    out: List[AnalysisDiagnostic] = []
    bounds: Dict[int, int] = {}
    cap = chip.core.sram_bytes
    for cid, cfg in sorted(prog.cores.items()):
        need = static_core_sram_bytes(cfg, values) * max_inflight
        bounds[cid] = need
        if need > cap:
            out.append(AnalysisDiagnostic(
                check="sram-highwater", severity="error",
                message=(f"core {cid}: SRAM high-water bound {need}B "
                         f"({max_inflight} in-flight images) exceeds the "
                         f"{cap}B core capacity"), core=cid))
    return out, bounds


def _check_links(prog: AcceleratorProgram, models: List[CoreModel]
                 ) -> Tuple[List[AnalysisDiagnostic], Dict[str, float]]:
    if prog.mesh is None or not prog.dma_streams:
        return [], {}
    by_core = {cm.core_id: cm for cm in models}
    interval = _image_interval(prog, prog.mesh.chip)
    busy: Dict[Tuple[int, int], int] = {}
    for st in prog.dma_streams:
        cm = by_core.get(st.dst_core)
        vm = cm.values.get(st.value) if cm is not None else None
        dm = None
        if vm is not None:
            for cand in vm.deps:
                if cand.producer_core == st.src_core:
                    dm = cand
                    break
        if dm is None:
            continue  # unmodelable stream: passes 1/2 report the cause
        beats = 0
        if len(dm.writers):
            per_msg = np.bincount(dm.w_idx, minlength=len(dm.writers))
            for n in per_msg:
                if n:
                    beats += st.link.beats(4 * int(n))
        key = (st.src_chip, st.dst_chip)
        busy[key] = busy.get(key, 0) + beats
    out: List[AnalysisDiagnostic] = []
    loads: Dict[str, float] = {}
    for (a, b), nbeats in sorted(busy.items()):
        load = nbeats / interval
        loads[f"{a}->{b}"] = round(load, 4)
        if load > 1.0:
            out.append(AnalysisDiagnostic(
                check="link-load", severity="warning",
                message=(f"link {a}->{b}: static offered load {load:.2f} "
                         f"({nbeats} beats per {interval}-cycle image "
                         f"interval) exceeds capacity — expect queueing")))
    return out, loads


def sram_diagnostics(prog: AcceleratorProgram, chip: ChipSpec,
                     max_inflight: int = 1
                     ) -> Tuple[List[AnalysisDiagnostic], Dict[int, int]]:
    """The SRAM half of pass 3, standalone: ``(diagnostics, per-core
    bound)``.  Needs no static model (O(cores) dict walks), which is what
    lets :func:`repro_torch.analysis.prefilter_program` screen design-space
    candidates without paying for relation enumeration."""
    return _check_sram(prog, chip, max_inflight)


def image_interval(prog: AcceleratorProgram, chip: ChipSpec) -> int:
    """Static steady-state cycles between images — the slowest pipeline
    stage's per-image service (GCU pixel streaming or the largest per-core
    residue-local iteration count).  The denominator of the link-load
    estimate, exposed for the autotuner's static ranking stage."""
    return _image_interval(prog, chip)


def resource_diagnostics(prog: AcceleratorProgram, chip: ChipSpec,
                         models: List[CoreModel], max_inflight: int = 1
                         ) -> Tuple[List[AnalysisDiagnostic],
                                    Dict[str, object]]:
    """Run pass 3; returns (diagnostics, metrics)."""
    sram_diags, sram_bounds = _check_sram(prog, chip, max_inflight)
    link_diags, link_loads = _check_links(prog, models)
    metrics: Dict[str, object] = {
        "sram_bound_bytes": sram_bounds,
        "max_inflight": max_inflight,
    }
    if link_loads:
        metrics["link_load"] = link_loads
    return sram_diags + link_diags, metrics
