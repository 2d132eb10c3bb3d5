"""Committed tuned-config artifacts: the search's winners, on disk.

An artifact (``configs/tuned/<name>.json``) records everything needed to
(a) *use* the winning config — ``compile_model(..., tune="lenet")`` loads
it and applies its replication plan / mesh shape / cut points — and (b)
*reproduce* it bit-for-bit: the model + chip are named by constructor
arguments (never by object dumps, whose iteration order is not
canonical), and the seed/budget/space/workload pin the search.  The CI
``autotune-smoke`` job re-runs the recorded search and asserts the
regenerated file is byte-identical to the committed one.

The zoo below is the closed set of models an artifact may reference —
artifacts name a zoo entry, they do not embed arbitrary code.

Port copy of ``repro.tune.artifacts``: the same code, with every import
inside ``repro_torch``; ``tests/test_torch_tune.py`` holds the two equal.
``TUNED_DIR`` is the repo's one ``configs/tuned/``, the directory the
reference records into: the port reads it, tunes to the same bytes, and
has no writer (``write_artifact`` stays in ``repro.tune``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Callable, Dict, Union

from ..core.graph import Graph, build_lenet_like, build_resnet_block_chain
from ..core.hwspec import ChipSpec, make_chip
from .search import TuneResult, autotune
from .space import SearchSpace, TuneConfig, TuneWorkload

#: Repo-relative directory the committed artifacts live in.
TUNED_DIR = pathlib.Path(__file__).resolve().parents[3] / "configs" / "tuned"

ARTIFACT_FORMAT = 1


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    """A searchable (model, target, search recipe) triple.

    ``chip_kw`` are ``make_chip`` arguments — the canonical, orderable
    way to name a chip (a ``ChipSpec``'s edge frozenset has no stable
    iteration order, so specs are never serialized directly).
    """

    name: str
    build: Callable[[], Graph]
    chip_kw: Dict[str, Any]
    budget: int
    seed: int
    space: SearchSpace
    workload: TuneWorkload

    def chip(self) -> ChipSpec:
        kw = dict(self.chip_kw)
        return make_chip(kw.pop("n_cores"), kw.pop("topology"), **kw)


#: The searchable model zoo.  lenet mirrors the replication benchmark's
#: headline target (18 cores, wide DMA) so the tuned row is directly
#: comparable to the committed ``replicate="auto"`` pipeline benchmark;
#: resnet4 gets a 2-chip axis — the single-chip auto heuristic cannot see
#: scale-out, so the tuner has real headroom to beat it, not just to
#: match it.
ZOO: Dict[str, ZooEntry] = {
    "lenet": ZooEntry(
        name="lenet",
        build=lambda: build_lenet_like(),
        chip_kw={"n_cores": 18, "topology": "all_to_all",
                 "dma_pixels_per_cycle": 16},
        budget=24,
        seed=0,
        space=SearchSpace(max_repl_k=16, chip_counts=(1,),
                          topologies=("chain",), batch=8, shortlist=3),
        workload=TuneWorkload(n_images=8, schedule="pipelined", seed=0),
    ),
    "resnet4": ZooEntry(
        name="resnet4",
        build=lambda: build_resnet_block_chain(4),
        chip_kw={"n_cores": 16, "topology": "all_to_all",
                 "dma_pixels_per_cycle": 16},
        budget=20,
        seed=0,
        space=SearchSpace(max_repl_k=4, chip_counts=(1, 2),
                          topologies=("chain", "ring"), batch=6,
                          shortlist=3),
        workload=TuneWorkload(n_images=8, schedule="pipelined", seed=0),
    ),
}


def tune_zoo_entry(name: str) -> TuneResult:
    """Run the recorded search for a zoo entry (the reproduction path)."""
    entry = ZOO[name]
    return autotune(entry.build(), entry.chip(), entry.workload,
                    entry.budget, seed=entry.seed, space=entry.space,
                    label=entry.name)


def artifact_dict(result: TuneResult) -> Dict[str, Any]:
    """The committed-artifact payload for a zoo search result.

    Trial-level trajectory is *not* embedded (it ships as a CI build
    artifact instead) — the committed file carries only what loading and
    reproducing need, so review diffs stay small.
    """
    entry = ZOO.get(result.label)
    if entry is None:
        raise ValueError(
            f"cannot build a committed artifact for label "
            f"{result.label!r}: artifacts name the (model, chip) pair by "
            f"zoo entry, so the result must come from a search labelled "
            f"with one of {sorted(ZOO)} (see tune_zoo_entry)")
    return {
        "format": ARTIFACT_FORMAT,
        "model": result.label,
        "chip": dict(sorted(entry.chip_kw.items())),
        "search": {
            "seed": result.seed,
            "budget": result.budget,
            "space": result.space.to_json_dict(),
            "workload": result.workload.to_json_dict(),
        },
        "config": result.best.to_json_dict(),
        "cycles": result.best_cycles,
        "baseline": {
            "config": result.baseline.to_json_dict(),
            "cycles": result.baseline_cycles,
        },
        "counts": result.counts,
    }


def artifact_json(result: TuneResult) -> str:
    """Canonical bytes of the committed artifact (sorted keys, 2-space
    indent, trailing newline) — the unit of the CI bit-for-bit check."""
    return json.dumps(artifact_dict(result), indent=2, sort_keys=True) + "\n"


def load_tuned(name_or_path: Union[str, pathlib.Path]) -> Dict[str, Any]:
    """Read a tuned artifact by zoo name (from ``configs/tuned/``) or by
    explicit path; validates the format marker."""
    p = pathlib.Path(name_or_path)
    if p.suffix != ".json":
        p = TUNED_DIR / f"{p.name}.json"
    if not p.exists():
        known = sorted(q.stem for q in TUNED_DIR.glob("*.json")) \
            if TUNED_DIR.is_dir() else []
        raise FileNotFoundError(
            f"no tuned config {str(name_or_path)!r} (looked at {p}); "
            f"committed configs: {known or 'none'}")
    d = json.loads(p.read_text())
    if d.get("format") != ARTIFACT_FORMAT:
        raise ValueError(f"{p}: unsupported tuned-artifact format "
                         f"{d.get('format')!r} (expected {ARTIFACT_FORMAT})")
    return d


def resolve_tuned(tune: Union[str, pathlib.Path, TuneConfig, TuneResult,
                              Dict[str, Any]]) -> TuneConfig:
    """What ``compile_model(tune=...)`` accepts: a zoo/artifact name or
    path, an artifact dict, a :class:`TuneResult` (its winning config),
    or an already-built :class:`TuneConfig`."""
    if isinstance(tune, TuneConfig):
        return tune
    if isinstance(tune, TuneResult):
        return tune.best
    if isinstance(tune, dict):
        d = tune
    else:
        d = load_tuned(tune)
    cfg = d.get("config", d)
    return TuneConfig.from_json_dict(cfg)
