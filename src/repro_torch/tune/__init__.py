"""Design-space autotuner over the event simulator.

``autotune`` searches partition cut points, stage replication factors,
tenant placement order, and mesh chip counts/topologies with a seeded,
wall-clock-free staged funnel: structural/SRAM pre-filter → static
interval ranking → event-engine simulation of the shortlist, with moves
guided by ``obs.critical_path``.  Winning configurations are committed
as ``configs/tuned/*.json`` and loaded by
``compile_model(..., tune="lenet")``; ``python -m repro_torch.tune
--model <name> --check`` re-runs a recorded search and fails unless the
artifact reproduces bit-for-bit.

Port copy of ``repro.tune``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_tune.py`` holds the two equal.
"""

from .artifacts import (ARTIFACT_FORMAT, TUNED_DIR, ZOO, ZooEntry,
                        artifact_dict, artifact_json, load_tuned,
                        resolve_tuned, tune_zoo_entry)
from .search import TRIAL_STAGES, Trial, TuneResult, autotune
from .space import SearchSpace, TuneConfig, TuneWorkload, plan_key

__all__ = [
    "ARTIFACT_FORMAT",
    "SearchSpace",
    "TRIAL_STAGES",
    "TUNED_DIR",
    "Trial",
    "TuneConfig",
    "TuneResult",
    "TuneWorkload",
    "ZOO",
    "ZooEntry",
    "artifact_dict",
    "artifact_json",
    "autotune",
    "load_tuned",
    "plan_key",
    "resolve_tuned",
    "tune_zoo_entry",
]
