"""Seeded design-space search over the event simulator.

``autotune`` assembles the ingredients PRs 7-9 built into one loop:

  * **candidate generation** — enumerable neighborhoods from
    ``core.partition`` (``replicable_stages``, ``cut_neighbors``) over the
    axes in :mod:`repro_torch.tune.space`, plus *guided* moves from
    ``obs.critical_path``: the search attacks the named binding resource
    of the best simulated candidate (replicate the bottleneck stage,
    re-cut around the hot link, stop replicating when the GCU stream
    binds) instead of random-walking;
  * **staged funnel** — each candidate first compiles (``PartitionError``
    / ``MappingError`` discard it for free), then passes
    ``analysis.prefilter_program`` (structural + SRAM-bound errors
    discard it for free, and its ``image_interval_cycles`` metric is the
    static rank), and only the top ``SearchSpace.shortlist`` of a round's
    survivors are *simulated* — the event engine is the cost model, but
    it is the funnel's last stage, not its first;
  * **annealing skeleton** (after ``launch/hillclimb.py``'s
    variant-walk) — each round expands the neighborhood of an incumbent
    config; a worse simulated candidate can replace the incumbent with
    probability ``exp(-rel_delta / T)`` under a geometrically decaying
    temperature, all drawn from the one seeded generator.

Determinism contract: same (model, chip, workload, budget, seed, space)
⇒ bitwise-identical :class:`TuneResult` (and therefore byte-identical
``to_json()``).  Nothing in this module reads a clock or iterates an
unordered container into the result; the only randomness is
``np.random.default_rng(seed)``, drawn in a fixed order.  Simulated
cycle counts are backend-independent (the islpy and fisl polyhedral
backends compile identical frontier tables — pinned by
``tests/test_frontier_tables.py``), so a committed artifact reproduces
on either CI leg.

The cost model is the event engine on the numpy plane, as in the
reference: cycle counters do not depend on the plane, and the committed
artifacts depend on those counters.

Port copy of ``repro.tune.search``: the same code, with every import
inside ``repro_torch``; ``tests/test_torch_tune.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.compiler import compile_model, place_tenants
from ..core.graph import Graph
from ..core.hwspec import ChipMesh, ChipSpec, make_mesh
from ..core.lowering import AcceleratorProgram
from ..core.mapping import MappingError
from ..core.partition import (PartitionError, chip_cuts_of, cut_neighbors,
                              partition_chips, partition_graph,
                              plan_replication, replicable_stages,
                              replicate_partitions)
from ..core.simulator import Simulator
from ..analysis import prefilter_program
from ..obs.critical import CriticalPath, critical_path, propose_moves
from .space import SearchSpace, TuneConfig, TuneWorkload, plan_key

#: Funnel stages a trial can end in (the accounting contract: every
#: considered candidate lands in exactly one, and only ``"simulated"``
#: trials ever reach the event engine).
TRIAL_STAGES: Tuple[str, ...] = ("compile-error", "prefilter-discard",
                                 "ranked-out", "simulated")


@dataclasses.dataclass(frozen=True)
class Trial:
    """One considered candidate: where it left the funnel and why."""

    index: int
    config: TuneConfig
    provenance: str                 # "seed" | "auto" | "guided:<target>" |
    #                                 "neighbor" | "explore"
    stage: str                      # one of TRIAL_STAGES
    static_interval: Optional[int]  # static per-image cycles (rank key)
    cycles: Optional[int]           # simulated; None unless stage=simulated
    n_cores: Optional[int]          # mapped cores; None before lowering
    detail: str = ""                # discard reason / shortlist position

    def to_json_dict(self) -> Dict[str, Any]:
        return {"index": self.index, "config": self.config.key(),
                "provenance": self.provenance, "stage": self.stage,
                "static_interval": self.static_interval,
                "cycles": self.cycles, "n_cores": self.n_cores,
                "detail": self.detail}


@dataclasses.dataclass
class TuneResult:
    """Everything one seeded search established, bitwise-reproducible."""

    label: str
    seed: int
    budget: int
    space: SearchSpace
    workload: TuneWorkload
    best: TuneConfig
    best_cycles: int
    baseline: TuneConfig
    baseline_cycles: int
    trials: List[Trial]

    @property
    def counts(self) -> Dict[str, int]:
        c = {s: 0 for s in TRIAL_STAGES}
        for t in self.trials:
            c[t.stage] += 1
        c["candidates"] = len(self.trials)
        return c

    @property
    def n_simulated(self) -> int:
        return self.counts["simulated"]

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "format": 1,
            "label": self.label,
            "seed": self.seed,
            "budget": self.budget,
            "space": self.space.to_json_dict(),
            "workload": self.workload.to_json_dict(),
            "best": self.best.to_json_dict(),
            "best_cycles": self.best_cycles,
            "baseline": self.baseline.to_json_dict(),
            "baseline_cycles": self.baseline_cycles,
            "counts": self.counts,
            "trials": [t.to_json_dict() for t in self.trials],
        }

    def to_json(self) -> str:
        """Canonical serialization: sorted keys, 2-space indent, trailing
        newline — byte-identical across same-seed runs and backends."""
        return json.dumps(self.to_json_dict(), indent=2, sort_keys=True) \
            + "\n"


@dataclasses.dataclass
class _SimOutcome:
    cycles: int
    n_cores: int
    crit: CriticalPath


class _Evaluator:
    """Compiles, screens, and simulates candidates; counts what it pays
    for (the funnel accounting tests pin ``sim_calls`` to the number of
    ``"simulated"`` trials)."""

    def __init__(self, graphs: Sequence[Graph], chip: ChipSpec,
                 given_mesh: Optional[ChipMesh], workload: TuneWorkload,
                 quantizer: Any = None):
        self.graphs = list(graphs)
        self.chip = chip
        self.given_mesh = given_mesh
        self.workload = workload
        self.quantizer = quantizer
        self.sim_calls = 0
        rng = np.random.default_rng(workload.seed)
        self.images: List[np.ndarray] = []
        self.tenants: Optional[List[int]] = \
            [] if len(self.graphs) > 1 else None
        per_graph = [
            [rng.normal(size=tuple(int(x) for x in
                                   g.values[g.inputs[0]].shape)
                        ).astype(np.float32)
             for _ in range(workload.n_images)]
            for g in self.graphs]
        for i in range(workload.n_images):
            for t, imgs in enumerate(per_graph):
                self.images.append(imgs[i])
                if self.tenants is not None:
                    self.tenants.append(t)

    # ------------------------------------------------------------ compile
    def mesh_for(self, cfg: TuneConfig) -> Optional[ChipMesh]:
        if self.given_mesh is not None:
            return self.given_mesh
        if cfg.chips > 1:
            return make_mesh(cfg.chips, chip=self.chip,
                             topology=cfg.topology)
        return None

    def compile(self, cfg: TuneConfig) -> List[AcceleratorProgram]:
        mesh = self.mesh_for(cfg)
        if len(self.graphs) == 1:
            prog = compile_model(self.graphs[0], self.chip,
                                 quantizer=self.quantizer, mesh=mesh,
                                 replicate=cfg.replicate_plan() or None,
                                 chip_cuts=cfg.chip_cuts)
            return [prog]
        order = cfg.tenant_order or tuple(range(len(self.graphs)))
        placement = place_tenants([self.graphs[t] for t in order],
                                  self.chip, mesh=mesh,
                                  quantizer=self.quantizer)
        return list(placement.programs)

    # ---------------------------------------------------------- prefilter
    def prefilter(self, progs: Sequence[AcceleratorProgram]
                  ) -> Tuple[Optional[str], Optional[int]]:
        """(discard reason | None, static per-image interval)."""
        interval = 0
        for prog in progs:
            report = prefilter_program(prog, self.chip)
            errs = report.errors()
            if errs:
                return f"[{errs[0].check}] {errs[0].message}", None
            interval = max(interval,
                           int(report.metrics["image_interval_cycles"]))
        return None, interval

    # ----------------------------------------------------------- simulate
    def simulate(self, progs: Sequence[AcceleratorProgram],
                 tenant_order: Optional[Tuple[int, ...]] = None
                 ) -> _SimOutcome:
        self.sim_calls += 1
        target: Any = progs[0] if len(progs) == 1 else list(progs)
        tenants = self.tenants
        if tenants is not None and tenant_order is not None:
            # compile() permuted the program list into cfg.tenant_order;
            # self.tenants holds original graph indices, so remap each
            # image to its graph's slot in the permuted list
            slot = {t: j for j, t in enumerate(tenant_order)}
            tenants = [slot[t] for t in tenants]
        sim = Simulator(target, self.chip, check_raw=False, engine="event",
                        compute_plane="numpy")
        _, stats = sim.run(self.images, schedule=self.workload.schedule,
                           tenants=tenants, stalls=True)
        n_cores = sum(len(p.cores) for p in progs)
        return _SimOutcome(cycles=int(stats.cycles), n_cores=n_cores,
                           crit=critical_path(stats))


def _gcu_floor(graph: Graph, chip: ChipSpec) -> int:
    """Static GCU stream interval: pixels per image / DMA rate (the
    simulator streams H*W pixels — ``analysis.resources`` contract)."""
    shape = graph.values[graph.inputs[0]].shape
    pixels = int(np.prod([int(x) for x in shape[-2:]]))
    return max(1, math.ceil(pixels / chip.dma_pixels_per_cycle))


class _MoveGen:
    """Deterministic neighborhood enumeration around a config."""

    def __init__(self, evaluator: _Evaluator, space: SearchSpace):
        self.ev = evaluator
        self.space = space
        self.multi = len(evaluator.graphs) > 1
        if not self.multi:
            base_pg = partition_graph(evaluator.graphs[0])
            self.stages: Dict[str, int] = dict(replicable_stages(base_pg))
            self.floor = _gcu_floor(evaluator.graphs[0], evaluator.chip)
        else:
            self.stages = {}
            self.floor = 1
        self._auto_plans: Dict[int, Tuple[Tuple[str, int], ...]] = {}

    def auto_plan_for(self, chips: int) -> Tuple[Tuple[str, int], ...]:
        """``plan_replication``'s pick at a given chip count's core budget
        (capped by the space) — lets a chip-count move arrive already
        re-planned instead of dragging the old chip's plan along."""
        if chips not in self._auto_plans:
            plan = plan_replication(
                partition_graph(self.ev.graphs[0]),
                chips * self.ev.chip.n_cores,
                self.ev.chip.dma_pixels_per_cycle)
            capped = {a: min(k, self.space.max_repl_k)
                      for a, k in plan.items()}
            self._auto_plans[chips] = plan_key(capped)
        return self._auto_plans[chips]

    def _reset_cuts(self, cfg: TuneConfig) -> TuneConfig:
        return dataclasses.replace(cfg, chip_cuts=None) \
            if cfg.chip_cuts is not None else cfg

    def _repl_moves(self, cfg: TuneConfig) -> List[TuneConfig]:
        out: List[TuneConfig] = []
        plan = cfg.replicate_plan()
        for anchor in sorted(self.stages):
            iters = self.stages[anchor]
            k = plan.get(anchor, 1)
            k_cap = min(iters, self.space.max_repl_k)
            if k + 1 <= k_cap:
                out.append(self._reset_cuts(cfg.with_replica(anchor, k + 1)))
            if k > 1:
                out.append(self._reset_cuts(cfg.with_replica(anchor, k - 1)))
        return out

    def _mesh_moves(self, cfg: TuneConfig) -> List[TuneConfig]:
        if self.ev.given_mesh is not None:
            return []
        out: List[TuneConfig] = []
        for n in self.space.chip_counts:
            if n != cfg.chips:
                moved = dataclasses.replace(
                    cfg, chips=int(n), chip_cuts=None,
                    topology=(cfg.topology if n > 1
                              else TuneConfig().topology))
                if not self.multi:
                    # the compound move: scale out AND re-plan replication
                    # for the new core budget in one step
                    out.append(dataclasses.replace(
                        moved, replicate=self.auto_plan_for(int(n))))
                out.append(moved)
        if cfg.chips > 1:
            for t in self.space.topologies:
                if t != cfg.topology:
                    out.append(dataclasses.replace(cfg, topology=t,
                                                   chip_cuts=None))
        return out

    def _current_cuts(self, cfg: TuneConfig
                      ) -> Optional[Tuple[Tuple[int, ...], int]]:
        """(cuts in effect, n_parts) for a mesh config — the DP's pick
        when the config has none pinned; None when it cannot be derived
        (the compile pre-filter would discard such a candidate anyway)."""
        mesh = self.ev.mesh_for(cfg)
        if mesh is None or self.multi:
            return None
        try:
            pg = partition_graph(self.ev.graphs[0])
            plan = cfg.replicate_plan()
            if plan:
                pg = replicate_partitions(pg, plan)
            n_parts = len(pg.partitions)
            cuts = cfg.chip_cuts
            if cuts is None:
                cuts = chip_cuts_of(partition_chips(pg, mesh), mesh.n_chips)
            return cuts, n_parts
        except (PartitionError, MappingError):
            return None

    def _cut_moves(self, cfg: TuneConfig) -> List[TuneConfig]:
        cur = self._current_cuts(cfg)
        if cur is None:
            return []
        cuts, n_parts = cur
        return [dataclasses.replace(cfg, chip_cuts=nb)
                for nb in cut_neighbors(cuts, n_parts)]

    def _tenant_moves(self, cfg: TuneConfig) -> List[TuneConfig]:
        if not self.multi:
            return []
        order = cfg.tenant_order or tuple(range(len(self.ev.graphs)))
        out = []
        for i in range(len(order) - 1):
            swapped = list(order)
            swapped[i], swapped[i + 1] = swapped[i + 1], swapped[i]
            out.append(dataclasses.replace(cfg,
                                           tenant_order=tuple(swapped)))
        return out

    def neighbor_groups(self, cfg: TuneConfig) -> List[List[TuneConfig]]:
        """Legal single-step moves, grouped by axis (replication, mesh,
        cuts, tenant order).  The caller interleaves the groups so no
        axis starves another within a small budget."""
        groups = [self._repl_moves(cfg), self._mesh_moves(cfg),
                  self._cut_moves(cfg), self._tenant_moves(cfg)]
        seen = {cfg}
        out: List[List[TuneConfig]] = []
        for g in groups:
            uniq = []
            for m in g:
                if m not in seen:
                    seen.add(m)
                    uniq.append(m)
            out.append(uniq)
        return out

    def neighbors(self, cfg: TuneConfig) -> List[TuneConfig]:
        """Every legal single-step move, deterministically ordered."""
        return [m for g in self.neighbor_groups(cfg) for m in g]

    def guided(self, cfg: TuneConfig, crit: CriticalPath
               ) -> List[Tuple[TuneConfig, str]]:
        """Moves that attack the run's binding resource, most-binding
        first (the ``obs.critical_path`` feedback loop)."""
        out: List[Tuple[TuneConfig, str]] = []
        plan = cfg.replicate_plan()
        for kind, name in propose_moves(crit):
            tag = f"guided:{kind}:{name}"
            if kind == "stage" and name in self.stages:
                iters = self.stages[name]
                k = plan.get(name, 1)
                k_cap = min(iters, self.space.max_repl_k)
                # jump straight to the k that pulls this stage's service
                # down to the GCU floor (plan_replication's move, but
                # validated by simulation instead of trusted)
                k_jump = min(k_cap, math.ceil(iters / max(self.floor, 1)))
                for k_new in (k_jump, k + 1):
                    if k != k_new and k_new <= k_cap:
                        out.append((self._reset_cuts(
                            cfg.with_replica(name, k_new)), tag))
            elif kind == "gcu":
                # stream-bound: replication is wasted — walk the biggest
                # replica factor back down and bank the cores
                if plan:
                    anchor = max(plan, key=lambda a: (plan[a], a))
                    out.append((self._reset_cuts(
                        cfg.with_replica(anchor, plan[anchor] - 1)), tag))
            elif kind == "link":
                for m in self._cut_moves(cfg):
                    out.append((m, tag))
                for m in self._mesh_moves(cfg):
                    if m.chips == cfg.chips and m.topology != cfg.topology:
                        out.append((m, tag))
        return out


def _better(a_cycles: int, a_cores: int, a_key: str,
            b_cycles: int, b_cores: int, b_key: str) -> bool:
    """Is A strictly preferable to B?  Cycles, then mapped cores (fewer
    cores at equal speed = higher throughput per core), then the
    canonical key — a total order, so the incumbent is seed-independent
    of proposal arrival order."""
    return (a_cycles, a_cores, a_key) < (b_cycles, b_cores, b_key)


def autotune(model: Union[Graph, Sequence[Graph]],
             chip_or_mesh: Union[ChipSpec, ChipMesh],
             workload: Optional[TuneWorkload] = None,
             budget: int = 24, *,
             seed: int = 0,
             space: Optional[SearchSpace] = None,
             label: str = "model",
             quantizer: Any = None) -> TuneResult:
    """Search compiler configurations for ``model`` on the target,
    scoring candidates by simulated cycles on ``workload``.

    ``model`` is one :class:`Graph` (axes: replication, mesh shape, cut
    points) or a sequence of co-resident tenant graphs (axis: placement
    order).  ``budget`` bounds the number of *candidates considered*
    (trials); simulations are the shortlisted subset.  Same arguments ⇒
    bitwise-identical result (see module docstring).
    """
    graphs = [model] if isinstance(model, Graph) else list(model)
    if not graphs:
        raise ValueError("autotune needs at least one model graph")
    if budget < 2:
        raise ValueError(f"budget {budget} < 2: need room for the base "
                         "config and the auto heuristic")
    workload = workload or TuneWorkload()
    space = space or SearchSpace()
    if isinstance(chip_or_mesh, ChipMesh):
        given_mesh: Optional[ChipMesh] = chip_or_mesh
        chip = chip_or_mesh.chip
        base_chips = chip_or_mesh.n_chips
    else:
        given_mesh = None
        chip = chip_or_mesh
        base_chips = 1
    rng = np.random.default_rng(seed)
    ev = _Evaluator(graphs, chip, given_mesh, workload, quantizer)
    gen = _MoveGen(ev, space)

    # -- seed candidates: the unmodified config and the static heuristic
    base_cfg = TuneConfig(chips=base_chips)
    seeds: List[Tuple[TuneConfig, str]] = [(base_cfg, "seed")]
    if len(graphs) == 1:
        total = given_mesh.n_cores_total if given_mesh is not None \
            else chip.n_cores
        auto_plan = plan_replication(partition_graph(graphs[0]), total,
                                     chip.dma_pixels_per_cycle)
        auto_cfg = dataclasses.replace(base_cfg,
                                       replicate=plan_key(auto_plan))
        if auto_cfg != base_cfg:
            seeds.append((auto_cfg, "auto"))
    baseline_cfg = seeds[-1][0]   # the replicate="auto" heuristic's pick

    trials: List[Trial] = []
    seen: set = set()
    best: Optional[Tuple[TuneConfig, _SimOutcome]] = None
    incumbent: Optional[Tuple[TuneConfig, _SimOutcome]] = None
    baseline_cycles: Optional[int] = None

    def consider(batch: List[Tuple[TuneConfig, str]]) -> None:
        """Run one funnel round over ``batch`` (already deduped/budgeted):
        compile → prefilter → static rank → simulate the shortlist."""
        nonlocal best, incumbent, baseline_cycles
        survivors: List[Tuple[int, str, TuneConfig, str,
                              List[AcceleratorProgram]]] = []
        for cfg, prov in batch:
            idx = len(trials)
            try:
                progs = ev.compile(cfg)
            except (PartitionError, MappingError) as e:
                trials.append(Trial(idx, cfg, prov, "compile-error",
                                    None, None, None, detail=str(e)[:160]))
                continue
            reason, interval = ev.prefilter(progs)
            if reason is not None:
                trials.append(Trial(idx, cfg, prov, "prefilter-discard",
                                    None, None, None,
                                    detail=reason[:160]))
                continue
            survivors.append((int(interval or 0), cfg.key(), cfg, prov,
                              progs))
        survivors.sort(key=lambda s: (s[0], s[1]))
        n_sim = max(1, space.shortlist)
        # seeds must always be scored: they anchor best/baseline
        forced = [s for s in survivors if s[3] in ("seed", "auto")]
        chosen = forced + [s for s in survivors[:n_sim] if s not in forced]
        for interval, ckey, cfg, prov, progs in survivors:
            idx = len(trials)
            if not any(cfg == c for _, _, c, _, _ in chosen):
                trials.append(Trial(idx, cfg, prov, "ranked-out",
                                    interval, None, None))
                continue
            outcome = ev.simulate(progs, cfg.tenant_order)
            trials.append(Trial(idx, cfg, prov, "simulated", interval,
                                outcome.cycles, outcome.n_cores,
                                detail=f"bottleneck={outcome.crit.kind}:"
                                       f"{outcome.crit.name}"))
            if cfg == baseline_cfg:
                baseline_cycles = outcome.cycles
            if best is None or _better(
                    outcome.cycles, outcome.n_cores, cfg.key(),
                    best[1].cycles, best[1].n_cores, best[0].key()):
                best = (cfg, outcome)
                incumbent = (cfg, outcome)
            elif incumbent is not None and cfg != incumbent[0]:
                # annealing: accept an uphill move as the next move base
                rel = (outcome.cycles - incumbent[1].cycles) \
                    / max(incumbent[1].cycles, 1)
                temp = space.explore_temp * (space.temp_decay ** rounds)
                if rel > 0 and temp > 0 \
                        and rng.random() < math.exp(-rel / temp):
                    incumbent = (cfg, outcome)

    rounds = 0
    first = [(c, p) for c, p in seeds if c not in seen]
    for c, _ in first:
        seen.add(c)
    consider(first[:budget])
    while len(trials) < budget:
        if incumbent is None:
            break  # nothing simulatable: the space is infeasible
        cfg0, out0 = incumbent
        proposals: List[Tuple[TuneConfig, str]] = []
        for m, tag in gen.guided(cfg0, out0.crit):
            proposals.append((m, tag))

        def interleaved(groups: List[List[TuneConfig]]) -> List[TuneConfig]:
            # shuffle within each axis, then round-robin across axes so a
            # small batch still samples every axis of the space
            shuffled = [[g[int(i)] for i in rng.permutation(len(g))]
                        for g in groups]
            flat: List[TuneConfig] = []
            for depth in range(max((len(g) for g in shuffled), default=0)):
                for g in shuffled:
                    if depth < len(g):
                        flat.append(g[depth])
            return flat

        proposals.extend((m, "neighbor")
                         for m in interleaved(gen.neighbor_groups(cfg0)))
        if best is not None and best[0] != cfg0:
            proposals.extend(
                (m, "explore")
                for m in interleaved(gen.neighbor_groups(best[0])))
        batch: List[Tuple[TuneConfig, str]] = []
        room = min(space.batch, budget - len(trials))
        for m, prov in proposals:
            if m in seen or len(batch) >= room:
                continue
            seen.add(m)
            batch.append((m, prov))
        if not batch:
            break  # neighborhood exhausted
        consider(batch)
        rounds += 1

    if best is None:
        raise PartitionError(
            f"autotune: no candidate of {len(trials)} considered could be "
            "compiled and simulated — the base configuration itself is "
            "infeasible on this target")
    if baseline_cycles is None:
        # the heuristic seed itself failed its funnel (e.g. the auto plan
        # does not map): fall back to the base config as the baseline
        for t in trials:
            if t.provenance == "seed" and t.cycles is not None:
                baseline_cfg_, baseline_cycles = t.config, t.cycles
                break
        else:
            baseline_cfg_, baseline_cycles = best[0], best[1].cycles
    else:
        baseline_cfg_ = baseline_cfg
    assert ev.sim_calls == sum(1 for t in trials if t.stage == "simulated")
    return TuneResult(label=label, seed=seed, budget=budget, space=space,
                      workload=workload, best=best[0],
                      best_cycles=best[1].cycles,
                      baseline=baseline_cfg_,
                      baseline_cycles=int(baseline_cycles),
                      trials=trials)
