"""Cycle-level simulator of the CM accelerator (paper §2 + §3.4).

Faithful to the paper's functional model:
  * execution proceeds in cycles; per cycle a core performs at most one
    crossbar MxV followed by its DPU instruction sequence;
  * data transfers scheduled during cycle t arrive in the remote core's SRAM
    at cycle t+1; the receiving LCU "snoops" the writes and advances its
    dependency automaton (the generated-code form of the Appendix-A ``S``);
  * the GCU streams input data from GMEM to the input cores at a configurable
    DMA rate and collects output arrays back into GMEM.

Two engines implement that model:

``engine="event"`` (default) — event-driven and vectorized.  Instead of
scanning every core on every cycle, a heapq-ordered event queue holds only
the moments where machine state can change: message-batch arrivals, GCU
stream steps, and core-readiness events.  Three structural changes make this
fast without changing any observable timing:

  * **Compiled frontier tables** (``poly.FrontierTable``, built once at
    lowering): the piecewise multi-affine ``S`` is precompiled into a dense
    per-location lookup of flattened reader-iteration ranks, so a frontier is
    a single integer threshold and a delivered write batch advances it with
    one gather + max — no generated-code call per SRAM write.
  * **Batched payload streams**: producers emit one numpy payload buffer per
    (destination, send-window) instead of a Python ``Message`` object per
    pixel per destination; delivery is a handful of slice-assignments.
  * **Batched core execution**: when a frontier threshold admits ``k``
    pending iterations, all ``k`` are computed at once (windows gathered
    vectorized, MxVs dispatched as one stacked call to the compute plane)
    while cycle accounting still charges one iteration per cycle, exactly
    as §2 prescribes.

**Compute plane** (``core/compute_plane.py``): both engines route every
crossbar MxV through a pluggable backend resolved from the ``compute_plane``
argument —

  * ``"numpy"``: stacked ``einsum('bn,mn->bm')``.  Einsum is
    batch-invariant (row ``i`` of a stacked call is bit-identical to the
    per-row call), so the event engine's batching changes **no output bit**
    relative to the reference engine or the per-iteration ``"reference"``
    plane.
  * ``"torch"`` (what ``"auto"`` resolves to): ``TorchPlane``, the
    ``kernels/mxv.py`` crossbar kernels on an NVIDIA card (int8 weight
    conductances + per-row scales; optional ``dac=True`` fully-int8 path),
    or their plain PyTorch versions for ``TorchPlane(device="cpu")``.
    Tolerance-based equivalence (``atol≈2e-5`` vs the float planes once the
    crossbar matrix is dequantized-int8, e.g.
    ``compile_model(..., quantizer=dequantize_int8)``).
  * ``"reference"``: the per-iteration loop over ``mxv_fn`` — the original
    structure, kept as the batching oracle and the only backend honoring a
    custom ``mxv_fn``.  Custom batched backends plug in either as a
    ``ComputePlane`` subclass or through the legacy ``mxv_batch_fn`` hook.

DPU pooling/accumulator updates get the same treatment: ``maxpool2d`` is
always executed as a vectorized segment reduce (float max is exact under
reordering, so this is bit-identical); ``avgpool2d``/``global_avgpool``
accumulate float adds, so their vectorized segment-reduce path is guarded by
``strict_float_order`` — ``True`` (default) keeps the reference's
per-iteration accumulation order (bit-identical), ``False`` reassociates the
adds (equivalent within ``np.allclose`` ``atol=1e-5`` on these workloads).

Cycle accounting is bit-compatible with the reference engine: per cycle the
phase order is (1) deliveries, (2) GCU streaming, (3) core execution in core
order — encoded in the event sort key — and ``SimStats.cycles / messages /
bytes_sent / busy`` are reproduced exactly, including the final-cycle
truncation when the last output lands.  ``sram_high_water`` is replayed from
the event log as end-of-cycle samples (buffer-lifetime intervals swept in
cycle order), so same-cycle create/retire overlaps net out exactly as in the
reference's dense per-cycle sampling.

``engine="reference"`` — the original dense ``for cycle in range(...)`` scan,
kept as the equivalence oracle: both engines must produce bit-identical
outputs and identical cycle/message statistics on every schedule (per
compute plane — switching planes changes final-ulp bits, not timing).

The simulator doubles as the correctness oracle harness: with
``check_raw=True`` every executed iteration asserts that all SRAM locations it
reads were previously written (an LCU bug would trip this immediately).

**Transformer DPU ops.**  ``layernorm``/``softmax`` execute like
relu/add (row-wise over the channel vector, batched in the event engine with
row-independent reductions — bit-identical to the per-iteration reference).
The dynamic ``matmul`` (QKᵀ / attn·V) assembles its matrix operand from the
consumer core's SRAM (``DynMatmulDescriptor``; the broadcast frontier
guarantees the array is complete before any iteration is admitted) and
dispatches through ``ComputePlane.dyn_mxv_one/batch`` — a digital DPU path
on every plane.  All operands are made C-contiguous before the plane call:
einsum is not bit-stable across input strides.

**Request-level serving.**  ``run`` accepts per-image ``arrivals``
(the GCU may not start streaming an image before its arrival cycle), an
admission bound ``max_inflight`` (started-but-incomplete images), and
``priorities`` (the GCU picks the highest-priority *arrived* pending image
at each decision point; FIFO otherwise).  ``SimStats`` then carries
per-image ``gcu_start_cycle`` / ``completion_cycle`` for latency accounting.
Multi-tenancy: construct the ``Simulator`` with a *list* of core-disjoint
programs (see ``compiler.place_tenants``) and tag each image with its
``tenants`` index — the joint run shares the host GCU/DMA stream and the
mesh links while every per-core structure stays private, so a tenant's
outputs are bitwise those of the same program simulated alone.  Each core
processes its tenant's images in GCU stream-start order (identical to index
order under FIFO), so priority admission reorders the whole pipeline.  All
of this holds in BOTH engines with the same bit-identical contract as the
classic batch run; the defaults reproduce the classic run exactly.

Port copy of ``repro.core.simulator``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .compute_plane import descriptor_for, dyn_descriptor_for, resolve_plane
from .lowering import AcceleratorProgram, CoreConfig, SendSpec
from .hwspec import ChipMesh, ChipSpec
from . import poly
# observability: pure module — no repro_torch.core imports at load time,
# so this does not cycle through core/__init__
from ..obs import stalls as obs_stalls

Point = Tuple[int, ...]

_INF = poly.INF_RANK


class DeadlockError(Exception):
    pass


class RawViolation(Exception):
    pass


@dataclasses.dataclass
class Message:
    arrive: int
    dst_core: int          # -1 => GMEM
    image: int
    value: str
    kind: str              # pixel | pool | full | reduce
    loc: Point             # unpadded representative location
    payload: np.ndarray
    # producing partition (-1: GCU).  A consumer of a replicated value keeps
    # one frontier per producer replica; the write advances only the
    # matching one.
    src_part: int = -1


@dataclasses.dataclass
class LinkStats:
    """Per inter-chip link accounting (src_chip, dst_chip) -> this record.

    ``busy`` counts occupancy cycles: each message holds the link for
    ``ceil(nbytes / width_bytes)`` cycles, so ``busy / SimStats.cycles`` is
    the link's *offered load* — the model serializes each message's bytes
    but not messages against each other, so a value above 1.0 flags a link
    that real hardware would have to queue (the scale-out diagnostic).
    Counted at send time, exactly like ``SimStats.messages`` — both engines
    must agree bit-for-bit.
    """

    messages: int = 0
    bytes: int = 0
    busy: int = 0


@dataclasses.dataclass
class SimStats:
    cycles: int = 0
    busy: Dict[int, int] = dataclasses.field(default_factory=lambda: defaultdict(int))
    messages: int = 0
    bytes_sent: int = 0
    sram_high_water: Dict[int, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    first_busy: Dict[int, int] = dataclasses.field(default_factory=dict)
    last_busy: Dict[int, int] = dataclasses.field(default_factory=dict)
    links: Dict[Tuple[int, int], LinkStats] = dataclasses.field(
        default_factory=dict)
    # Request-level timing (serving runtime): per image, the cycle the GCU
    # began streaming it and the cycle its last output chunk landed in GMEM.
    # ``queueing = gcu_start - arrival`` and ``latency = completion - arrival
    # + 1`` are derived by the runtime; both engines must agree bit-for-bit.
    gcu_start_cycle: Dict[int, int] = dataclasses.field(default_factory=dict)
    completion_cycle: Dict[int, int] = dataclasses.field(default_factory=dict)
    # Deadline failures (fault injection): image -> the cycle it was marked
    # failed (its deadline).  Disjoint from ``completion_cycle``; a request
    # appears in exactly one of the two once the run ends.
    failed_cycle: Dict[int, int] = dataclasses.field(default_factory=dict)
    # Stall attribution: populated only by ``run(stalls=True)``;
    # both engines must produce the identical breakdown.
    stalls: Optional["obs_stalls.StallBreakdown"] = None

    def utilization(self, core: int) -> float:
        if core not in self.first_busy:
            return 0.0
        span = self.last_busy[core] - self.first_busy[core] + 1
        return self.busy[core] / span

    def mean_utilization(self) -> float:
        us = [self.utilization(c) for c in self.busy]
        return float(np.mean(us)) if us else 0.0

    def link_occupancy(self, link: Tuple[int, int]) -> float:
        if link not in self.links or not self.cycles:
            return 0.0
        return self.links[link].busy / self.cycles

    def chip_utilization(self, mesh: ChipMesh) -> List[float]:
        """Mean core utilization per chip (cores that never ran count 0),
        averaged over all ``mesh.chip.n_cores`` physical cores.

        A busy core outside the mesh's id range is an error, not a silently
        dropped bucket: on the degenerate ``chips=1`` mesh every core of a
        wider program used to land on phantom chip ids past ``n_chips`` and
        vanish from the report."""
        per_chip: Dict[int, float] = defaultdict(float)
        for core in self.busy:
            c = mesh.chip_of(core)
            if c >= mesh.n_chips:
                raise ValueError(
                    f"busy core {core} outside mesh "
                    f"({mesh.n_chips} chips x {mesh.chip.n_cores} cores)")
            per_chip[c] += self.utilization(core)
        return [per_chip[c] / mesh.chip.n_cores
                for c in range(mesh.n_chips)]


def static_core_sram_bytes(cfg: CoreConfig, values: Dict[str, object]) -> int:
    """Static per-image SRAM footprint of one core, in bytes.

    This is the allocation contract of the runtime state
    (:class:`_CoreImageState`): one float32 buffer per LCU input array —
    padded to ``(c, h + 2*pad, w + 2*pad)`` when the consumer needs a conv
    halo — plus the pool/reduce accumulators of the core's DPU nodes.
    ``values`` is ``graph.values`` (for accumulator extents).  The
    structural ``sram-fits`` check and the analysis ``sram-highwater``
    bound both derive from this single definition, so the static bound is
    an upper bound on the simulated ``SimStats.sram_high_water`` by
    construction (the runtime frees a buffer set only when its image
    completes).
    """
    need = 0
    for lc in cfg.lcu.values():
        shp = lc.shape
        if len(shp) == 3 and lc.pad:
            c, h, w = shp
            need += 4 * c * (h + 2 * lc.pad) * (w + 2 * lc.pad)
        else:
            need += 4 * int(np.prod(shp))
    for n in cfg.dpu_nodes:
        if n.op in ("maxpool2d", "avgpool2d", "global_avgpool"):
            need += values[n.outputs[0]].nbytes
    return need


def static_expected_chunks(kind: str, shape: Tuple[int, ...]) -> int:
    """Messages one image of a value arrives in, by write kind.

    The static form of the request plan's output accounting (and of the
    analysis link-load estimate): ``full``/``reduce`` values land as one
    message, ``pixel``/``pool`` values as one message per output pixel.
    """
    if kind in ("full", "reduce"):
        return 1
    if kind in ("pixel", "pool"):
        return int(shape[1]) * int(shape[2])
    raise NotImplementedError(kind)


class _CoreImageState:
    """Per-(core, image) runtime state (reference engine)."""

    def __init__(self, cfg: CoreConfig):
        self.sram: Dict[str, np.ndarray] = {}
        # value -> {src partition -> frontier}: one dependency automaton per
        # producer (k of them when the producer is k-replicated; admission
        # requires all of them safe — the max-merge of the k streams)
        self.frontiers: Dict[str, Dict[int, poly.Frontier]] = {}
        for v, lc in cfg.lcu.items():
            shp = lc.shape
            if len(shp) == 3 and lc.pad:
                c, h, w = shp
                buf = np.zeros((c, h + 2 * lc.pad, w + 2 * lc.pad), np.float32)
            else:
                buf = np.zeros(shp, np.float32)
            self.sram[v] = buf
            self.frontiers[v] = {d.src_partition: d.make_frontier()
                                 for d in lc.deps}
        self.pool_acc: Dict[str, np.ndarray] = {}
        self.reduce_acc: Dict[str, np.ndarray] = {}
        self.counter = 0
        self.done = False
        self.written: Dict[str, set] = defaultdict(set)  # RAW oracle


def _unflatten(counter: int, bounds: Tuple[int, ...]) -> Point:
    idx = []
    for b in reversed(bounds):
        idx.append(counter % b)
        counter //= b
    return tuple(reversed(idx))


class _RequestPlan:
    """Validated request-level run parameters, shared by both engines.

    Normalizes arrivals/tenants/priorities to per-image arrays, resolves the
    effective admission bound (``sequential`` ≡ bound 1 at the GCU), caches
    the per-tenant expected-output-chunk counts, and exposes the GCU's
    request-selection ``key`` (FIFO: arrival then index; priority: priority
    desc, then arrival, then index)."""

    __slots__ = ("arrivals", "tenants", "priorities", "max_inflight",
                 "out_expected", "deadlines")

    def __init__(self, sim: "Simulator", n_images: int, schedule: str,
                 arrivals, tenants, max_inflight, priorities,
                 deadlines=None):
        def as_list(x, name, default):
            if x is None:
                return [default] * n_images
            out = [int(v) for v in x]
            if len(out) != n_images:
                raise ValueError(f"{name} has {len(out)} entries for "
                                 f"{n_images} images")
            return out

        self.arrivals = as_list(arrivals, "arrivals", 0)
        if any(a < 0 for a in self.arrivals):
            raise ValueError("arrival cycles must be >= 0")
        self.tenants = as_list(tenants, "tenants", 0)
        if any(not 0 <= t < len(sim.progs) for t in self.tenants):
            raise ValueError("tenant index outside the "
                             f"{len(sim.progs)}-program list")
        self.priorities = None if priorities is None \
            else as_list(priorities, "priorities", 0)
        k = n_images if max_inflight is None else int(max_inflight)
        if k < 1 and n_images:
            raise ValueError("max_inflight must be >= 1")
        if schedule == "sequential":
            k = min(k, 1)
        self.max_inflight = k
        self.out_expected = [
            {v: sim._expected_chunks(v, tk) for v in p.gcu.outputs}
            for tk, p in enumerate(sim.progs)]
        # Per-image absolute deadline cycle (or None).  An image incomplete
        # at its deadline is marked failed *at* that cycle — completion is
        # checked first, so completing exactly at the deadline is a success.
        if deadlines is None:
            self.deadlines = [None] * n_images
        else:
            dls = list(deadlines)
            if len(dls) != n_images:
                raise ValueError(f"deadlines has {len(dls)} entries for "
                                 f"{n_images} images")
            self.deadlines = []
            for i, d in enumerate(dls):
                if d is not None:
                    d = int(d)
                    if d < 0:
                        raise ValueError(f"deadline cycles must be >= 0, "
                                         f"got {d} for image {i}")
                self.deadlines.append(d)

    def key(self, i: int):
        if self.priorities is None:
            return (self.arrivals[i], i)
        return (-self.priorities[i], self.arrivals[i], i)


class Simulator:
    """``engine="event"`` (default) or ``engine="reference"`` (the oracle).

    ``compute_plane`` selects the crossbar MxV backend for *both* engines:
    ``"torch"`` (``TorchPlane`` on the CUDA card, int8 weights,
    tolerance-based equivalence), ``"numpy"`` (stacked einsum —
    bit-identical per row), ``"reference"`` (per-iteration loop over
    ``mxv_fn``, the batching oracle), or any ``ComputePlane`` instance.
    ``"auto"`` resolves to ``"torch"`` on the card (and raises where there
    is none), unless ``mxv_fn`` is given (then the reference loop is the
    only backend that can honor it; combining a custom ``mxv_fn`` with a
    stacked plane raises).  ``mxv_batch_fn(m, V) -> Y`` is the legacy hook
    for custom stacked backends and overrides the plane.

    ``strict_float_order`` (event engine): keep the reference's per-iteration
    float-accumulation order in avg-pool / global-avg-pool DPU updates
    (default).  ``False`` switches them to vectorized segment reduces, which
    reassociate float adds — equivalent within ``np.allclose`` tolerances,
    identical in timing.
    """

    def __init__(self, program, chip,
                 mxv_fn=None, check_raw: bool = True, engine: str = "event",
                 mxv_batch_fn=None, compute_plane="auto",
                 strict_float_order: bool = True, faults=None):
        assert engine in ("event", "reference"), engine
        # ``program`` may be a single AcceleratorProgram or a sequence of
        # core-disjoint programs (tenants) co-resident on one chip/mesh.
        # Tenants share the GCU/DMA stream and the mesh links; everything
        # per-core (SRAM, frontiers, sends) is private by construction.
        progs = list(program) if isinstance(program, (list, tuple)) \
            else [program]
        if not progs:
            raise ValueError("need at least one program")
        self.progs: List[AcceleratorProgram] = progs
        self.prog = progs[0]    # single-tenant convenience; tenant 0 otherwise
        self.tenant_of_core: Dict[int, int] = {}
        self.cores_merged: Dict[int, CoreConfig] = {}
        for tk, p in enumerate(progs):
            overlap = set(p.cores) & set(self.cores_merged)
            if overlap:
                raise ValueError(
                    f"tenant {tk} shares cores {sorted(overlap)} with an "
                    "earlier tenant — co-residency requires disjoint sets")
            for cid, cfg in p.cores.items():
                self.cores_merged[cid] = cfg
                self.tenant_of_core[cid] = tk
        meshes = {p.mesh for p in progs}
        if len(meshes) > 1:
            raise ValueError("co-resident programs must share one mesh")
        prog_mesh = next(iter(meshes))
        # ``chip`` may be a single ChipSpec or a ChipMesh; a mesh compiled
        # into the program wins (its link model shaped the lowering).
        self.mesh: Optional[ChipMesh] = (
            prog_mesh if prog_mesh is not None
            else (chip if isinstance(chip, ChipMesh) else None))
        self.chip: ChipSpec = self.mesh.chip if self.mesh is not None \
            else chip
        self.plane = resolve_plane(compute_plane, mxv_fn, mxv_batch_fn)
        self.strict_float_order = strict_float_order
        self.check_raw = check_raw
        self.engine = engine
        # Deterministic fault timeline (duck-typed repro.faults.FaultSchedule
        # — the core package must not import the faults package).  Both
        # engines honor the same timeline bit-identically; requests stalled
        # by a fault are detected via per-image deadlines (``run(deadlines=
        # ...)``), never simulated forever.
        self.faults = faults
        self.dead_at: Dict[int, int] = {}
        self._faulted_links: frozenset = frozenset()
        self._link_tl_cache: Dict[Tuple[int, int], tuple] = {}
        if faults is not None:
            total = self.mesh.n_cores_total if self.mesh is not None \
                else self.chip.n_cores
            self.dead_at = dict(faults.dead_at())
            bad = [c for c in self.dead_at if not 0 <= c < total]
            if bad:
                raise ValueError(f"core faults on cores {sorted(bad)} "
                                 f"outside [0, {total})")
            keys = faults.link_keys()
            if keys:
                if self.mesh is None:
                    raise ValueError("link faults require a ChipMesh")
                unknown = keys - self.mesh.links
                if unknown:
                    raise ValueError("link faults on non-existent links "
                                     f"{sorted(unknown)}")
                self._faulted_links = keys

    def _values_for(self, cfg: CoreConfig):
        """The owning tenant's value-shape table for a core config."""
        return self.progs[self.tenant_of_core[cfg.core_id]].pgraph.graph.values

    def _weights_for(self, cfg: CoreConfig):
        """The owning tenant's weight table (layernorm gamma/beta live in
        GMEM-resident graph weights, not the crossbar)."""
        return self.progs[
            self.tenant_of_core[cfg.core_id]].pgraph.graph.weights

    def _link_for(self, src_core: int, dst_core: int):
        """(extra_delay_fn, link_key) for a core->core message, or (None,
        None) intra-chip.  GCU/GMEM host I/O never rides a mesh link."""
        if self.mesh is None:
            return None, None
        ca, cb = self.mesh.chip_of(src_core), self.mesh.chip_of(dst_core)
        if ca == cb:
            return None, None
        return self.mesh.link_between(ca, cb), (ca, cb)

    @staticmethod
    def _occupancy(link, nbytes: int) -> int:
        return link.beats(nbytes)

    def _link_timeline(self, key, base):
        """Cached (breaks, states) fault timeline of one mesh link."""
        tl = self._link_tl_cache.get(key)
        if tl is None:
            tl = self.faults.link_timeline(key, base)
            self._link_tl_cache[key] = tl
        return tl

    def _fault_link_state(self, key, send_cycle: int, base):
        """(down, effective LinkSpec) for a message sent at ``send_cycle``."""
        if key not in self._faulted_links:
            return False, base
        breaks, states = self._link_timeline(key, base)
        return states[int(np.searchsorted(breaks, send_cycle,
                                          side="right"))]

    # ------------------------------------------------------------------- run
    def run(self, images: List[np.ndarray], schedule: str = "pipelined",
            max_cycles: int = 1_000_000, *, arrivals=None, tenants=None,
            max_inflight: Optional[int] = None, priorities=None,
            deadlines=None, stalls: bool = False, trace=None
            ) -> Tuple[List[Dict[str, np.ndarray]], SimStats]:
        """Simulate ``images`` through the resident program(s).

        Serving-runtime extensions (defaults reproduce the classic
        batch-at-cycle-0 run exactly):

        ``arrivals``     — per-image earliest cycle the GCU may begin
                           streaming it (open-loop request arrival times).
        ``tenants``      — per-image tenant index into the co-resident
                           program list (multi-tenant runs only).
        ``max_inflight`` — admission bound: the GCU starts a new image only
                           while fewer than this many started images are
                           incomplete (``schedule="sequential"`` is the
                           bound-1 special case and keeps its core-side
                           producer gating on top).
        ``priorities``   — per-image priority; when given, the GCU picks the
                           highest-priority *arrived* pending image at each
                           decision point instead of FIFO (ties: earlier
                           arrival, then lower image index).
        ``deadlines``    — per-image absolute deadline cycle (or None): an
                           image incomplete at that cycle is marked failed
                           there (``SimStats.failed_cycle``), its admission
                           slot freed the same cycle.  Completion at the
                           deadline cycle still counts as success.  This is
                           the failure-detection contract: a request stalled
                           by an injected fault resolves at its deadline
                           instead of hanging the run.
        ``stalls``       — classify every idle core-cycle into the closed
                           taxonomy of ``repro_torch.obs.stalls`` and attach the
                           :class:`~repro_torch.obs.stalls.StallBreakdown` as
                           ``SimStats.stalls``.  Both engines produce the
                           identical breakdown.
        ``trace``        — a ``repro_torch.obs.trace.TraceRecorder`` collecting
                           execution/GCU/link spans and fault instants in
                           simulated cycles (Chrome-trace export).
                           Observability contract: ``stalls=False,
                           trace=None`` (the defaults) add zero work —
                           counters and outputs stay bitwise-identical.
        """
        assert schedule in ("pipelined", "sequential")
        n = len(images)
        plan = _RequestPlan(self, n, schedule, arrivals, tenants,
                            max_inflight, priorities, deadlines)
        if self.engine == "reference":
            return self._run_reference(images, schedule, max_cycles, plan,
                                       stalls=stalls, trace=trace)
        return _EventEngine(self, images, schedule, max_cycles, plan,
                            stalls=stalls, trace=trace).run()

    def stage_of_core(self) -> Dict[int, str]:
        """Core id -> pipeline-stage name (the replica-group leader's first
        node), ``t<k>:``-prefixed on multi-tenant runs.  Replica cores of
        one stage share a name, so breakdowns roll up per stage."""
        out: Dict[int, str] = {}
        multi = len(self.progs) > 1
        for cid, cfg in self.cores_merged.items():
            tk = self.tenant_of_core[cid]
            pg = self.progs[tk].pgraph
            name = pg.partitions[pg.leader_of(cfg.partition_idx)].nodes[0].name
            out[cid] = f"t{tk}:{name}" if multi else name
        return out

    # =========================================================== reference
    def _run_reference(self, images, schedule, max_cycles, plan,
                       stalls=False, trace=None):
        chip = self.chip
        progs = self.progs
        tenants = plan.tenants
        n_images = len(images)
        stats = SimStats()
        # Stall-attribution oracle state (``stalls=True`` only — the plain
        # path must stay bitwise-identical): per-core category counts, the
        # GCU stream windows, and the delayed-message intervals feeding the
        # ``link-delay`` predicate.  Only messages slower than the paper's
        # one-cycle hop are recorded (cross-chip transfer delay / degraded
        # links), so healthy intra-chip traffic never reads as link delay.
        stall_counts = {cid: defaultdict(int) for cid in self.cores_merged} \
            if stalls else None
        gcu_send_end: Dict[int, int] = {}
        delayed = defaultdict(list) if stalls else None
        gcu_busy = 0
        inflight: List[Message] = []
        states: Dict[Tuple[int, int], _CoreImageState] = {}
        outputs: List[Dict[str, np.ndarray]] = [
            {v: np.zeros(s, np.float32)
             for v, s in progs[tenants[i]].gcu.outputs.items()}
            for i in range(n_images)]
        out_counts = [defaultdict(int) for _ in range(n_images)]
        img_complete = [False] * n_images
        failed = [False] * n_images
        dl = plan.deadlines
        dead_at = self.dead_at
        core_done = defaultdict(bool)        # (core, image) -> finished

        # GCU stream cursor: one shared host DMA across all tenants.  The
        # current image is picked dynamically among arrived, unstarted
        # requests (FIFO or priority), subject to the admission bound.
        cur_req: Optional[int] = None
        cur_pix = 0
        started = [False] * n_images
        gcu_done: set = set()                # images fully streamed
        n_started = 0
        K = plan.max_inflight

        def state(core: int, img: int) -> _CoreImageState:
            key = (core, img)
            if key not in states:
                states[key] = _CoreImageState(self.cores_merged[core])
            return states[key]

        # Per-core processing order follows the GCU stream-start order of
        # the core's tenant (identical to image-index order for FIFO runs).
        stream_seq: List[List[int]] = [[] for _ in progs]
        core_pos = defaultdict(int)

        def current_image(core: int) -> Optional[int]:
            seq = stream_seq[self.tenant_of_core[core]]
            while core_pos[core] < len(seq) and \
                    core_done[(core, seq[core_pos[core]])]:
                core_pos[core] += 1
            if core_pos[core] < len(seq):
                return seq[core_pos[core]]
            return None

        for cycle in range(max_cycles):
            progress = False

            # 1. deliver messages
            arriving = [m for m in inflight if m.arrive == cycle]
            inflight = [m for m in inflight if m.arrive > cycle]
            for m in arriving:
                progress = True
                if m.dst_core == -1:
                    self._gmem_write(outputs[m.image], out_counts[m.image], m)
                else:
                    st = state(m.dst_core, m.image)
                    self._sram_write(self.cores_merged[m.dst_core], st, m)
            for im in range(n_images):
                if not img_complete[im] and not failed[im] and all(
                        out_counts[im][v] >= plan.out_expected[tenants[im]][v]
                        for v in progs[tenants[im]].gcu.outputs):
                    img_complete[im] = True
                    stats.completion_cycle[im] = cycle
            # deadline check AFTER completion: finishing exactly at the
            # deadline cycle is a success, missing it fails the image here
            for im in range(n_images):
                if dl[im] is not None and dl[im] <= cycle \
                        and not img_complete[im] and not failed[im]:
                    failed[im] = True
                    stats.failed_cycle[im] = cycle
                    if trace is not None:
                        trace.add_instant("deadline-failed", cycle, image=im)
                    progress = True

            # 2. GCU streaming (arrivals next cycle).  Failed images free
            # their in-flight slot and drop out of the candidate pool; an
            # in-progress stream is never aborted (the GCU is a dumb DMA).
            if cur_req is None and n_started < n_images:
                n_live = sum(1 for i in range(n_images)
                             if started[i] and not img_complete[i]
                             and not failed[i])
                if n_live < K:
                    cands = [i for i in range(n_images)
                             if not started[i] and not failed[i]
                             and plan.arrivals[i] <= cycle]
                    if cands:
                        cur_req = min(cands, key=plan.key)
                        cur_pix = 0
                        started[cur_req] = True
                        n_started += 1
                        stats.gcu_start_cycle[cur_req] = cycle
                        stream_seq[tenants[cur_req]].append(cur_req)
                        if stalls or trace is not None:
                            g_ = progs[tenants[cur_req]].gcu
                            _, ih_, iw_ = g_.input_shape
                            end_ = cycle + (ih_ * iw_ - 1) \
                                // chip.dma_pixels_per_cycle
                            gcu_send_end[cur_req] = end_
                            if trace is not None:
                                trace.add_gcu(cur_req, tenants[cur_req],
                                              cycle, end_)
            if cur_req is not None:
                if stalls:
                    gcu_busy += 1   # a picked request always streams >= 1px
                gcu = progs[tenants[cur_req]].gcu
                _, ih, iw = gcu.input_shape
                gcu_total = ih * iw
                for _ in range(chip.dma_pixels_per_cycle):
                    if cur_pix >= gcu_total:
                        break
                    pi, pj = cur_pix // iw, cur_pix % iw
                    for dst in gcu.dst_cores:
                        inflight.append(Message(
                            cycle + 1, dst, cur_req, gcu.input_value,
                            "pixel", (0, pi, pj),
                            images[cur_req][:, pi, pj].astype(np.float32)))
                        stats.messages += 1
                    cur_pix += 1
                    progress = True
                if cur_pix >= gcu_total:
                    gcu_done.add(cur_req)
                    cur_req = None

            # 3. core execution (based on start-of-cycle state).  With
            # ``stalls`` every skipped core is classified per cycle — this
            # inline scan is the attribution oracle the event engine's
            # reconstruction is asserted against.
            for core_id, cfg in self.cores_merged.items():
                d = dead_at.get(core_id)
                if d is not None and cycle >= d:
                    if stalls:
                        stall_counts[core_id][obs_stalls.DEAD] += 1
                    continue                 # dead core: executes nothing
                img = current_image(core_id)
                if img is None:
                    if stalls:
                        stall_counts[core_id][obs_stalls.classify_unassigned(
                            cycle, self.tenant_of_core[core_id], n_images,
                            plan.arrivals, tenants, stats.gcu_start_cycle,
                            gcu_send_end, stats.failed_cycle)] += 1
                    continue
                st = state(core_id, img)
                if st.done:
                    # unreachable (current_image skips core_done images,
                    # set exactly when st.done flips); classified anyway so
                    # the accounting identity cannot silently leak a cycle
                    if stalls:
                        stall_counts[core_id][obs_stalls.DRAINED] += 1
                    continue
                # replica cores walk the rank == repl_r (mod repl_k) stride
                # of the box; st.counter stays a local index
                it = _unflatten(st.counter * cfg.repl_k + cfg.repl_r,
                                cfg.iter_bounds)
                if not all(fr.safe(it) for frd in st.frontiers.values()
                           for fr in frd.values()):
                    if stalls:
                        if failed[img]:
                            cat = obs_stalls.FAILED
                        else:
                            # first blocking frontier in LCU/dep insertion
                            # order (identical in both engines); its data
                            # on a slow wire right now -> link-delay
                            cat = obs_stalls.DRAINED   # overwritten below
                            for v_, frd in st.frontiers.items():
                                for sp_, fr_ in frd.items():
                                    if fr_.safe(it):
                                        continue
                                    if obs_stalls.in_flight(delayed.get(
                                            (core_id, img, v_, sp_)), cycle):
                                        cat = obs_stalls.LINK_DELAY
                                    else:
                                        cat = obs_stalls.dep_key(v_, sp_)
                                    break
                                else:
                                    continue
                                break
                        stall_counts[core_id][cat] += 1
                    continue
                if schedule == "sequential" and not self._producers_done(
                        cfg, img, core_done, gcu_done):
                    if stalls:
                        if failed[img]:
                            cat = obs_stalls.FAILED
                        else:
                            # first not-yet-done producer in LCU/dep order
                            cat = obs_stalls.DRAINED   # overwritten below
                            part_core = self.progs[
                                self.tenant_of_core[core_id]].mapping
                            for v_, lc_ in cfg.lcu.items():
                                for dp_ in lc_.deps:
                                    sp_ = dp_.src_partition
                                    if sp_ == -1:
                                        if img in gcu_done:
                                            continue
                                    elif core_done[(part_core[sp_], img)]:
                                        continue
                                    cat = obs_stalls.dep_key(v_, sp_)
                                    break
                                else:
                                    continue
                                break
                        stall_counts[core_id][cat] += 1
                    continue
                msgs = self._execute_iteration(cfg, st, it, img, cycle,
                                               stats, delayed=delayed,
                                               trace=trace)
                if trace is not None:
                    trace.add_exec(core_id, img, cycle)
                inflight.extend(msgs)
                stats.messages += len(msgs)
                stats.bytes_sent += sum(m.payload.nbytes for m in msgs)
                stats.busy[core_id] += 1
                stats.first_busy.setdefault(core_id, cycle)
                stats.last_busy[core_id] = cycle
                st.counter += 1
                total = int(np.prod(cfg.iter_bounds))
                n_local = (total - cfg.repl_r + cfg.repl_k - 1) // cfg.repl_k
                if st.counter >= n_local:
                    st.done = True
                    core_done[(core_id, img)] = True
                progress = True

            # SRAM high-water: live buffers per core
            live = defaultdict(int)
            for (core, img), st in states.items():
                if not st.done:
                    live[core] += sum(b.nbytes for b in st.sram.values())
                    live[core] += sum(b.nbytes for b in st.pool_acc.values())
            for core, b in live.items():
                stats.sram_high_water[core] = max(stats.sram_high_water[core], b)

            if all(c or f for c, f in zip(img_complete, failed)):
                stats.cycles = cycle + 1
                if stalls:
                    stats.stalls = obs_stalls.StallBreakdown(
                        cycles=stats.cycles,
                        busy={cid: stats.busy.get(cid, 0)
                              for cid in self.cores_merged},
                        stalls={cid: dict(stall_counts[cid])
                                for cid in self.cores_merged},
                        stage_of_core=self.stage_of_core(),
                        gcu_busy=gcu_busy)
                return outputs, stats
            waiting_arrival = any(not started[i] and not failed[i]
                                  and plan.arrivals[i] > cycle
                                  for i in range(n_images))
            # a stalled pipeline with a pending deadline is not a deadlock:
            # the affected image resolves (fails) at its deadline cycle
            waiting_deadline = any(
                dl[i] is not None and dl[i] > cycle
                and not img_complete[i] and not failed[i]
                for i in range(n_images))
            if not progress and not inflight and cur_req is None \
                    and not waiting_arrival and not waiting_deadline:
                raise DeadlockError(
                    f"no progress at cycle {cycle}; "
                    f"complete={img_complete}, "
                    f"cores={{c: s.counter for (c, _), s in states.items()}}")
        raise DeadlockError(f"max_cycles={max_cycles} exceeded")

    # ------------------------------------------------------------- internals
    def _producers_done(self, cfg: CoreConfig, img: int, core_done,
                        gcu_done) -> bool:
        part_core = self.progs[self.tenant_of_core[cfg.core_id]].mapping
        for lc in cfg.lcu.values():
            for dep in lc.deps:
                src = dep.src_partition
                if src == -1:
                    if img not in gcu_done:  # GCU must have fully streamed it
                        return False
                elif not core_done[(part_core[src], img)]:
                    return False
        return True

    def _expected_chunks(self, value: str, tenant: int = 0) -> int:
        prog = self.progs[tenant]
        shape = prog.gcu.outputs[value]
        core = next(c for c in prog.cores.values()
                    for s in c.sends if s.value == value and s.to_gmem)
        spec = next(s for s in core.sends if s.value == value)
        return static_expected_chunks(spec.write.kind, shape)

    def _gmem_write(self, out: Dict[str, np.ndarray], counts, m: Message):
        arr = out[m.value]
        if m.kind in ("full", "reduce"):
            arr[:] = m.payload.reshape(arr.shape)
        else:
            _, i, j = m.loc
            arr[:, i, j] = m.payload
        counts[m.value] += 1

    def _sram_write(self, cfg: CoreConfig, st: _CoreImageState, m: Message):
        lc = cfg.lcu[m.value]
        buf = st.sram[m.value]
        if m.kind in ("full", "reduce"):
            buf[...] = m.payload.reshape(buf.shape)
        else:
            _, i, j = m.loc
            buf[:, i + lc.pad, j + lc.pad] = m.payload
        st.frontiers[m.value][m.src_part].observe(m.loc)
        if self.check_raw:
            if m.kind in ("full", "reduce"):
                st.written[m.value].add(())
            else:
                st.written[m.value].add((m.loc[1], m.loc[2]))

    def _raw_check(self, cfg: CoreConfig, st: _CoreImageState, it: Point):
        """Independent oracle: every location read must already be written."""
        for v, lc in cfg.lcu.items():
            shp = lc.shape
            if len(shp) != 3:
                if () not in st.written[v]:
                    raise RawViolation(f"{cfg.core_id}: read {v} before write")
                continue
            needed = self._read_set(cfg, v, it, shp)
            missing = needed - st.written[v]
            if missing:
                raise RawViolation(
                    f"core {cfg.core_id} iter {it}: reads {v} at unwritten "
                    f"locations {sorted(missing)[:4]}...")

    def _read_set(self, cfg: CoreConfig, v: str, it: Point, shp) -> set:
        _, H, W = shp
        need = set()
        if cfg.xbar_node is not None and cfg.xbar_node.op == "conv2d" \
                and cfg.xbar_input == v:
            s, p = cfg.conv_attrs["stride"], cfg.conv_attrs["pad"]
            fh, fw = cfg.conv_attrs["fh"], cfg.conv_attrs["fw"]
            oh, ow = it
            for i in range(oh * s - p, oh * s - p + fh):
                for j in range(ow * s - p, ow * s - p + fw):
                    if 0 <= i < H and 0 <= j < W:
                        need.add((i, j))
        if cfg.xbar_node is not None and cfg.xbar_node.op == "gemm" \
                and cfg.xbar_input == v:
            need |= {(i, j) for i in range(H) for j in range(W)}
        for n in cfg.dpu_nodes:
            if v in n.inputs and n.op in ("relu", "add", "layernorm",
                                          "softmax"):
                need.add((it[0], it[1]))
            elif v in n.inputs and n.op in ("maxpool2d", "avgpool2d"):
                k, s = n.attrs["k"], n.attrs["stride"]
                oh, ow = it
                need |= {(i, j) for i in range(oh * s, oh * s + k)
                         for j in range(ow * s, ow * s + k)
                         if 0 <= i < H and 0 <= j < W}
            elif v in n.inputs and n.op == "global_avgpool":
                need |= {(i, j) for i in range(H) for j in range(W)}
            elif v in n.inputs and n.op == "matmul":
                if v == n.inputs[0]:          # streamed operand: this token
                    need.add((it[0], it[1]))
                if v == n.inputs[1]:          # runtime matrix: everything
                    need |= {(i, j) for i in range(H) for j in range(W)}
            elif v in n.inputs and n.op == "transpose":
                need |= {(i, j) for i in range(H) for j in range(W)}
        return need

    def _execute_iteration(self, cfg: CoreConfig, st: _CoreImageState,
                           it: Point, img: int, cycle: int,
                           stats: Optional[SimStats] = None,
                           delayed=None, trace=None) -> List[Message]:
        if self.check_raw and cfg.lcu:
            self._raw_check(cfg, st, it)
        env: Dict[str, np.ndarray] = {}
        env_coords: Dict[str, Point] = {}
        pooled_ready: Dict[str, Tuple[Point, np.ndarray]] = {}
        reduce_ready: Dict[str, np.ndarray] = {}

        def pix(value: str) -> np.ndarray:
            if value in env:
                return env[value]
            lc = cfg.lcu[value]
            buf = st.sram[value]
            if len(lc.shape) != 3:
                return buf
            return buf[:, it[0] + lc.pad, it[1] + lc.pad]

        # 1. crossbar (one compute-plane MxV per iteration)
        if cfg.xbar_node is not None:
            desc = descriptor_for(cfg)
            if cfg.xbar_node.op == "conv2d":
                buf = st.sram[cfg.xbar_input]
                s = cfg.conv_attrs["stride"]
                fh, fw = cfg.conv_attrs["fh"], cfg.conv_attrs["fw"]
                oh, ow = it
                win = buf[:, oh * s:oh * s + fh, ow * s:ow * s + fw]
                # ascontiguousarray: for 1x1 windows (per-token projections)
                # reshape(-1) stays a strided *view*, and einsum is not
                # bit-stable across input strides — the event engine's
                # gathered rows are contiguous
                y = self.plane.mxv_one(
                    desc, np.ascontiguousarray(win.reshape(-1)))
            else:  # gemm
                vbuf = st.sram[cfg.xbar_input]
                y = self.plane.mxv_one(
                    desc, np.ascontiguousarray(vbuf.reshape(-1)))
            if cfg.xbar_bias is not None:
                y = y + cfg.xbar_bias
            env[cfg.xbar_node.outputs[0]] = y.astype(np.float32)
            env_coords[cfg.xbar_node.outputs[0]] = it

        # 2. DPU instruction sequence
        for n in cfg.dpu_nodes:
            if n.op == "relu":
                env[n.outputs[0]] = np.maximum(pix(n.inputs[0]), 0.0)
            elif n.op == "add":
                env[n.outputs[0]] = pix(n.inputs[0]) + pix(n.inputs[1])
            elif n.op in ("maxpool2d", "avgpool2d") and n.inputs[0] in cfg.lcu:
                # direct mode (pool heads its own partition, input streamed
                # in — the split-off form of a replicated stage): iteration
                # (ph, pw) gathers its whole k x k window from SRAM.  The
                # avg fold runs in the fused path's accumulation order
                # (row-major over the window, x/(k*k) per add) so the result
                # is bit-identical to the unreplicated fused pool.
                out = n.outputs[0]
                k, s = n.attrs["k"], n.attrs["stride"]
                lc = cfg.lcu[n.inputs[0]]
                buf = st.sram[n.inputs[0]]
                ph, pw = it
                win = np.ascontiguousarray(
                    buf[:, ph * s + lc.pad:ph * s + k + lc.pad,
                        pw * s + lc.pad:pw * s + k + lc.pad])
                flat = win.reshape(win.shape[0], -1)
                if n.op == "maxpool2d":
                    y = flat.max(axis=1)
                else:
                    xd = flat / (k * k)
                    y = np.zeros(win.shape[0], np.float32)
                    for j in range(k * k):
                        y += xd[:, j]
                env[out] = y.astype(np.float32)
                env_coords[out] = it
            elif n.op in ("maxpool2d", "avgpool2d"):
                out = n.outputs[0]
                k, s = n.attrs["k"], n.attrs["stride"]
                shp = self._values_for(cfg)[out].shape
                if out not in st.pool_acc:
                    init = -np.inf if n.op == "maxpool2d" else 0.0
                    st.pool_acc[out] = np.full(shp, init, np.float32)
                acc = st.pool_acc[out]
                x = pix(n.inputs[0])
                oh, ow = it
                # this pixel contributes to windows (ph, pw)
                for ph in range(max(0, (oh - k + s) // s if s else 0), shp[1]):
                    if not (ph * s <= oh < ph * s + k):
                        continue
                    for pw in range(shp[2]):
                        if not (pw * s <= ow < pw * s + k):
                            continue
                        if n.op == "maxpool2d":
                            acc[:, ph, pw] = np.maximum(acc[:, ph, pw], x)
                        else:
                            acc[:, ph, pw] += x / (k * k)
                        if oh == ph * s + k - 1 and ow == pw * s + k - 1:
                            pooled_ready[out] = ((ph, pw), acc[:, ph, pw].copy())
            elif n.op == "global_avgpool":
                out = n.outputs[0]
                src_shape = self._values_for(cfg)[n.inputs[0]].shape
                if out not in st.reduce_acc:
                    st.reduce_acc[out] = np.zeros(src_shape[0], np.float32)
                st.reduce_acc[out] += pix(n.inputs[0])
                if it == (src_shape[1] - 1, src_shape[2] - 1):
                    reduce_ready[out] = st.reduce_acc[out] / (
                        src_shape[1] * src_shape[2])
                    env[out] = reduce_ready[out]
            elif n.op == "layernorm":
                x = pix(n.inputs[0])
                w = self._weights_for(cfg)
                eps = np.float32(n.attrs["eps"])
                mu = x.mean()
                xc = x - mu
                var = (xc * xc).mean()
                env[n.outputs[0]] = (xc / np.sqrt(var + eps)
                                     * w[n.inputs[1]] + w[n.inputs[2]]
                                     ).astype(np.float32)
            elif n.op == "softmax":
                x = pix(n.inputs[0])
                e = np.exp(x - x.max())
                env[n.outputs[0]] = (e / e.sum()).astype(np.float32)
            elif n.op == "matmul":
                d = dyn_descriptor_for(cfg, n)
                # contiguous copy: einsum is not bit-stable across input
                # strides, and the event engine's batched rows are contiguous
                a = np.ascontiguousarray(pix(d.a_value), np.float32)
                bbuf = st.sram[d.b_value]
                dmat = bbuf.reshape(bbuf.shape[0], -1)
                if d.transpose_b:
                    dmat = dmat.T
                dmat = np.ascontiguousarray(dmat, np.float32)
                y = np.asarray(self.plane.dyn_mxv_one(dmat, a))
                if d.scale != 1.0:
                    y = y * np.float32(d.scale)
                env[n.outputs[0]] = y.astype(np.float32)
            elif n.op == "transpose":
                buf = st.sram[n.inputs[0]]
                env[n.outputs[0]] = buf[it[0], :, 0].copy()
            else:
                raise NotImplementedError(f"DPU op {n.op}")

        # 3. sends (arrive at cycle + 1, paper §2)
        msgs: List[Message] = []

        def emit(spec: SendSpec, kind: str, loc: Point, payload: np.ndarray):
            for dst in spec.dst_cores:
                link, key = self._link_for(cfg.core_id, dst)
                delay = 0
                if link is not None:
                    # fault state at the SEND cycle governs the message:
                    # a down link drops it (not delivered, not counted),
                    # a degraded link applies its effective spec
                    down, link = self._fault_link_state(key, cycle, link)
                    if down:
                        continue
                    delay = link.transfer_delay(payload.nbytes)
                    if stats is not None:
                        ls = stats.links.setdefault(key, LinkStats())
                        ls.messages += 1
                        ls.bytes += payload.nbytes
                        ls.busy += self._occupancy(link, payload.nbytes)
                    if delayed is not None and delay > 0:
                        # multi-cycle flight: feeds the link-delay stall
                        # predicate (open interval send < t < arrive)
                        delayed[(dst, img, spec.value, cfg.partition_idx)] \
                            .append((cycle, cycle + 1 + delay))
                    if trace is not None:
                        trace.add_link(key, spec.value, img,
                                       np.array([cycle]),
                                       np.array([cycle + 1 + delay]),
                                       payload.nbytes)
                msgs.append(Message(cycle + 1 + delay, dst, img, spec.value,
                                    kind, loc, payload.copy(),
                                    src_part=cfg.partition_idx))
            if spec.to_gmem:
                msgs.append(Message(cycle + 1, -1, img, spec.value, kind,
                                    loc, payload.copy(),
                                    src_part=cfg.partition_idx))

        for spec in cfg.sends:
            if spec.write.kind == "pixel" and spec.value in env:
                emit(spec, "pixel", (0, it[0], it[1]), env[spec.value])
            elif spec.write.kind == "pool" and spec.value in pooled_ready:
                (ph, pw), vec = pooled_ready[spec.value]
                emit(spec, "pool", (0, ph, pw), vec)
            elif spec.write.kind == "full" and spec.value in env:
                emit(spec, "full", (0,), env[spec.value])
            elif spec.write.kind == "reduce" and spec.value in reduce_ready:
                emit(spec, "reduce", (0,), reduce_ready[spec.value])
        return msgs


# ============================================================= event engine
class _TableFrontier:
    """Runtime view of a compiled frontier table, as a *ramp*.

    Streams are bulk-delivered at their first arrival cycle, so the frontier
    records the full time-course of its threshold as (cycle, limit)
    breakpoints: ``bp_limit`` is the running lexmax rank (mapped through the
    D_lexmin/D_lexmax rules) after the write landing at ``bp_cycle``.  Both
    arrays are non-decreasing, so ``unlock_vector`` — the first cycle at
    which each queried iteration rank becomes safe — is one searchsorted.
    """

    __slots__ = ("lut", "dmin", "dmax", "bound", "_chunks_c", "_chunks_l",
                 "_limit", "_cat_c", "_cat_l", "_dirty")

    def __init__(self, table: poly.FrontierTable):
        rank = table.rank
        # observe() locations carry a representative channel 0; S is
        # channel-invariant, so collapse the leading dim for 3-D arrays.
        self.lut = rank[0] if rank.ndim == 3 else rank
        self.dmin = table.d_lexmin_rank
        self.dmax = table.d_lexmax_rank
        self.bound = -1
        limit0 = _INF if table.never_constrains else table.d_lexmin_rank - 1
        c0 = np.array([-1], np.int64)
        l0 = np.array([limit0], np.int64)
        # breakpoints as a chunk list (one chunk per delivered stream); the
        # limits are globally non-decreasing, so the concatenated ramp stays
        # sorted and a lookup is a single searchsorted (the concatenation is
        # cached and rebuilt lazily after new chunks land)
        self._chunks_c = [c0]
        self._chunks_l = [l0]
        self._limit = limit0
        self._cat_c = c0
        self._cat_l = l0
        self._dirty = False

    @property
    def current_limit(self) -> int:
        return self._limit

    def observe_stream(self, arrive: np.ndarray, ranks: np.ndarray) -> bool:
        """Fold a whole write stream (arrival cycles + table ranks) in.

        Returns True iff the frontier limit advanced (a False stream can
        never unlock new iterations, so consumers skip the wake)."""
        if self._limit == _INF:
            return False
        cm, limits = poly.frontier_limit_ramp(ranks, self.dmin, self.dmax,
                                              self.bound)
        self.bound = int(cm[-1])
        self._chunks_c.append(arrive)
        self._chunks_l.append(limits)
        self._dirty = True
        new = int(limits[-1])
        if new == self._limit:
            return False
        self._limit = new
        return True

    def unlock_vector(self, ranks: np.ndarray) -> np.ndarray:
        """First cycle at which each rank (all <= current_limit) is safe."""
        if self._dirty:
            self._cat_c = np.concatenate(self._chunks_c)
            self._cat_l = np.concatenate(self._chunks_l)
            self._dirty = False
        return self._cat_c[self._cat_l.searchsorted(ranks, side="left")]


class _EvState:
    """Per-(core, image) runtime state (event engine)."""

    __slots__ = ("sram", "frontiers", "counter", "done", "pool_acc",
                 "reduce_acc", "wtime", "sram_bytes")

    def __init__(self, cfg: CoreConfig, check_raw: bool):
        self.sram: Dict[str, np.ndarray] = {}
        # value -> {src partition -> frontier} (one per producer replica)
        self.frontiers: Dict[str, Dict[int, _TableFrontier]] = {}
        self.wtime: Dict[str, np.ndarray] = {}
        for v, lc in cfg.lcu.items():
            shp = lc.shape
            if len(shp) == 3 and lc.pad:
                c, h, w = shp
                buf = np.zeros((c, h + 2 * lc.pad, w + 2 * lc.pad), np.float32)
            else:
                buf = np.zeros(shp, np.float32)
            self.sram[v] = buf
            frs: Dict[int, _TableFrontier] = {}
            for dp in lc.deps:
                if dp.table is None:  # config built without lower(): compile
                    dp.table = poly.compile_frontier_table(dp.dep, lc.shape,
                                                           cfg.iter_bounds)
                frs[dp.src_partition] = _TableFrontier(dp.table)
            self.frontiers[v] = frs
            if check_raw:
                if len(shp) == 3:
                    self.wtime[v] = np.full(shp[1:], _INF, np.int64)
                else:
                    self.wtime[v] = np.full((), _INF, np.int64)
        self.pool_acc: Dict[str, np.ndarray] = {}
        self.reduce_acc: Dict[str, np.ndarray] = {}
        self.counter = 0
        self.done = False
        self.sram_bytes = sum(b.nbytes for b in self.sram.values())


class _Stream:
    """A batched message flow: rows land one per listed arrival cycle."""

    __slots__ = ("dst", "img", "value", "kind", "locs", "payload", "arrive",
                 "src_part")

    def __init__(self, dst, img, value, kind, locs, payload, arrive,
                 src_part=-1):
        self.dst = dst
        self.img = img
        self.value = value
        self.kind = kind
        self.locs = locs              # (k, 2) int array or None (full/reduce)
        self.payload = payload        # (k, C) float32
        self.arrive = arrive          # length-k int list, non-decreasing
        self.src_part = src_part      # producing partition (-1: GCU)


class _EvCore:
    __slots__ = ("cfg", "order", "tenant", "total", "pos", "next_free",
                 "ridx", "p0", "p1", "locs", "win_idx", "rk", "rr")

    def __init__(self, cfg: CoreConfig, order: int, tenant: int):
        self.cfg = cfg
        self.order = order
        self.tenant = tenant
        self.rk = cfg.repl_k
        self.rr = cfg.repl_r
        self.pos = 0        # index into the tenant's GCU stream-start order
        self.next_free = 0
        # The core's iteration subsequence (global flat ranks), unflattened
        # once; batches slice views.  A replica core walks the
        # rank == repl_r (mod repl_k) stride of the box; ``total`` and all
        # counters are local indices into ``ridx``.
        idx = np.arange(self.rr, int(np.prod(cfg.iter_bounds)), self.rk)
        self.total = len(idx)
        self.ridx = idx
        if len(cfg.iter_bounds) == 2:
            w_b = cfg.iter_bounds[1]
            self.p0 = idx // w_b
            self.p1 = idx % w_b
            self.locs = np.stack([self.p0, self.p1], axis=1)
        else:
            self.p0 = idx
            self.p1 = None
            self.locs = None          # 1-D spaces only emit full/reduce sends
        # Conv window gather: flat indices of every iteration's input window
        # into the (padded) SRAM plane, (total, fh*fw) — shared by all images.
        self.win_idx = None
        if (cfg.xbar_node is not None and cfg.xbar_node.op == "conv2d"
                and cfg.xbar_input in cfg.lcu):
            lc = cfg.lcu[cfg.xbar_input]
            wp = lc.shape[2] + 2 * lc.pad
            s_ = cfg.conv_attrs["stride"]
            fh, fw = cfg.conv_attrs["fh"], cfg.conv_attrs["fw"]
            base = (self.p0 * s_) * wp + self.p1 * s_
            off = (np.arange(fh)[:, None] * wp + np.arange(fw)).reshape(-1)
            self.win_idx = base[:, None] + off[None, :]


# per-cycle phase order, mirroring the reference engine's step order
_PH_DELIVER, _PH_GCU, _PH_CORE = 0, 1, 2


class _EventEngine:
    def __init__(self, sim: Simulator, images, schedule: str, max_cycles: int,
                 plan: _RequestPlan, stalls: bool = False, trace=None):
        self.sim = sim
        # Observability.  ``stalls`` keeps two tiny logs —
        # per-batch (core, image, first counter, exec cycles) and the
        # delayed-message intervals — from which ``_build_stalls``
        # reconstructs the reference engine's per-cycle classification
        # exactly (frontier unlock ramps are time-invariant, so the final
        # ramp answers "was rank r safe at cycle t" for any t).
        self.stalls = stalls
        self.trace = trace
        self.stall_batches: List[Tuple[int, int, int, np.ndarray]] = []
        self.delayed: Dict[tuple, List[Tuple[int, int]]] = defaultdict(list)
        self.progs = sim.progs
        self.chip = sim.chip
        self.images = images
        self.schedule = schedule
        self.max_cycles = max_cycles
        self.n_images = len(images)
        self.plan = plan
        self.tenants = plan.tenants

        self.cores: Dict[int, _EvCore] = {
            cid: _EvCore(cfg, i, sim.tenant_of_core[cid])
            for i, (cid, cfg) in enumerate(sim.cores_merged.items())}
        self._rel = np.arange(max(c.total for c in self.cores.values())
                              if self.cores else 1)
        self.part_core = [p.mapping for p in self.progs]
        # sequential-schedule wakeups: (tenant, partition) -> consumer cores
        self.consumers: Dict[Tuple[int, int], List[int]] = defaultdict(list)
        self.gcu_consumers: List[List[int]] = [[] for _ in self.progs]
        for cid, cfg in sim.cores_merged.items():
            tk = sim.tenant_of_core[cid]
            for lc in cfg.lcu.values():
                for dp in lc.deps:
                    if dp.src_partition == -1:
                        self.gcu_consumers[tk].append(cid)
                    else:
                        self.consumers[(tk, dp.src_partition)].append(cid)
        self._raw_ops = {cid: self._compile_raw_ops(cfg)
                         for cid, cfg in sim.cores_merged.items()}
        self._pool_tabs: Dict[Tuple[int, str], tuple] = {}
        self.strict_float = sim.strict_float_order

        self.states: Dict[Tuple[int, int], _EvState] = {}
        self.outputs = [
            {v: np.zeros(s, np.float32)
             for v, s in self.progs[self.tenants[i]].gcu.outputs.items()}
            for i in range(self.n_images)]
        self.out_counts = [defaultdict(int) for _ in range(self.n_images)]
        self.out_expected = plan.out_expected
        self.img_complete = [False] * self.n_images
        self.complete_cycle: Dict[int, int] = {}   # img -> exact cycle
        self.img_failed = [False] * self.n_images
        self.failed_cycle: Dict[int, int] = {}     # img -> deadline cycle
        self._retired: set = set()   # images whose admission slot was freed
        self.dead_at = sim.dead_at
        self.out_last_arrive = [0] * self.n_images
        self.done_cycle: Dict[Tuple[int, int], int] = {}
        self.gcu_done_cycle: Dict[int, int] = {}
        self.t_end: Optional[int] = None

        # GCU request-selection state (shared host DMA across tenants): the
        # stream-start order per tenant doubles as each core's processing
        # order, so priority admission reorders the whole pipeline, not just
        # the injection.
        self.gcu_unstarted = list(range(self.n_images))
        self.gcu_free_at = 0
        self.gcu_inflight = 0
        self.gcu_blocked = False
        self.gcu_start: Dict[int, int] = {}
        self.stream_seq: List[List[int]] = [[] for _ in self.progs]

        self.heap: List[tuple] = []
        self._seq = 0
        self._sched_keys = set()

        # accounting logs (filtered by t_end when assembling stats)
        self.log_core: List[np.ndarray] = []
        self.log_cycle: List[np.ndarray] = []
        self.log_msgs: List[np.ndarray] = []
        self.log_bytes: List[np.ndarray] = []
        # inter-chip link log: (link key, send cycles, row bytes, occupancy)
        self.log_link: List[Tuple[Tuple[int, int], np.ndarray, int, int]] = []
        self.gcu_log: List[Tuple[np.ndarray, int]] = []
        # SRAM buffer-lifetime events: (cycle, core, delta_bytes, delta_count)
        # replayed in _assemble_stats as the reference's end-of-cycle samples.
        self._mem_events: List[Tuple[int, int, int, int]] = []

    # ------------------------------------------------------------ event heap
    def _push(self, cycle: int, phase: int, order: int, kind: str, data):
        self._seq += 1
        heapq.heappush(self.heap, (cycle, phase, order, self._seq, kind, data))

    def _sched_core(self, cid: int, cycle: int) -> None:
        core = self.cores[cid]
        cycle = max(cycle, core.next_free)
        key = (cid, cycle)
        if key in self._sched_keys:
            return
        self._sched_keys.add(key)
        self._push(cycle, _PH_CORE, core.order, "core", cid)

    # ------------------------------------------------------------ state mgmt
    def _state(self, cid: int, img: int, t: int) -> _EvState:
        """Get-or-create (core, image) state; ``t`` is the creation cycle.

        The reference engine instantiates states the first cycle they are
        touched (message arrival, or the cycle the core starts considering
        the image), so the creation event is stamped with the event cycle.
        """
        key = (cid, img)
        st = self.states.get(key)
        if st is None:
            st = _EvState(self.sim.cores_merged[cid], self.sim.check_raw)
            self.states[key] = st
            self._mem_events.append((t, cid, st.sram_bytes, 1))
        return st

    def _current_image(self, core: _EvCore) -> Optional[int]:
        """The core's current image: next in its tenant's GCU stream-start
        order (None while the next one hasn't begun streaming)."""
        seq = self.stream_seq[core.tenant]
        if core.pos < len(seq):
            return seq[core.pos]
        return None

    def _retire_state(self, cid: int, st: _EvState, t: int) -> None:
        pool = sum(b.nbytes for b in st.pool_acc.values())
        self._mem_events.append((t, cid, -(st.sram_bytes + pool), -1))

    # ------------------------------------------------------------------ run
    def run(self):
        stats = SimStats()
        if self.n_images == 0:
            stats.cycles = 1
            if self.stalls:
                # one-cycle empty run: every core idles drained (matches
                # the reference's cycle-0 classification; dead-at-0 wins)
                stats.stalls = obs_stalls.StallBreakdown(
                    cycles=1, busy={cid: 0 for cid in self.cores},
                    stalls={cid: {obs_stalls.DEAD
                                  if self.dead_at.get(cid, 1) <= 0
                                  else obs_stalls.DRAINED: 1}
                            for cid in self.cores},
                    stage_of_core=self.sim.stage_of_core(), gcu_busy=0)
            return self.outputs, stats

        for cid in self.cores:
            self._sched_core(cid, 0)
        self._push(min(self.plan.arrivals), _PH_GCU, 0, "gcu", 0)
        # deadline events fire after the cycle's deliveries (order 0) and
        # admit retirements (order 1): completion at the deadline cycle is
        # checked first, mirroring the reference's phase-1 ordering
        for i, d in enumerate(self.plan.deadlines):
            if d is not None:
                self._push(d, _PH_DELIVER, 2, "deadline", i)

        heap = self.heap
        while heap:
            cycle, phase, order, _, kind, data = heapq.heappop(heap)
            if self.t_end is not None and cycle > self.t_end:
                break
            if cycle >= self.max_cycles:
                raise DeadlockError(f"max_cycles={self.max_cycles} exceeded")
            if kind == "stream":
                self._deliver(cycle, data)
            elif kind == "gcu":
                self._gcu_stream(cycle, data)
            elif kind == "admit":
                self._gcu_retire(cycle, data)
            elif kind == "deadline":
                self._deadline(cycle, data)
            else:  # "core"
                self._sched_keys.discard((data, cycle))
                self._core_step(cycle, data)

        if self.t_end is None:
            raise DeadlockError(
                "no progress: event queue drained before completion; "
                f"complete={self.img_complete}, "
                f"cores={{c: s.counter for (c, _), s in self.states.items()}}")
        if self.t_end >= self.max_cycles:
            # completion would land past the cycle budget: the reference
            # engine's dense scan raises here, so must we
            raise DeadlockError(f"max_cycles={self.max_cycles} exceeded")
        return self.outputs, self._assemble_stats()

    def _assemble_stats(self) -> SimStats:
        stats = SimStats()
        stats.cycles = self.t_end + 1
        for send_cycles, n_dsts in self.gcu_log:
            stats.messages += int((send_cycles <= self.t_end).sum()) * n_dsts
        if self.log_core:
            cores = np.concatenate(self.log_core)
            cycles = np.concatenate(self.log_cycle)
            msgs = np.concatenate(self.log_msgs)
            nbytes = np.concatenate(self.log_bytes)
            valid = cycles <= self.t_end
            cores, cycles = cores[valid], cycles[valid]
            stats.messages += int(msgs[valid].sum())
            stats.bytes_sent = int(nbytes[valid].sum())
            for cid in np.unique(cores):
                sel = cores == cid
                stats.busy[int(cid)] = int(sel.sum())
                stats.first_busy[int(cid)] = int(cycles[sel].min())
                stats.last_busy[int(cid)] = int(cycles[sel].max())
        for key, send_cycles, row_bytes, occ in self.log_link:
            n = int((send_cycles <= self.t_end).sum())
            if not n:
                continue
            ls = stats.links.setdefault(key, LinkStats())
            ls.messages += n
            ls.bytes += n * row_bytes
            ls.busy += n * occ
        stats.gcu_start_cycle = dict(self.gcu_start)
        stats.completion_cycle = dict(self.complete_cycle)
        stats.failed_cycle = dict(self.failed_cycle)
        self._replay_high_water(stats)
        if self.stalls:
            stats.stalls = self._build_stalls(stats)
        return stats

    def _refresh_end(self) -> None:
        """Recompute ``t_end`` once every image is complete-or-failed.

        Called from completion and deadline handlers; a deadline can
        *revert* a premature bulk-delivery completion claim (rows that would
        land after the deadline), so the end cycle is recomputed rather than
        latched.  Every event popped so far has cycle <= the new end, so a
        shrinking ``t_end`` never un-processes anything.
        """
        if all(c or f for c, f in zip(self.img_complete, self.img_failed)):
            self.t_end = max(list(self.complete_cycle.values())
                             + list(self.failed_cycle.values()))

    def _replay_high_water(self, stats: SimStats) -> None:
        """Replay end-of-cycle SRAM sampling from the buffer-lifetime log.

        The reference engine samples ``sum(buffer bytes of not-done states)``
        per core at the end of every cycle.  Between log events the sum is
        constant, so sweeping the (cycle, Δbytes, Δstates) events in cycle
        order — applying all of a cycle's deltas *before* sampling — yields
        the identical per-core maximum, including same-cycle create/retire
        overlaps that net out.  Only cycles <= t_end exist in the reference.
        """
        ev = sorted(e for e in self._mem_events if e[0] <= self.t_end)
        cur = defaultdict(int)
        cnt = defaultdict(int)
        i, n = 0, len(ev)
        while i < n:
            c = ev[i][0]
            touched = set()
            while i < n and ev[i][0] == c:
                _, cid, db, dc = ev[i]
                cur[cid] += db
                cnt[cid] += dc
                touched.add(cid)
                i += 1
            for cid in touched:
                if cnt[cid] > 0 and cur[cid] >= stats.sram_high_water[cid]:
                    stats.sram_high_water[cid] = cur[cid]

    # ----------------------------------------------------- stall attribution
    # Reconstruction of the reference engine's per-cycle classification.
    # Nothing here is engine-new information: frontier unlock ramps are
    # time-invariant (the final ramp answers "was rank r safe at cycle t"
    # for any t <= t_end), the GCU stream windows/stream order determine
    # each core's current image per cycle, and the batch log pins which
    # counter a gap cycle was blocked on.  The result is asserted bit-equal
    # to the oracle in tests/test_obs.py.

    def _classify_unassigned(self, t: int, tenant: int) -> str:
        # gcu_done_cycle IS the last-send cycle, i.e. the reference's
        # gcu_send_end; all predicates filter by <= t, so evaluating the
        # final dicts post hoc equals the reference's inline partial view
        return obs_stalls.classify_unassigned(
            t, tenant, self.n_images, self.plan.arrivals, self.tenants,
            self.gcu_start, self.gcu_done_cycle, self.failed_cycle)

    def _blocked_category(self, cid: int, core: _EvCore, st, img: int,
                          ctr: int, t: int) -> str:
        """Why core ``cid`` did not execute counter ``ctr`` of ``img`` at
        idle cycle ``t`` — mirrors the reference's phase-3 skip order:
        failed image, then first blocking frontier (LCU/dep insertion
        order), then the sequential producer gate."""
        fc = self.failed_cycle.get(img)
        if fc is not None and fc <= t:
            return obs_stalls.FAILED
        cfg = core.cfg
        if st is not None and ctr < core.total:
            rank = int(core.ridx[ctr])
            probe = np.array([rank], np.int64)
            for v, frd in st.frontiers.items():
                for sp, fr in frd.items():
                    if rank > fr.current_limit:
                        u = obs_stalls.INF_CYCLE   # never unlocked this run
                    else:
                        u = int(fr.unlock_vector(probe)[0])
                    if u > t:
                        if obs_stalls.in_flight(
                                self.delayed.get((cid, img, v, sp)), t):
                            return obs_stalls.LINK_DELAY
                        return obs_stalls.dep_key(v, sp)
        if self.schedule == "sequential":
            # visible-done cycles per _gate_cycle: a producer finishing at
            # cycle d is visible at d to later-ordered cores, d+1 otherwise
            my_order = core.order
            for v, lc in cfg.lcu.items():
                for dp in lc.deps:
                    sp = dp.src_partition
                    if sp == -1:
                        dc = self.gcu_done_cycle.get(img)
                        vis = obs_stalls.INF_CYCLE if dc is None else dc
                    else:
                        pc = self.part_core[core.tenant][sp]
                        dcc = self.done_cycle.get((pc, img))
                        if dcc is None:
                            vis = obs_stalls.INF_CYCLE
                        else:
                            vis = dcc if self.cores[pc].order < my_order \
                                else dcc + 1
                    if vis > t:
                        return obs_stalls.dep_key(v, sp)
        raise RuntimeError(
            f"unattributed stall: core {cid} image {img} counter {ctr} "
            f"cycle {t}")

    def _build_stalls(self, stats: SimStats) -> "obs_stalls.StallBreakdown":
        t_end = self.t_end
        # per-(core, image) executed (counter, cycle) chunks, in exec order
        ex: Dict[Tuple[int, int], List[Tuple[int, np.ndarray]]] = {}
        for cid, img, c0, cycles in self.stall_batches:
            ex.setdefault((cid, img), []).append((c0, cycles))
        # streams are contiguous [start, last-send] and non-overlapping, so
        # the per-cycle "GCU streamed" count is the clipped window sum
        gcu_busy = 0
        for i, s in self.gcu_start.items():
            if s <= t_end:
                gcu_busy += min(self.gcu_done_cycle[i], t_end) - s + 1
        breakdown: Dict[int, Dict[str, int]] = {}
        for cid, core in self.cores.items():
            cats: Dict[str, int] = defaultdict(int)
            dead = self.dead_at.get(cid)
            horizon = t_end if dead is None else min(t_end, dead - 1)
            seq = self.stream_seq[core.tenant]
            pos, prev_done, t = 0, -1, 0
            while t <= horizon:
                img = seq[pos] if pos < len(seq) else None
                start = 0
                if img is not None:
                    # the image is the core's current work item from the
                    # later of its stream start and the previous retirement
                    start = max(self.gcu_start[img], prev_done + 1)
                if img is None or t < start:
                    cats[self._classify_unassigned(t, core.tenant)] += 1
                    t += 1
                    continue
                done = self.done_cycle.get((cid, img))
                period_end = horizon if done is None else min(done, horizon)
                chunks = ex.get((cid, img), [])
                if chunks:
                    ctrs = np.concatenate(
                        [np.arange(c0, c0 + len(cy), dtype=np.int64)
                         for c0, cy in chunks])
                    cycs = np.concatenate([cy for _, cy in chunks])
                else:
                    ctrs = cycs = np.empty(0, np.int64)
                st = self.states.get((cid, img))
                n_ex = len(cycs)
                j = 0
                for tt in range(t, period_end + 1):
                    while j < n_ex and cycs[j] < tt:
                        j += 1
                    if j < n_ex and cycs[j] == tt:
                        continue                    # executed: busy cycle
                    # blocked on the first not-yet-executed counter at tt
                    if j < n_ex:
                        ctr = int(ctrs[j])
                    else:
                        ctr = int(ctrs[-1]) + 1 if n_ex else 0
                    cats[self._blocked_category(cid, core, st, img, ctr,
                                                tt)] += 1
                t = period_end + 1
                if done is not None and done <= horizon:
                    prev_done = done
                    pos += 1
            if dead is not None and dead <= t_end:
                cats[obs_stalls.DEAD] += t_end - max(dead, 0) + 1
            breakdown[cid] = dict(cats)
        return obs_stalls.StallBreakdown(
            cycles=stats.cycles,
            busy={cid: stats.busy.get(cid, 0) for cid in self.cores},
            stalls=breakdown,
            stage_of_core=self.sim.stage_of_core(),
            gcu_busy=gcu_busy)

    # ------------------------------------------------------------------ GCU
    # The GCU is one shared host DMA: at each decision point it picks the
    # next request among the *arrived*, unstarted images (FIFO or priority
    # key), subject to the admission bound, and streams it back-to-back.
    # Decision points: the GCU going free, a future arrival, or — when
    # blocked on the bound — an image completing (the "admit" event, timed
    # at the completion cycle so both engines see the same in-flight count).
    def _gcu_stream(self, t: int, _img_unused: int) -> None:
        if not self.gcu_unstarted or t < self.gcu_free_at:
            return
        if self.gcu_inflight >= self.plan.max_inflight:
            self.gcu_blocked = True        # resumed by the next retirement
            return
        arr = self.plan.arrivals
        cands = [i for i in self.gcu_unstarted if arr[i] <= t]
        if not cands:
            self._push(min(arr[i] for i in self.gcu_unstarted),
                       _PH_GCU, 0, "gcu", 0)
            return
        img = min(cands, key=self.plan.key)
        self.gcu_unstarted.remove(img)
        self.gcu_inflight += 1
        self.gcu_start[img] = t
        tk = self.tenants[img]
        gcu = self.progs[tk].gcu
        c_in, ih, iw = gcu.input_shape
        total = ih * iw
        dma = self.chip.dma_pixels_per_cycle
        pix = np.arange(total)
        send_cycles = t + pix // dma
        arrive = send_cycles + 1
        locs = np.stack([pix // iw, pix % iw], axis=1)
        payload = np.ascontiguousarray(
            self.images[img].reshape(c_in, total).T, np.float32)
        first = int(arrive[0])
        for dst in gcu.dst_cores:
            s = _Stream(dst, img, gcu.input_value, "pixel", locs, payload,
                        arrive)
            self._push(first, _PH_DELIVER, 0, "stream", s)
        self.gcu_log.append((send_cycles, len(gcu.dst_cores)))
        end = int(send_cycles[-1])
        self.gcu_done_cycle[img] = end
        if self.trace is not None:
            self.trace.add_gcu(img, tk, t, end)
        # the image becomes the tenant's cores' next work item the cycle its
        # streaming starts (reference phase order: GCU before core exec)
        self.stream_seq[tk].append(img)
        for cid in self.progs[tk].cores:
            core = self.cores[cid]
            if core.pos == len(self.stream_seq[tk]) - 1:
                self._sched_core(cid, t)
        if self.schedule == "sequential":
            for cid in self.gcu_consumers[tk]:
                self._sched_core(cid, end)
        self.gcu_free_at = end + 1
        if self.gcu_unstarted:
            self._push(end + 1, _PH_GCU, 0, "gcu", 0)

    def _gcu_retire(self, t: int, img: int) -> None:
        """An in-flight image resolved — completed (fired at its exact
        completion cycle, delivery phase — the same cycle the reference
        engine's admission gate sees the slot free) or deadline-failed.
        Idempotent: a deadline may free the slot before a stale "admit"
        event from a reverted completion claim fires."""
        if img in self._retired:
            return
        self._retired.add(img)
        self.gcu_inflight -= 1
        if self.gcu_blocked and self.gcu_inflight < self.plan.max_inflight:
            self.gcu_blocked = False
            self._push(t, _PH_GCU, 0, "gcu", 0)

    def _deadline(self, t: int, img: int) -> None:
        """Deadline event: fail the image unless it completed by now.

        A bulk delivery may have stamped a completion cycle PAST the
        deadline (its rows were still in flight at ``t``); the reference
        engine fails such an image at the deadline, so the premature claim
        is reverted here before failing.
        """
        if self.img_failed[img]:
            return
        cc = self.complete_cycle.get(img)
        if cc is not None and cc <= t:
            return                            # made the deadline
        if cc is not None:                    # premature bulk claim: revert
            del self.complete_cycle[img]
            self.img_complete[img] = False
        self.img_failed[img] = True
        self.failed_cycle[img] = t
        if self.trace is not None:
            self.trace.add_instant("deadline-failed", t, image=img)
        if img in self.gcu_start:             # started: free its slot now
            self._gcu_retire(t, img)
        else:                                 # unstarted: never admit it
            if img in self.gcu_unstarted:
                self.gcu_unstarted.remove(img)
            self._retired.add(img)
        self._refresh_end()

    def _link_segments(self, key, base, send: np.ndarray):
        """Split a stream's send cycles into contiguous fault-timeline
        segments: ``(slice, down, effective LinkSpec)`` per run.  ``send``
        is non-decreasing, so each timeline state covers one contiguous
        run of rows; unfaulted links short-circuit to a single segment."""
        if key not in self.sim._faulted_links:
            return [(slice(0, len(send)), False, base)]
        breaks, states = self.sim._link_timeline(key, base)
        idx = np.searchsorted(breaks, send, side="right")
        out = []
        start, n = 0, len(send)
        while start < n:
            v = int(idx[start])
            end = start + int(np.searchsorted(idx[start:], v, side="right"))
            down, spec = states[v]
            out.append((slice(start, end), down, spec))
            start = end
        return out

    # ------------------------------------------------------------- delivery
    # Streams are delivered in ONE event at their first arrival cycle: SRAM
    # slice-assignments are safe ahead of time (single-assignment arrays) and
    # the exact per-row timing is preserved in the frontier ramp / write-time
    # stamps, which is all the consumers ever observe.
    def _deliver(self, t: int, s: _Stream) -> None:
        if s.dst == -1:
            self._gmem_stream(t, s)
        else:
            self._sram_stream(t, s)

    def _gmem_stream(self, t: int, s: _Stream) -> None:
        arr = self.outputs[s.img][s.value]
        if s.kind in ("full", "reduce"):
            arr[:] = s.payload[0].reshape(arr.shape)
        else:
            ii, jj = s.locs[:, 0], s.locs[:, 1]
            arr[:, ii, jj] = s.payload.T
        counts = self.out_counts[s.img]
        counts[s.value] += len(s.payload)
        last = self.out_last_arrive[s.img]
        if s.arrive[-1] > last:
            last = int(s.arrive[-1])
            self.out_last_arrive[s.img] = last
        if self.img_failed[s.img]:
            return        # failed images never complete (reference contract)
        tk = self.tenants[s.img]
        if not self.img_complete[s.img] and all(
                counts[v] >= self.out_expected[tk][v]
                for v in self.progs[tk].gcu.outputs):
            self.img_complete[s.img] = True
            self.complete_cycle[s.img] = last
            self._refresh_end()
            # in-flight slot frees at the exact completion cycle, which may
            # lie past this bulk delivery's pop cycle
            self._push(last, _PH_DELIVER, 1, "admit", s.img)

    def _sram_stream(self, t: int, s: _Stream) -> None:
        cfg = self.sim.cores_merged[s.dst]
        st = self._state(s.dst, s.img, t)
        lc = cfg.lcu[s.value]
        buf = st.sram[s.value]
        fr = st.frontiers[s.value][s.src_part]
        arrive = np.asarray(s.arrive, np.int64)
        if s.kind in ("full", "reduce"):
            buf[...] = s.payload[0].reshape(buf.shape)
            if self.sim.check_raw:
                st.wtime[s.value][...] = arrive[0]
            advanced = fr.observe_stream(arrive, fr.lut[0:1])
        else:
            ii, jj = s.locs[:, 0], s.locs[:, 1]
            buf[:, ii + lc.pad, jj + lc.pad] = s.payload.T
            if self.sim.check_raw:
                st.wtime[s.value][ii, jj] = arrive
            advanced = fr.observe_stream(arrive, fr.lut[ii, jj])
        # a stream that does not advance its frontier limit cannot unlock
        # new iterations, so the core wake would be a no-op
        if advanced:
            core = self.cores[s.dst]
            if s.img == self._current_image(core):
                self._sched_core(s.dst, t)

    # -------------------------------------------------------- core execution
    def _gate_cycle(self, cfg: CoreConfig, cid: int, img: int) -> Optional[int]:
        """Sequential schedule: first cycle all producers count as done.

        A producer finishing at cycle d is visible the same cycle only to
        cores executing later in the per-cycle core order (reference step-3
        semantics); earlier cores see it at d + 1.  Returns None while some
        producer has not finished yet.
        """
        my_order = self.cores[cid].order
        tk = self.cores[cid].tenant
        g = 0
        for lc in cfg.lcu.values():
            for dp in lc.deps:
                if dp.src_partition == -1:
                    dc = self.gcu_done_cycle.get(img)
                    if dc is None:
                        return None
                    g = max(g, dc)
                else:
                    pc = self.part_core[tk][dp.src_partition]
                    d = self.done_cycle.get((pc, img))
                    if d is None:
                        return None
                    g = max(g, d if self.cores[pc].order < my_order
                            else d + 1)
        return g

    def _core_step(self, t: int, cid: int) -> None:
        core = self.cores[cid]
        img = self._current_image(core)
        if img is None:
            return       # next image not streamed yet: woken at stream start
        cfg = core.cfg
        # the reference engine only *considers* this image once the previous
        # one retired (done + 1 == next_free), so a first-touch creation here
        # is stamped at that cycle, not at the (possibly earlier) wake event
        consider = max(t, core.next_free)
        d = self.dead_at.get(cid)
        if d is not None and consider >= d:
            # dead before first considering this image: the reference's
            # phase-3 skip fires before its state() first-touch, so no
            # state may be created here either (SRAM accounting parity)
            return
        st = self._state(cid, img, consider)
        if st.done:
            return
        floor = 0
        if self.schedule == "sequential":
            gate = self._gate_cycle(cfg, cid, img)
            if gate is None:
                return               # woken again when producers finish
            floor = gate
        limit = _INF
        for frd in st.frontiers.values():
            for fr in frd.values():
                cl = fr.current_limit
                if cl < limit:
                    limit = cl
        # ``limit`` is a global-rank bound; the highest admitted *local*
        # index is floor((limit - rr) / rk) (identity for rk=1, rr=0)
        hi = min((limit - core.rr) // core.rk, core.total - 1)
        k = hi - st.counter + 1
        if k <= 0:
            return
        # exact §2 pacing: c(r) = max(unlock(r), c(r-1) + 1), solved as a
        # prefix-max so the whole batch is stamped in a few array ops
        ranks = core.ridx[st.counter:st.counter + k]
        unlock = np.full(k, max(floor, core.next_free), np.int64)
        for frd in st.frontiers.values():
            for fr in frd.values():
                if fr.current_limit != _INF or len(fr._chunks_l) > 1:
                    np.maximum(unlock, fr.unlock_vector(ranks), out=unlock)
        rel = self._rel[:k]
        cycles = rel + np.maximum.accumulate(unlock - rel)
        if d is not None:
            # dead core: only iterations paced strictly before the death
            # cycle execute.  ``cycles`` is strictly increasing, and any
            # later recompute of a truncated iteration's cycle can only be
            # >= its value here, so the cut is exact and wakes past the
            # death are no-ops — the stalled stream is detected downstream
            # via request deadlines.
            alive = int(np.searchsorted(cycles, d, side="left"))
            if alive == 0:
                return
            cycles = cycles[:alive]
        self._execute_batch(cid, core, cfg, st, img, cycles)
        core.next_free = int(cycles[-1]) + 1
        if st.counter >= core.total:
            st.done = True
            last_cycle = int(cycles[-1])
            self._retire_state(cid, st, last_cycle)
            self.done_cycle[(cid, img)] = last_cycle
            core.pos += 1
            if self._current_image(core) is not None:
                self._sched_core(cid, last_cycle + 1)
            # else: the next image hasn't begun streaming; the GCU wakes
            # this core the cycle it does
            if self.schedule == "sequential":
                for cid2 in self.consumers.get((core.tenant,
                                                cfg.partition_idx), ()):
                    self._sched_core(cid2, last_cycle)
                    self._sched_core(cid2, last_cycle + 1)

    def _pool_table(self, cid: int, node, cfg: CoreConfig,
                    shp: Tuple[int, ...]) -> tuple:
        """COO map of pixel -> contributing pool windows, built once per
        (core, pool op): entry arrays sorted in the reference's accumulation
        order (pixel asc, then window lex asc), a prefix ``row_off`` so a
        batch of iterations is one slice, and ``complete[f]`` = the window
        (flattened) whose last contributing pixel is ``f`` (or -1)."""
        key = (cid, node.name)
        tab = self._pool_tabs.get(key)
        if tab is None:
            H, W = cfg.iter_bounds
            kk, s_ = node.attrs["k"], node.attrs["stride"]
            PH, PW = shp[1], shp[2]
            e_pix: List[int] = []
            e_win: List[int] = []
            complete = np.full(H * W, -1, np.int64)
            row_off = np.zeros(H * W + 1, np.int64)
            for oh in range(H):
                for ow in range(W):
                    f = oh * W + ow
                    ph_lo = max(0, (oh - kk + s_) // s_ if s_ else 0)
                    ph_hi = min(PH - 1, oh // s_)
                    pw_lo = max(0, (ow - kk + s_) // s_ if s_ else 0)
                    pw_hi = min(PW - 1, ow // s_)
                    for ph in range(ph_lo, ph_hi + 1):
                        for pw in range(pw_lo, pw_hi + 1):
                            e_pix.append(f)
                            e_win.append(ph * PW + pw)
                            if (oh == ph * s_ + kk - 1
                                    and ow == pw * s_ + kk - 1):
                                complete[f] = ph * PW + pw
                    row_off[f + 1] = len(e_pix)
            tab = (np.array(e_pix, np.int64), np.array(e_win, np.int64),
                   row_off, complete)
            self._pool_tabs[key] = tab
        return tab

    def _execute_batch(self, cid: int, core: _EvCore, cfg: CoreConfig,
                       st: _EvState, img: int, cycles: np.ndarray) -> None:
        sim = self.sim
        k = len(cycles)
        c0 = st.counter
        sl = slice(c0, c0 + k)
        pts0 = core.p0[sl]
        pts1 = core.p1[sl] if core.p1 is not None else None
        if sim.check_raw and cfg.lcu:
            self._raw_check_batch(cid, cfg, st, pts0, pts1, cycles)

        env: Dict[str, np.ndarray] = {}          # value -> (k, ...) batches
        pooled_rows: Dict[str, tuple] = {}       # out -> (iter idx, win idx)
        reduce_rows: Dict[str, tuple] = {}

        def pix(value: str) -> np.ndarray:
            if value in env:
                return env[value]
            lc = cfg.lcu[value]
            buf = st.sram[value]
            if len(lc.shape) != 3:
                return np.broadcast_to(buf.reshape(1, -1), (k, buf.size))
            if k == 1:
                return buf[:, int(pts0[0]) + lc.pad,
                           int(pts1[0]) + lc.pad][None]
            return buf[:, pts0 + lc.pad, pts1 + lc.pad].T

        # 1. crossbar: windows gathered vectorized, one stacked compute-plane
        # dispatch for the whole batch
        if cfg.xbar_node is not None:
            if cfg.xbar_node.op == "conv2d":
                buf = st.sram[cfg.xbar_input]
                ch = buf.shape[0]
                fi = core.win_idx[sl].reshape(-1)
                # gather (C, k*fh*fw) then interleave to (k, C*fh*fw): each
                # row is one iteration's window in crossbar layout
                g = buf.reshape(ch, -1)[:, fi]
                V = (g.reshape(ch, k, -1).transpose(1, 0, 2)
                     .reshape(k, -1))
            else:  # gemm: single-iteration space
                V = st.sram[cfg.xbar_input].reshape(1, -1)
            Y = np.asarray(sim.plane.mxv_batch(descriptor_for(cfg), V))
            if cfg.xbar_bias is not None:
                Y = Y + cfg.xbar_bias
            env[cfg.xbar_node.outputs[0]] = Y.astype(np.float32, copy=False)

        # 2. DPU instruction sequence.  Elementwise ops and max-pooling are
        # batched (float max is exact under reordering); avg-pool/global-avg
        # accumulate float adds, so their segment-reduce path is gated by
        # strict_float_order.
        for n in cfg.dpu_nodes:
            if n.op == "relu":
                env[n.outputs[0]] = np.maximum(pix(n.inputs[0]), 0.0)
            elif n.op == "add":
                env[n.outputs[0]] = pix(n.inputs[0]) + pix(n.inputs[1])
            elif n.op in ("maxpool2d", "avgpool2d") and n.inputs[0] in cfg.lcu:
                # direct mode (split-off pool stage): each iteration gathers
                # its whole window from SRAM.  Same gather layout as the
                # conv window path; the avg fold repeats the fused path's
                # accumulation order per row (row-major over the window,
                # x/(k*k) per add) — bit-identical to the reference's direct
                # pool AND to the unreplicated fused pool.
                out = n.outputs[0]
                kk, s_ = n.attrs["k"], n.attrs["stride"]
                lc = cfg.lcu[n.inputs[0]]
                buf = st.sram[n.inputs[0]]
                ch = buf.shape[0]
                wp = buf.shape[2]
                base = (pts0 * s_ + lc.pad) * wp + pts1 * s_ + lc.pad
                off = (np.arange(kk)[:, None] * wp + np.arange(kk)
                       ).reshape(-1)
                fi = (base[:, None] + off[None, :]).reshape(-1)
                g = buf.reshape(ch, -1)[:, fi]
                W = np.ascontiguousarray(
                    g.reshape(ch, k, kk * kk).transpose(1, 0, 2))
                if n.op == "maxpool2d":
                    y = W.max(axis=2)
                else:
                    xd = W / (kk * kk)
                    y = np.zeros((k, ch), np.float32)
                    for j in range(kk * kk):
                        y += xd[:, :, j]
                env[out] = y.astype(np.float32, copy=False)
            elif n.op in ("maxpool2d", "avgpool2d"):
                out = n.outputs[0]
                kk = n.attrs["k"]
                shp = self.sim._values_for(cfg)[out].shape
                acc = st.pool_acc.get(out)
                if acc is None:
                    init = -np.inf if n.op == "maxpool2d" else 0.0
                    # (PH*PW, C) layout: one row per pool window
                    acc = np.full((shp[1] * shp[2], shp[0]), init, np.float32)
                    st.pool_acc[out] = acc
                    self._mem_events.append(
                        (int(cycles[0]), cid, acc.nbytes, 0))
                e_pix, e_win, row_off, complete = self._pool_table(
                    cid, n, cfg, shp)
                x = pix(n.inputs[0])
                lo, hi = int(row_off[c0]), int(row_off[c0 + k])
                widx = e_win[lo:hi]
                xrows = e_pix[lo:hi] - c0
                if n.op == "maxpool2d":
                    np.maximum.at(acc, widx, x[xrows])
                elif not self.strict_float:
                    np.add.at(acc, widx, x[xrows] / (kk * kk))
                else:
                    xd = x / (kk * kk)       # same value the loop adds
                    for j in range(lo, hi):  # reference accumulation order
                        acc[e_win[j]] += xd[e_pix[j] - c0]
                comp = complete[c0:c0 + k]
                di = np.nonzero(comp >= 0)[0]
                if len(di):
                    pooled_rows[out] = (di, comp[di])
            elif n.op == "global_avgpool":
                out = n.outputs[0]
                src_shape = self.sim._values_for(cfg)[n.inputs[0]].shape
                racc = st.reduce_acc.get(out)
                if racc is None:
                    racc = np.zeros(src_shape[0], np.float32)
                    st.reduce_acc[out] = racc
                x = pix(n.inputs[0])
                if self.strict_float:
                    for i in range(k):
                        racc += x[i]
                else:
                    racc += x.sum(axis=0)
                # (H-1, W-1) is the lex-last point, so it can only be the
                # final row of a batch
                if (pts1 is not None and int(pts0[-1]) == src_shape[1] - 1
                        and int(pts1[-1]) == src_shape[2] - 1):
                    val = racc / (src_shape[1] * src_shape[2])
                    reduce_rows[out] = (k - 1, val)
                    env[out] = val[None]
            elif n.op == "layernorm":
                x = pix(n.inputs[0])
                w = self.sim._weights_for(cfg)
                eps = np.float32(n.attrs["eps"])
                mu = x.mean(axis=1, keepdims=True)
                xc = x - mu
                var = (xc * xc).mean(axis=1, keepdims=True)
                env[n.outputs[0]] = (xc / np.sqrt(var + eps)
                                     * w[n.inputs[1]] + w[n.inputs[2]]
                                     ).astype(np.float32, copy=False)
            elif n.op == "softmax":
                x = pix(n.inputs[0])
                e = np.exp(x - x.max(axis=1, keepdims=True))
                env[n.outputs[0]] = (e / e.sum(axis=1, keepdims=True)
                                     ).astype(np.float32, copy=False)
            elif n.op == "matmul":
                d = dyn_descriptor_for(cfg, n)
                # contiguous copy: einsum is not bit-stable across input
                # strides, and pix() rows are strided by the batch size —
                # which replication changes (the reference path copies too)
                V = np.ascontiguousarray(pix(d.a_value), np.float32)
                bbuf = st.sram[d.b_value]
                dmat = bbuf.reshape(bbuf.shape[0], -1)
                if d.transpose_b:
                    dmat = dmat.T
                dmat = np.ascontiguousarray(dmat, np.float32)
                Y = np.asarray(sim.plane.dyn_mxv_batch(dmat, V))
                if d.scale != 1.0:
                    Y = Y * np.float32(d.scale)
                env[n.outputs[0]] = Y.astype(np.float32, copy=False)
            elif n.op == "transpose":
                buf = st.sram[n.inputs[0]]
                env[n.outputs[0]] = buf[pts0, :, 0]
            else:
                raise NotImplementedError(f"DPU op {n.op}")

        # 3. sends -> batched streams (arrive at cycle + 1, paper §2)
        msgs_it = np.zeros(k, np.int64)
        bytes_it = np.zeros(k, np.int64)

        def open_streams(spec: SendSpec, kind, locs, payload, arrive,
                         iter_idx):
            row_bytes = payload.shape[1] * payload.itemsize
            arrive = np.asarray(arrive)
            # per-row message count: a row dropped by a down link (fault
            # injection) is not sent, so it counts toward nothing — exactly
            # the reference's emit() skip
            row_msgs = np.zeros(len(arrive), np.int64)
            src_part = cfg.partition_idx
            if spec.to_gmem:
                row_msgs += 1
                self._push(int(arrive[0]), _PH_DELIVER, 0, "stream",
                           _Stream(-1, img, spec.value, kind, locs, payload,
                                   arrive, src_part))
            for dst in spec.dst_cores:
                link, key = self.sim._link_for(cid, dst)
                if link is None:             # intra-chip: next-cycle rows
                    row_msgs += 1
                    self._push(int(arrive[0]), _PH_DELIVER, 0, "stream",
                               _Stream(dst, img, spec.value, kind, locs,
                                       payload, arrive, src_part))
                    continue
                # cross-chip: the fault state at each row's SEND cycle
                # governs it; send cycles are non-decreasing and faults only
                # degrade, so rows split into contiguous timeline segments
                send = arrive - 1
                for sl_, down, eff in self._link_segments(key, link, send):
                    if down:
                        continue
                    row_msgs[sl_] += 1
                    arr = arrive[sl_] + eff.transfer_delay(row_bytes)
                    self.log_link.append(
                        (key, send[sl_], row_bytes,
                         Simulator._occupancy(eff, row_bytes)))
                    if self.stalls and eff.transfer_delay(row_bytes) > 0:
                        # same multi-cycle-flight records the reference's
                        # emit() keeps for the link-delay predicate
                        self.delayed[(dst, img, spec.value, src_part)] \
                            .extend(zip(send[sl_].tolist(), arr.tolist()))
                    if self.trace is not None:
                        self.trace.add_link(key, spec.value, img,
                                            send[sl_], arr, row_bytes)
                    self._push(int(arr[0]), _PH_DELIVER, 0, "stream",
                               _Stream(dst, img, spec.value, kind,
                                       locs if locs is None else locs[sl_],
                                       payload[sl_], arr, src_part))
            if iter_idx is None:             # row i belongs to iteration i
                msgs_it[...] += row_msgs
                bytes_it[...] += row_msgs * row_bytes
            else:
                msgs_it[iter_idx] += row_msgs
                bytes_it[iter_idx] += row_msgs * row_bytes

        for spec in cfg.sends:
            if spec.write.kind == "pixel" and spec.value in env:
                payload = np.ascontiguousarray(env[spec.value], np.float32)
                open_streams(spec, "pixel", core.locs[sl], payload,
                             cycles + 1, None)
            elif spec.write.kind == "pool" and spec.value in pooled_rows:
                di, wins = pooled_rows[spec.value]
                acc = st.pool_acc[spec.value]
                pw_b = spec.write.shape[2]
                locs = np.stack([wins // pw_b, wins % pw_b], axis=1)
                open_streams(spec, "pool", locs, acc[wins],
                             cycles[di] + 1, di)
            elif spec.write.kind == "full" and spec.value in env:
                payload = np.array(env[spec.value][-1:], np.float32).reshape(1, -1)
                open_streams(spec, "full", None, payload,
                             cycles[-1:] + 1, np.array([k - 1]))
            elif spec.write.kind == "reduce" and spec.value in reduce_rows:
                i, val = reduce_rows[spec.value]
                payload = np.array(val, np.float32).reshape(1, -1)
                open_streams(spec, "reduce", None, payload,
                             cycles[i:i + 1] + 1, np.array([i]))

        st.counter += k
        self.log_core.append(np.full(k, cid, np.int64))
        self.log_cycle.append(cycles)
        self.log_msgs.append(msgs_it)
        self.log_bytes.append(bytes_it)
        if self.stalls:
            self.stall_batches.append((cid, img, c0, cycles))
        if self.trace is not None:
            self.trace.add_exec(cid, img, cycles)

    # ------------------------------------------------------------ RAW oracle
    def _compile_raw_ops(self, cfg: CoreConfig):
        """Per-core read-set descriptors mirroring Simulator._read_set."""
        ops: Dict[str, list] = {}
        for v, lc in cfg.lcu.items():
            if len(lc.shape) != 3:
                ops[v] = [("all1d",)]
                continue
            lst = []
            if cfg.xbar_node is not None and cfg.xbar_input == v:
                if cfg.xbar_node.op == "conv2d":
                    ca = cfg.conv_attrs
                    lst.append(("window", ca["stride"], ca["pad"],
                                ca["fh"], ca["fw"]))
                else:
                    lst.append(("full",))
            for n in cfg.dpu_nodes:
                if v not in n.inputs:
                    continue
                if n.op in ("relu", "add", "layernorm", "softmax"):
                    lst.append(("point",))
                elif n.op in ("maxpool2d", "avgpool2d"):
                    lst.append(("window", n.attrs["stride"], 0,
                                n.attrs["k"], n.attrs["k"]))
                elif n.op == "global_avgpool":
                    lst.append(("full",))
                elif n.op == "matmul":
                    if v == n.inputs[0]:
                        lst.append(("point",))
                    if v == n.inputs[1]:
                        lst.append(("full",))
                elif n.op == "transpose":
                    lst.append(("full",))
            ops[v] = lst
        return ops

    def _raw_check_batch(self, cid: int, cfg: CoreConfig, st: _EvState,
                         pts0: np.ndarray, pts1, cycles: np.ndarray) -> None:
        raw_ops = self._raw_ops[cid]
        for v, lc in cfg.lcu.items():
            wt = st.wtime[v]
            shp = lc.shape
            for op in raw_ops.get(v, ()):
                if op[0] == "all1d":
                    if int(wt) > cycles[0]:
                        raise RawViolation(
                            f"{cfg.core_id}: read {v} before write")
                    continue
                H, W = shp[1], shp[2]
                for i in range(len(pts0)):
                    cyc = int(cycles[i])
                    if op[0] == "full":
                        need = int(wt.max())
                    elif op[0] == "point":
                        need = int(wt[int(pts0[i]), int(pts1[i])])
                    else:  # window
                        oh, ow = int(pts0[i]), int(pts1[i])
                        _, s_, p_, fh, fw = op
                        r0, r1 = max(0, oh * s_ - p_), min(H, oh * s_ - p_ + fh)
                        c0, c1 = max(0, ow * s_ - p_), min(W, ow * s_ - p_ + fw)
                        if r0 >= r1 or c0 >= c1:
                            continue
                        need = int(wt[r0:r1, c0:c1].max())
                    if need > cyc:
                        raise RawViolation(
                            f"core {cfg.core_id} iter "
                            f"({int(pts0[i])}, {int(pts1[i]) if pts1 is not None else 0})"
                            f": reads {v} at unwritten locations")
