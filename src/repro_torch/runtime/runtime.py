"""Request-level serving runtime over the cycle-accurate CM simulator.

``CmServer`` turns the simulator from a batch-cycle counter into a serving
testbed: requests carry *arrival cycles* (open-loop rate sweeps, closed-loop
think-time populations — see ``runtime.workload``), the GCU admits them
under a policy (FIFO or priority, optionally bounded in-flight), and the
report carries per-request queueing + service latency, p50/p99, and
achieved-vs-offered throughput.  Multi-tenancy: a ``TenantPlacement``
(``core.place_tenants``) co-resides several compiled models on disjoint
core sets of one chip/mesh; the joint simulation shares GCU/DMA and link
contention while per-tenant outputs stay bitwise equal to each tenant
simulated alone (weight-stationary residency: nothing but timing is
shared).

The request type extends :class:`Request`, the ``rid``/``done``
bookkeeping that the reference shares with its LM batcher's request type.

Everything is deterministic: same seed + same config => identical
per-request latencies, across both simulator engines and repeated runs
(``tests/test_runtime.py`` asserts this).

Port of ``repro.runtime.runtime``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal (byte-equal
``ServeReport.to_json()``).  Fault injection and remap recovery
(``CmServer(faults=...)``) wait for the port of ``repro.faults`` and raise
``NotImplementedError``; deadlines and retries without faults work as in
the reference.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence
import numpy as np

from ..core.compiler import TenantPlacement
from ..core.lowering import AcceleratorProgram
from ..core.simulator import LinkStats, SimStats, Simulator
from ..obs import MetricsRegistry

from .workload import rate_sweep


@dataclasses.dataclass
class Request:
    """Identity and completion of one serving request (the ``rid``/``done``
    part of the reference's ``serve.scheduler.Request``, without the LM
    batcher's ``prompt``/``max_new``/``out``)."""

    rid: int
    done: bool = False


@dataclasses.dataclass
class CmRequest(Request):
    """One inference request against the CM pipeline.

    Inherits the identity/bookkeeping fields (``rid``, ``done``)
    and adds the image payload plus cycle-domain timing, filled in by
    ``CmServer``: ``gcu_start`` (streaming began = service start),
    ``completion`` (last output chunk in GMEM), and the derived
    queueing/service/latency splits.
    """

    image: Optional[np.ndarray] = None
    arrival: int = 0
    tenant: int = 0
    priority: int = 0
    deadline: Optional[int] = None   # cycles after arrival; None = server's
    # filled by the server:
    gcu_start: Optional[int] = None
    completion: Optional[int] = None
    output: Optional[Dict[str, np.ndarray]] = None
    # fault handling (filled by the server):
    failed: bool = False             # final verdict after any retries
    fail_cycle: Optional[int] = None   # cycle the last failure was detected
    attempts: int = 0                # retries consumed (0 = first try only)

    @property
    def succeeded(self) -> bool:
        return self.completion is not None and not self.failed

    @property
    def queue_cycles(self) -> int:
        return self.gcu_start - self.arrival

    @property
    def service_cycles(self) -> int:
        return self.completion - self.gcu_start + 1

    @property
    def latency_cycles(self) -> int:
        return self.completion - self.arrival + 1


@dataclasses.dataclass
class ServeReport:
    """Per-request timing + the joint ``SimStats`` of one drained run.

    Under fault injection latency statistics (``latencies`` /
    ``percentile`` / ``p50`` / ``p99`` / ``achieved_rate``) cover
    *successful* requests only — a failed request has no completion, and
    mixing sentinel values into percentiles would corrupt the curve.
    Failures are reported separately (``failures``, ``goodput``,
    ``n_retries``, ``remap_events``).
    """

    requests: List[CmRequest]
    stats: SimStats
    n_tenants: int = 1
    n_retries: int = 0               # retry attempts re-admitted, all epochs
    remap_events: List[Dict] = dataclasses.field(default_factory=list)
    reprogram_cycles: int = 0        # total crossbar-reprogram penalty paid
    metrics: Optional[MetricsRegistry] = None   # populated by CmServer.serve

    def by_rid(self) -> Dict[int, CmRequest]:
        """Requests keyed by rid (``requests`` itself is in arrival order)."""
        return {r.rid: r for r in self.requests}

    def _sel(self, tenant: Optional[int]) -> List[CmRequest]:
        if tenant is None:
            return self.requests
        return [r for r in self.requests if r.tenant == tenant]

    def successes(self, tenant: Optional[int] = None) -> List[CmRequest]:
        return [r for r in self._sel(tenant) if r.succeeded]

    def failures(self, tenant: Optional[int] = None) -> List[CmRequest]:
        return [r for r in self._sel(tenant) if not r.succeeded]

    def latencies(self, tenant: Optional[int] = None) -> np.ndarray:
        return np.array([r.latency_cycles for r in self.successes(tenant)],
                        np.int64)

    def queue_delays(self, tenant: Optional[int] = None) -> np.ndarray:
        return np.array([r.queue_cycles for r in self.successes(tenant)],
                        np.int64)

    def percentile(self, p: float, tenant: Optional[int] = None) -> float:
        lat = self.latencies(tenant)
        if not len(lat):        # tenant saw no (successful) traffic
            return float("nan")
        return float(np.percentile(lat, p))

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    @property
    def makespan(self) -> int:
        return self.stats.cycles

    @property
    def achieved_rate(self) -> float:
        """Completed images per cycle over the whole run."""
        return len(self.successes()) / max(1, self.stats.cycles)

    @property
    def goodput(self) -> float:
        """Fraction of requests that ultimately completed (post-retry)."""
        return len(self.successes()) / max(1, len(self.requests))

    def table(self) -> str:
        """Human-readable per-request latency table."""
        lines = [f"{'rid':>4} {'ten':>3} {'pri':>3} {'arrive':>7} "
                 f"{'start':>7} {'done':>7} {'queue':>6} {'svc':>6} "
                 f"{'latency':>7} {'try':>3}"]
        for r in self.requests:
            if r.succeeded:
                lines.append(
                    f"{r.rid:>4} {r.tenant:>3} {r.priority:>3} "
                    f"{r.arrival:>7} {r.gcu_start:>7} {r.completion:>7} "
                    f"{r.queue_cycles:>6} {r.service_cycles:>6} "
                    f"{r.latency_cycles:>7} {r.attempts:>3}")
            else:
                lines.append(
                    f"{r.rid:>4} {r.tenant:>3} {r.priority:>3} "
                    f"{r.arrival:>7} {'-':>7} {'-':>7} {'-':>6} {'-':>6} "
                    f"FAILED@{r.fail_cycle} {r.attempts:>3}")
        lines.append(
            f"p50={self.p50:.0f}  p99={self.p99:.0f}  "
            f"makespan={self.makespan}  "
            f"achieved={self.achieved_rate:.5f} img/cycle  "
            f"goodput={self.goodput:.2f}  retries={self.n_retries}  "
            f"remaps={len(self.remap_events)}")
        return "\n".join(lines)

    def to_row(self) -> Dict[str, float]:
        """The canonical serving-curve row — the single definition
        ``load_sweep`` and the serve benchmark consume (the row keys are
        perf-baseline identity and must not drift)."""
        return {
            "achieved_rate": self.achieved_rate,
            "p50_latency": self.p50,
            "p99_latency": self.p99,
            "mean_queue": float(self.queue_delays().mean()),
            "makespan": self.makespan,
        }

    def summary(self) -> Dict:
        """Plain-dict run summary (JSON-safe scalars only)."""
        out = {
            "requests": len(self.requests),
            "succeeded": len(self.successes()),
            "failed": len(self.failures()),
            "p50_latency": self.p50,
            "p99_latency": self.p99,
            "makespan": self.makespan,
            "achieved_rate": self.achieved_rate,
            "goodput": self.goodput,
            "n_tenants": self.n_tenants,
            "n_retries": self.n_retries,
            "n_remaps": len(self.remap_events),
            "reprogram_cycles": self.reprogram_cycles,
        }
        # NaN (no successful traffic) is not valid JSON — null it out
        for k in ("p50_latency", "p99_latency"):
            if out[k] != out[k]:
                out[k] = None
        return out

    def to_json(self) -> str:
        """Machine-readable report: summary + per-request rows + the
        metrics snapshot (when the server attached one)."""
        reqs = [{
            "rid": r.rid, "tenant": r.tenant, "priority": r.priority,
            "arrival": r.arrival, "attempts": r.attempts,
            "succeeded": r.succeeded,
            "gcu_start": r.gcu_start, "completion": r.completion,
            "fail_cycle": r.fail_cycle,
            "latency_cycles": r.latency_cycles if r.succeeded else None,
        } for r in self.requests]
        obj = {"summary": self.summary(), "requests": reqs,
               "remap_events": self.remap_events,
               "metrics": self.metrics.snapshot() if self.metrics else None}
        return json.dumps(obj, sort_keys=True, indent=2)

    def to_table(self) -> str:
        """``table()`` plus a metrics footer (histogram percentiles pulled
        from the registry when present)."""
        lines = [self.table()]
        if self.metrics is not None:
            snap = self.metrics.snapshot()
            cnt = "  ".join(f"{k}={v}"
                            for k, v in snap["counters"].items())
            if cnt:
                lines.append(f"counters: {cnt}")
            for name, h in snap["histograms"].items():
                lines.append(
                    f"{name}: n={h['count']} p50={h['p50']} "
                    f"p99={h['p99']} max={h['max']}")
        return "\n".join(lines)


class _RidTrace:
    """Per-epoch trace adapter: the simulator labels work by *epoch-local
    image index*, which collides across retry epochs; this relabels every
    image to its request id so one recorder accumulates a coherent
    whole-serve timeline."""

    def __init__(self, inner, rids: List[int]) -> None:
        self._inner = inner
        self._rids = rids

    def add_exec(self, core_id, image, cycles):
        self._inner.add_exec(core_id, self._rids[image], cycles)

    def add_gcu(self, image, tenant, start, end):
        self._inner.add_gcu(self._rids[image], tenant, start, end)

    def add_link(self, link_key, value, image, sends, arrives, nbytes):
        self._inner.add_link(link_key, value, self._rids[image],
                             sends, arrives, nbytes)

    def add_instant(self, name, ts, **args):
        if "image" in args:
            args["image"] = self._rids[args["image"]]
        self._inner.add_instant(name, ts, **args)

    def add_span(self, name, tid, start, end, **args):
        self._inner.add_span(name, tid, start, end, **args)


class CmServer:
    """Arrival-driven, admission-controlled serving over the CM simulator.

    ``placement`` is a :class:`TenantPlacement`, a single
    ``AcceleratorProgram``, or a list of core-disjoint programs.  ``chip``
    is required only when no mesh is compiled into the program(s).

    Admission contract: the GCU (one shared host DMA across tenants)
    streams one image at a time; at each decision point it picks among the
    *arrived*, not-yet-started requests — FIFO (``policy="fifo"``: earliest
    arrival, ties by rid) or ``policy="priority"`` (highest priority, then
    earliest arrival, then rid) — and only while fewer than
    ``max_inflight`` started requests are incomplete.  Downstream, each
    core processes its tenant's requests in GCU start order, so priority
    reorders the whole pipeline, not just injection.

    ``compute_plane="auto"`` is :class:`~repro_torch.core.TorchPlane` on the
    CUDA card; ``faults=`` raises ``NotImplementedError`` until the fault
    layer is ported.
    """

    def __init__(self, placement, chip=None, *,
                 engine: str = "event", compute_plane="auto",
                 schedule: str = "pipelined",
                 max_inflight: Optional[int] = None,
                 policy: str = "fifo",
                 check_raw: bool = False,
                 strict_float_order: bool = True,
                 max_cycles: int = 5_000_000,
                 faults=None,
                 deadline: Optional[int] = None,
                 retry=None):
        if faults is not None:
            raise NotImplementedError(
                "CmServer(faults=...): fault injection and remap recovery "
                "(repro.faults) are not ported yet; see ROADMAP.md, Queue 1, "
                "'faults/'")
        if policy not in ("fifo", "priority"):
            raise ValueError(f"unknown admission policy {policy!r}")
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be > 0 cycles, got {deadline}")
        if isinstance(placement, TenantPlacement):
            self.placement: Optional[TenantPlacement] = placement
            programs: List[AcceleratorProgram] = placement.programs
            if chip is None:
                chip = placement.mesh if placement.mesh is not None \
                    else placement.chip
        else:
            self.placement = None
            programs = list(placement) \
                if isinstance(placement, (list, tuple)) else [placement]
            if chip is None:
                meshes = [p.mesh for p in programs if p.mesh is not None]
                if not meshes:
                    raise ValueError("chip= required when no mesh is "
                                     "compiled into the program(s)")
                chip = meshes[0]
        self.programs = list(programs)
        self.policy = policy
        self.max_inflight = max_inflight
        self.schedule = schedule
        self.max_cycles = max_cycles
        self.deadline = deadline
        self.retry = retry
        self.chip = chip
        self._engine = engine
        self._compute_plane = compute_plane
        self._check_raw = check_raw
        self._strict_float_order = strict_float_order
        self.sim = self._build_sim()
        self.pending: List[CmRequest] = []
        self._next_rid = 0
        self.metrics = MetricsRegistry()   # replaced per serve (pull-style)

    def _build_sim(self) -> Simulator:
        """Build the joint simulator from the tenant programs."""
        progs = self.programs
        return Simulator(progs if len(progs) > 1 else progs[0],
                         self.chip, engine=self._engine,
                         compute_plane=self._compute_plane,
                         check_raw=self._check_raw,
                         strict_float_order=self._strict_float_order)

    @property
    def n_tenants(self) -> int:
        return len(self.programs)

    # ------------------------------------------------------------ submission
    def submit(self, req: CmRequest) -> CmRequest:
        if req.image is None:
            raise ValueError(f"request {req.rid} has no image payload")
        if not 0 <= req.tenant < self.n_tenants:
            raise ValueError(f"request {req.rid}: tenant {req.tenant} "
                             f"outside [0, {self.n_tenants})")
        if any(r.rid == req.rid for r in self.pending):
            raise ValueError(f"duplicate rid {req.rid} in pending queue")
        self._next_rid = max(self._next_rid, req.rid + 1)
        self.pending.append(req)
        return req

    def submit_image(self, image: np.ndarray, arrival: int = 0,
                     tenant: int = 0, priority: int = 0) -> CmRequest:
        req = CmRequest(rid=self._next_rid, image=image, arrival=int(arrival),
                        tenant=int(tenant), priority=int(priority))
        self._next_rid += 1
        return self.submit(req)

    # --------------------------------------------------------------- serving
    def drain(self, *, stalls: bool = False, trace=None) -> ServeReport:
        """Simulate all pending requests to completion and clear the queue."""
        reqs, self.pending = self.pending, []
        return self.serve(reqs, stalls=stalls, trace=trace)

    def serve(self, requests: Sequence[CmRequest], *,
              stalls: bool = False, trace=None) -> ServeReport:
        """Cycle-accurate serving of ``requests`` (re-runnable; the server
        holds no cross-run simulator state).

        Without deadlines this is one joint simulator run.  With deadlines
        it becomes an epoch loop: requests still incomplete at their
        deadline are *failed at that cycle* (the detection point), and
        failed requests are re-admitted under the ``RetryPolicy`` backoff
        (``retry.max_retries``, ``retry.backoff(attempt)``) on the same
        absolute cycle timeline, from the cycle after detection.  Each retry
        epoch simulates only the retried requests — already-completed
        requests keep their timings from the epoch that completed them.
        (The reference also remaps around dead cores here; that waits for
        the fault layer.)

        Observability (both default-off and zero-cost when off):
        ``stalls=True`` threads stall attribution through the simulator;
        the ``StallBreakdown`` survives on ``report.stats`` for
        single-epoch runs (retry epochs re-run the clock, so per-epoch
        breakdowns do not merge).  ``trace=TraceRecorder()`` records the
        whole serve — core/GCU/link activity labelled by *request id*
        (coherent across retry epochs) and request lifecycle spans
        (``queued`` / ``service`` / ``retry-wait``).  Every serve also
        attaches a fresh
        :class:`~repro_torch.obs.MetricsRegistry` to ``report.metrics``.
        """
        if not requests:
            raise ValueError("no requests to serve")
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("duplicate rids in request batch")
        # image-index order = FIFO base order (arrival, then rid): the
        # engines' own selection loop handles any dynamic reordering
        ordered = sorted(requests, key=lambda r: (r.arrival, r.rid))
        for r in ordered:                 # re-runnable: reset verdicts
            r.failed, r.fail_cycle, r.attempts = False, None, 0
            r.gcu_start = r.completion = r.output = None
            r.done = False
        # effective arrival of the *current attempt* (retries re-admit
        # later); r.arrival stays the original submission cycle so latency
        # percentiles include queueing + backoff end to end
        eff = {r.rid: int(r.arrival) for r in ordered}
        active = ordered
        merged: Optional[SimStats] = None
        n_retries = 0
        while True:
            batch = sorted(active, key=lambda r: (eff[r.rid], r.rid))
            images = [r.image for r in batch]
            arrivals = [eff[r.rid] for r in batch]
            tenants = [r.tenant for r in batch]
            priorities = [r.priority for r in batch] \
                if self.policy == "priority" else None
            deadlines = None
            if self.deadline is not None \
                    or any(r.deadline is not None for r in batch):
                deadlines = [
                    None if (rel := (r.deadline if r.deadline is not None
                                     else self.deadline)) is None
                    else eff[r.rid] + rel
                    for r in batch]
            epoch_trace = None if trace is None \
                else _RidTrace(trace, [r.rid for r in batch])
            outputs, stats = self.sim.run(
                images, schedule=self.schedule, max_cycles=self.max_cycles,
                arrivals=arrivals, tenants=tenants,
                max_inflight=self.max_inflight, priorities=priorities,
                deadlines=deadlines, stalls=stalls, trace=epoch_trace)
            merged = stats if merged is None else _merge_stats(merged, stats)
            failed_now = []
            for i, r in enumerate(batch):
                if i in stats.failed_cycle:
                    r.failed = True
                    r.fail_cycle = stats.failed_cycle[i]
                    r.gcu_start = stats.gcu_start_cycle.get(i)
                    r.completion = None
                    r.output = None
                    failed_now.append(r)
                else:
                    r.failed = False
                    r.gcu_start = stats.gcu_start_cycle[i]
                    r.completion = stats.completion_cycle[i]
                    r.output = outputs[i]
                    r.done = True
            if not failed_now:
                break
            # failure detection: the deadline cycle is when the server can
            # *know*; with nothing to remap, retries may start right after
            ready = max(r.fail_cycle for r in failed_now) + 1
            retry_batch = []
            if self.retry is not None:
                for r in failed_now:
                    if r.attempts >= self.retry.max_retries:
                        continue
                    r.attempts += 1
                    eff[r.rid] = max(
                        r.fail_cycle + self.retry.backoff(r.attempts), ready)
                    if trace is not None:
                        trace.add_span("retry-wait", r.rid, r.fail_cycle,
                                       eff[r.rid] - 1, attempt=r.attempts)
                    retry_batch.append(r)
                n_retries += len(retry_batch)
            if not retry_batch:
                break
            active = retry_batch
        if trace is not None:
            for r in ordered:
                if r.gcu_start is not None and r.gcu_start > r.arrival:
                    trace.add_span("queued", r.rid, r.arrival,
                                   r.gcu_start - 1, rid=r.rid)
                if r.succeeded:
                    trace.add_span("service", r.rid, r.gcu_start,
                                   r.completion, rid=r.rid, tenant=r.tenant)
                else:
                    trace.add_instant("request-failed",
                                      r.fail_cycle if r.fail_cycle is not None
                                      else r.arrival, rid=r.rid)
        report = ServeReport(requests=list(ordered), stats=merged,
                             n_tenants=self.n_tenants,
                             n_retries=n_retries)
        report.metrics = self._collect_metrics(report)
        self.metrics = report.metrics      # last-serve registry, pull-style
        return report

    def _collect_metrics(self, report: ServeReport) -> MetricsRegistry:
        """Fold one serve's outcome into a fresh registry (cycle units)."""
        m = MetricsRegistry()
        m.counter("requests_total").inc(len(report.requests))
        m.counter("requests_succeeded").inc(len(report.successes()))
        m.counter("requests_failed").inc(len(report.failures()))
        m.counter("retries_total").inc(report.n_retries)
        m.counter("remaps_ok_total").inc(
            sum(1 for e in report.remap_events if e.get("ok")))
        m.counter("remaps_failed_total").inc(
            sum(1 for e in report.remap_events if not e.get("ok")))
        m.counter("reprogram_cycles_total").inc(report.reprogram_cycles)
        m.gauge("makespan_cycles").set(report.stats.cycles)
        m.gauge("tenants").set(report.n_tenants)
        for r in report.successes():
            m.histogram("queue_cycles").observe(r.queue_cycles)
            m.histogram("service_cycles").observe(r.service_cycles)
            m.histogram("latency_cycles").observe(r.latency_cycles)
        return m

    def serve_images(self, images: Sequence[np.ndarray], arrivals,
                     tenants=None, priorities=None) -> ServeReport:
        """Convenience: wrap raw arrays into requests and serve them."""
        n = len(images)
        tenants = [0] * n if tenants is None else list(tenants)
        priorities = [0] * n if priorities is None else list(priorities)
        reqs = [CmRequest(rid=i, image=images[i], arrival=int(arrivals[i]),
                          tenant=tenants[i], priority=priorities[i])
                for i in range(n)]
        return self.serve(reqs)


def _merge_stats(a: SimStats, b: SimStats) -> SimStats:
    """Fold a retry epoch's stats into the run total.

    Epochs share one absolute cycle timeline, so ``cycles`` is the max
    (the later epoch's makespan), traffic/busy counters add, and busy
    spans / SRAM high-water combine min/max.  The per-image timing dicts
    are *dropped*: image indices are epoch-local (they would collide), and
    the ``CmRequest`` objects carry the authoritative per-request timing.
    """
    out = SimStats(cycles=max(a.cycles, b.cycles))
    out.messages = a.messages + b.messages
    out.bytes_sent = a.bytes_sent + b.bytes_sent
    for src in (a, b):
        for c, v in src.busy.items():
            out.busy[c] += v
        for c, v in src.sram_high_water.items():
            out.sram_high_water[c] = max(out.sram_high_water[c], v)
        for c, v in src.first_busy.items():
            out.first_busy[c] = min(out.first_busy.get(c, v), v)
        for c, v in src.last_busy.items():
            out.last_busy[c] = max(out.last_busy.get(c, v), v)
        for k, ls in src.links.items():
            cur = out.links.setdefault(k, LinkStats())
            cur.messages += ls.messages
            cur.bytes += ls.bytes
            cur.busy += ls.busy
    return out


# ------------------------------------------------------------- measurements
def load_sweep(server: CmServer, images: Sequence[np.ndarray],
               rates: Sequence[float], kind: str = "poisson",
               seed: int = 0, tenants=None) -> List[Dict[str, float]]:
    """Serve the same image set at each offered rate; one row per rate.

    The canonical serving curve: offered load (images/cycle) vs achieved
    throughput and p50/p99 latency — p99 must rise with offered load as
    queueing at the GCU admission point builds up.
    """
    rows = []
    for rate, arr in rate_sweep(rates, len(images), kind=kind, seed=seed):
        rep = server.serve_images(images, arrivals=arr, tenants=tenants)
        rows.append({"offered_rate": float(rate), **rep.to_row()})
    return rows


def split_stats(stats: SimStats, placement: TenantPlacement,
                tenants_of_images: Sequence[int]) -> List[SimStats]:
    """Per-tenant views of a joint run's ``SimStats``.

    Separable fields — per-core busy/utilization spans, SRAM high water,
    per-request GCU start/completion — are filtered by the tenant's core
    range (and image set).  ``cycles`` is the joint makespan.  Messages and
    bytes are *shared-fabric* totals and deliberately not split; mesh link
    records are attributed to a tenant only when both endpoint chips lie in
    its chip range (always true under chip-granular placement).
    """
    out = []
    cpc = placement.chip.n_cores
    for tk, (lo, hi) in enumerate(placement.core_ranges):
        s = SimStats(cycles=stats.cycles)
        s.busy.update({c: b for c, b in stats.busy.items() if lo <= c < hi})
        s.first_busy = {c: v for c, v in stats.first_busy.items()
                        if lo <= c < hi}
        s.last_busy = {c: v for c, v in stats.last_busy.items()
                       if lo <= c < hi}
        s.sram_high_water.update({c: v for c, v in
                                  stats.sram_high_water.items()
                                  if lo <= c < hi})
        s.gcu_start_cycle = {i: v for i, v in stats.gcu_start_cycle.items()
                             if tenants_of_images[i] == tk}
        s.completion_cycle = {i: v for i, v in stats.completion_cycle.items()
                              if tenants_of_images[i] == tk}
        if placement.mesh is not None:
            clo, chi = lo // cpc, -(-hi // cpc)
            s.links = {k: v for k, v in stats.links.items()
                       if clo <= k[0] < chi and clo <= k[1] < chi}
        out.append(s)
    return out
