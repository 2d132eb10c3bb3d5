"""Deterministic Chrome-trace/Perfetto recording for simulator runs.

``TraceRecorder`` collects raw events during a run — per-core execution
cycles, GCU stream windows, link message chunks, fault/remap instants and
runtime request spans — and ``finalize()`` turns them into a canonical
Chrome Trace Event Format object (``{"traceEvents": [...]}``) with
*simulated cycles* as microsecond timestamps.  Nothing here reads a wall
clock (enforced by ``tools/lint_contiguity.py``); same-seed runs therefore
serialize to byte-identical files.

Process/thread layout in the viewer:

* pid ``PID_CORES``: one tid per core, named ``core<id> [<stage>]``;
  "X" spans are contiguous execution runs of one image (coalesced).
* pid ``PID_GCU``: tid 0, one span per streamed input image.
* pid ``PID_LINKS``: one tid per physical link, one span per (value,
  image) message burst giving first-send -> last-arrive plus byte count.
* pid ``PID_REQUESTS``: one tid per request id; lifecycle spans emitted by
  the serving runtime (queued / streaming / resident / retry-wait) plus
  instant fault/remap markers.

Events are sorted by ``(ts, pid, tid, ph, name)`` and serialized with
sorted keys, so the byte stream is a pure function of the simulated run.

Port copy of ``repro.obs.trace``: the same code, with every import inside
``repro_torch``; ``tests/test_torch_*.py`` hold the two equal.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

PID_CORES = 1
PID_GCU = 2
PID_LINKS = 3
PID_REQUESTS = 4

_PID_NAMES = {PID_CORES: "cores", PID_GCU: "gcu",
              PID_LINKS: "links", PID_REQUESTS: "requests"}


class TraceRecorder:
    """Accumulates raw run events; ``finalize`` builds the trace object.

    Hooks are cheap appends of raw data (no formatting during the run);
    every hook site in the simulator is guarded by ``if trace is not
    None`` so the ``trace=None`` path executes no added work."""

    def __init__(self) -> None:
        # (core_id, image, ndarray-or-int exec cycles)
        self._exec: List[Tuple[int, int, Any]] = []
        # image -> (tenant, start_cycle, last_send_cycle)
        self._gcu: Dict[int, Tuple[int, int, int]] = {}
        # (link_key, value, image) -> [first_send, last_arrive, bytes, rows]
        self._link: Dict[Tuple[Tuple[int, int], str, int], List[int]] = {}
        self._instants: List[Tuple[str, int, Dict[str, Any]]] = []
        self._spans: List[Tuple[str, int, int, int, Dict[str, Any]]] = []

    # ---- recording hooks -------------------------------------------------
    def add_exec(self, core_id: int, image: int, cycles: Any) -> None:
        """Record executed cycle(s) of ``core_id`` on ``image``.

        ``cycles`` is a scalar (reference engine, one per call) or an
        ndarray batch (event engine)."""
        self._exec.append((core_id, image,
                           np.atleast_1d(np.asarray(cycles, dtype=np.int64))))

    def add_gcu(self, image: int, tenant: int, start: int, end: int) -> None:
        """Record the GCU streaming window [start, end] of one image."""
        self._gcu[image] = (tenant, int(start), int(end))

    def add_link(self, link_key: Tuple[int, int], value: str, image: int,
                 sends: Any, arrives: Any, nbytes: int) -> None:
        """Fold one message chunk into the (link, value, image) burst."""
        s = int(np.min(sends))
        a = int(np.max(arrives))
        n = int(np.asarray(sends).size)
        rec = self._link.get((link_key, value, image))
        if rec is None:
            self._link[(link_key, value, image)] = [s, a, nbytes * n, n]
        else:
            rec[0] = min(rec[0], s)
            rec[1] = max(rec[1], a)
            rec[2] += nbytes * n
            rec[3] += n

    def add_instant(self, name: str, ts: int, **args: Any) -> None:
        """Record a point event (fault, remap, admission, deadline)."""
        self._instants.append((name, int(ts), args))

    def add_span(self, name: str, tid: int, start: int, end: int,
                 **args: Any) -> None:
        """Record a runtime-level span (request lifecycle phase)."""
        self._spans.append((name, int(tid), int(start), int(end), args))

    # ---- finalize --------------------------------------------------------
    @staticmethod
    def _runs(cycles: np.ndarray) -> List[Tuple[int, int]]:
        """Coalesce sorted cycle numbers into contiguous [start, end] runs."""
        if cycles.size == 0:
            return []
        cuts = np.nonzero(np.diff(cycles) > 1)[0]
        starts = np.concatenate(([0], cuts + 1))
        ends = np.concatenate((cuts, [cycles.size - 1]))
        return [(int(cycles[s]), int(cycles[e]))
                for s, e in zip(starts, ends)]

    def finalize(self, t_end: int,
                 stage_of_core: Optional[Dict[int, str]] = None
                 ) -> Dict[str, Any]:
        """Build the Chrome-trace object; cycles past ``t_end`` are clipped
        (the event engine may have scheduled work past the completion
        cycle that never architecturally executed)."""
        stage_of_core = stage_of_core or {}
        ev: List[Dict[str, Any]] = []

        def meta(pid: int, tid: int, name: str) -> None:
            ev.append({"ph": "M", "pid": pid, "tid": tid, "ts": 0,
                       "name": "thread_name", "args": {"name": name}})

        for pid, name in _PID_NAMES.items():
            ev.append({"ph": "M", "pid": pid, "tid": 0, "ts": 0,
                       "name": "process_name", "args": {"name": name}})

        per_core: Dict[Tuple[int, int], List[np.ndarray]] = {}
        for cid, img, cyc in self._exec:
            per_core.setdefault((cid, img), []).append(cyc)
        seen_cores = set()
        for (cid, img), chunks in sorted(per_core.items()):
            if cid not in seen_cores:
                seen_cores.add(cid)
                stage = stage_of_core.get(cid)
                meta(PID_CORES, cid,
                     f"core{cid} [{stage}]" if stage else f"core{cid}")
            cyc = np.unique(np.concatenate(chunks))
            cyc = cyc[cyc <= t_end]
            for s, e in self._runs(cyc):
                ev.append({"ph": "X", "pid": PID_CORES, "tid": cid,
                           "ts": s, "dur": e - s + 1, "name": f"img{img}",
                           "args": {"image": img}})

        meta(PID_GCU, 0, "gcu-stream")
        for img, (tk, s, e) in sorted(self._gcu.items()):
            if s > t_end:
                continue
            ev.append({"ph": "X", "pid": PID_GCU, "tid": 0, "ts": s,
                       "dur": min(e, t_end) - s + 1, "name": f"img{img}",
                       "args": {"image": img, "tenant": tk}})

        link_tids: Dict[Tuple[int, int], int] = {}
        for (lk, value, img), (s, a, nb, rows) in sorted(self._link.items()):
            if s > t_end:
                continue
            tid = link_tids.get(lk)
            if tid is None:
                tid = len(link_tids)
                link_tids[lk] = tid
                meta(PID_LINKS, tid, f"link {lk[0]}->{lk[1]}")
            ev.append({"ph": "X", "pid": PID_LINKS, "tid": tid, "ts": s,
                       "dur": min(a, t_end) - s + 1,
                       "name": f"{value}/img{img}",
                       "args": {"bytes": nb, "rows": rows,
                                "link": f"{lk[0]}->{lk[1]}"}})

        for name, ts, args in self._instants:
            ev.append({"ph": "i", "pid": PID_REQUESTS, "tid": 0, "s": "g",
                       "ts": min(ts, t_end), "name": name,
                       "args": dict(sorted(args.items()))})
        for name, tid, s, e, args in self._spans:
            ev.append({"ph": "X", "pid": PID_REQUESTS, "tid": tid,
                       "ts": s, "dur": max(e, s) - s + 1, "name": name,
                       "args": dict(sorted(args.items()))})

        ev.sort(key=lambda d: (d["ts"], d["pid"], d["tid"],
                               d["ph"], d["name"], d.get("dur", 0)))
        return {"displayTimeUnit": "ms",
                "metadata": {"clock": "simulated-cycles", "t_end": t_end},
                "traceEvents": ev}

    def write(self, path: str, t_end: int,
              stage_of_core: Optional[Dict[int, str]] = None) -> None:
        """Serialize canonically (sorted keys, no whitespace) to ``path``."""
        obj = self.finalize(t_end, stage_of_core)
        with open(path, "w") as fh:
            json.dump(obj, fh, sort_keys=True, separators=(",", ":"))
            fh.write("\n")
