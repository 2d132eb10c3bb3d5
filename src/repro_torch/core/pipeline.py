"""Polyhedral pipeline schedules from the paper's frontier automata.

The paper compiles, per cross-core array, a state machine from the relation
``S : O -> J`` that advances a consumer's iteration frontier as producer
writes land (§3.3/Appendix A).  Evaluated at compile time, the same
automata give a static pipeline schedule:

  1. each pipeline stage (a group of NN layers) is a "core"; the streamed
     activation between stages is the shared array O, indexed by item
     (microbatch or sequence-chunk);
  2. per edge we build ISL write/read relations for the edge kind —
     ``pointwise`` (chunk t feeds chunk t: causal-attention/Mamba/MLP
     stages), ``causal`` (consumer chunk t reads producer chunks <= t), or
     ``full`` (bidirectional encoder: consumer needs *all* producer chunks);
  3. Appendix-A ``S`` gives each edge's frontier automaton; a longest-path
     sweep over the automata yields each (stage, item) earliest start tick —
     for pointwise edges this recovers the classic 1-deep pipeline skew, for
     ``full`` edges it degenerates to layer-at-a-time, exactly as the
     formalism predicts;
  4. the schedule executes across the ranks of a ``"stage"`` process group
     (:func:`pipeline_apply`), one stage a rank, each holding only its own
     stage's parameters; at each tick a rank reads ``schedule.table[sid,
     tick]``, computes its item (stage 0 reads ``xs[item]``, the others the
     activation that arrived) and the activation hops to ``sid + 1`` by
     ``dist.batch_isend_irecv`` (``distributed.comm.hop``).

Port of ``repro.core.pipeline``: the schedule half is the same code over the
port's ``poly``/``fisl``, with every import inside ``repro_torch``;
``tests/test_torch_pipeline.py`` holds the two equal.  The execution half
differs from the reference's ``shard_map`` body where that body is wasteful
or wrong:

- an idle tick computes nothing (the reference computes and discards);
- the ring's wrap, last stage back to 0, is dropped;
- the last stage collects the outputs and broadcasts them to every rank
  (the reference's ``psum`` adds the zeros of the other stages: the same
  result);
- each stage carries one activation, as the reference does, so the
  schedule must start every item on a stage exactly one tick after the
  stage before it (``start[s, t] == start[s - 1, t] + 1``).  The reference
  assumes this without checking and returns a wrong answer for ``full``
  edges; :func:`pipeline_apply` raises ``ValueError`` for such a schedule.

:func:`sequential_apply` runs every item through every stage in a plain
loop, with the same arithmetic per item, so on one device type the
pipeline's result equals it bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from . import poly
from .poly import isl  # islpy when installed, the finite fisl backend otherwise

EDGE_KINDS = ("pointwise", "causal", "full")


# ------------------------------------------------------------- ISL relations
def edge_relations(kind: str, n_items: int) -> Tuple[isl.Map, isl.Map]:
    """(W1 producer-write, R2 consumer-read) over item index t."""
    if kind == "pointwise":
        r2 = isl.Map(f"{{ RD[t] -> A[i] : i = t and 0 <= t < {n_items} }}")
    elif kind == "causal":
        r2 = isl.Map(f"{{ RD[t] -> A[i] : 0 <= i <= t and t < {n_items} "
                     f"and 0 <= t }}")
    elif kind == "full":
        r2 = isl.Map(f"{{ RD[t] -> A[i] : 0 <= i < {n_items} and "
                     f"0 <= t < {n_items} }}")
    else:
        raise ValueError(kind)
    w1 = isl.Map(f"{{ WR[t] -> A[i] : i = t and 0 <= t < {n_items} }}")
    return w1, r2


def edge_frontier(kind: str, n_items: int) -> poly.Frontier:
    w1, r2 = edge_relations(kind, n_items)
    dep = poly.compute_dep_info(w1, r2)
    return poly.Frontier(dep)


# ------------------------------------------------------------------ schedule
@dataclasses.dataclass
class Schedule:
    """start[s, t] = tick at which stage s runs item t; table[s, tick] = item
    index (or -1 idle).  n_ticks = makespan."""

    start: np.ndarray
    table: np.ndarray
    n_ticks: int

    def utilization(self) -> float:
        return float((self.table >= 0).sum()) / self.table.size


def derive_schedule(edge_kinds: Sequence[str], n_items: int) -> Schedule:
    """Earliest-start schedule from *compiled frontier tables* (vectorized).

    Same Appendix-A ``S`` automata as :func:`derive_schedule_automata`, but
    precompiled with ``poly.compile_frontier_table`` (the event-engine LCU):
    the running lexmax over producer-write ranks becomes a prefix max, the
    first producer item unlocking each consumer item is one ``searchsorted``
    against that non-decreasing limit ramp, and the one-item-per-tick busy
    chain ``start(t) = max(ready(t), start(t-1) + 1)`` is the same prefix-max
    recurrence the simulator uses for §2 cycle pacing.
    """
    n_stages = len(edge_kinds) + 1
    start = np.full((n_stages, n_items), -1, np.int64)
    start[0] = np.arange(n_items)                       # stage 0 streams in
    rel = np.arange(n_items)

    for s in range(1, n_stages):
        w1, r2 = edge_relations(edge_kinds[s - 1], n_items)
        dep = poly.compute_dep_info(w1, r2)
        table = poly.compile_frontier_table(dep, (n_items,), (n_items,))
        prev = start[s - 1]
        if table.never_constrains:
            # no RAW dependency: every item is ready once polled (the
            # automaton is first polled after producer item 0 lands)
            ready = np.full(n_items, prev[0] + 1, np.int64)
        else:
            # limit after producer item t lands: the same saturating ramp the
            # event engine's runtime LCU folds streams with
            _, limits = poly.frontier_limit_ramp(
                table.rank, table.d_lexmin_rank, table.d_lexmax_rank)
            first = np.searchsorted(limits, rel, side="left")
            assert (first < n_items).all(), "frontier never unlocked an item"
            # write lands one tick after the producer ran (paper §2)
            ready = prev[first] + 1
        start[s] = rel + np.maximum.accumulate(ready - rel)

    n_ticks = int(start.max()) + 1
    table = np.full((n_stages, n_ticks), -1, np.int64)
    for s in range(n_stages):
        table[s, start[s]] = np.arange(n_items)
    return Schedule(start=start, table=table, n_ticks=n_ticks)


def derive_schedule_automata(edge_kinds: Sequence[str],
                             n_items: int) -> Schedule:
    """Earliest-start schedule by *running the generated LCU automata*.

    Stage 0 has no input edge; stage s>0 consumes stage s-1's output array
    through an automaton compiled from the Appendix-A S relation.  We sweep
    items in execution order, feeding each produced item to the consumer's
    frontier and asking it (via the generated code) when the consumer may
    run — the compile-time evaluation of the paper's runtime state machine.
    Kept as the second oracle for the vectorized :func:`derive_schedule`.
    """
    n_stages = len(edge_kinds) + 1
    start = np.full((n_stages, n_items), -1, np.int64)
    start[0] = np.arange(n_items)                       # stage 0 streams in

    for s in range(1, n_stages):
        fr = edge_frontier(edge_kinds[s - 1], n_items)
        ready = np.full(n_items, -1, np.int64)
        for t_prod in range(n_items):
            # producer finishes item t_prod at start[s-1, t_prod]; its write
            # lands one tick later (paper §2: arrivals at cycle + 1)
            fr.observe((t_prod,))
            for t_cons in range(n_items):
                if ready[t_cons] < 0 and fr.safe((t_cons,)):
                    ready[t_cons] = start[s - 1, t_prod] + 1
        busy_until = -1
        for t in range(n_items):
            assert ready[t] >= 0, "frontier never unlocked an item"
            start[s, t] = max(ready[t], busy_until + 1)
            busy_until = start[s, t]

    n_ticks = int(start.max()) + 1
    table = np.full((n_stages, n_ticks), -1, np.int64)
    for s in range(n_stages):
        for t in range(n_items):
            table[s, start[s, t]] = t
    return Schedule(start=start, table=table, n_ticks=n_ticks)


def reference_schedule_bruteforce(edge_kinds: Sequence[str],
                                  n_items: int) -> np.ndarray:
    """Oracle: earliest-start via explicit dependency sets (no ISL)."""
    n_stages = len(edge_kinds) + 1
    start = np.full((n_stages, n_items), -1, np.int64)
    start[0] = np.arange(n_items)
    for s in range(1, n_stages):
        kind = edge_kinds[s - 1]
        busy = -1
        for t in range(n_items):
            deps = {
                "pointwise": [t],
                "causal": list(range(t + 1)),
                "full": list(range(n_items)),
            }[kind]
            ready = max(start[s - 1, d] + 1 for d in deps)
            start[s, t] = max(ready, busy + 1)
            busy = start[s, t]
    return start


# ----------------------------------------------------------------- execution
def check_one_item_buffer(schedule: Schedule) -> None:
    """Raise ``ValueError`` unless every item starts on each stage exactly one
    tick after it started on the stage before: the precondition of a stage
    that holds one incoming activation."""
    start = schedule.start
    for s in range(1, start.shape[0]):
        for t in range(start.shape[1]):
            if start[s, t] != start[s - 1, t] + 1:
                raise ValueError(
                    f"pipeline_apply: stage {s} starts item {t} at tick "
                    f"{int(start[s, t])}, not one tick after stage {s - 1} "
                    f"(tick {int(start[s - 1, t])}); a stage holds one "
                    f"activation, so this schedule cannot run")


def _identity(y):
    return y


def pipeline_apply(stage_fn: Callable, stage_params, xs, schedule: Schedule,
                   group=None, *, collect: Optional[Callable] = None):
    """Run ``schedule`` across the ranks of ``group``, one stage a rank.

    Call it on every rank of ``group`` (a process group, a 1-D
    ``DeviceMesh`` or ``None`` for the default group); the rank's index in
    the group is its stage ``sid``.  ``stage_params`` is this rank's own
    stage's parameters; ``stage_fn(stage_params, x) -> y`` maps an item to
    an item of the same shape and dtype (the activation that hops).
    ``xs`` (n_items, *item_shape): stage 0 reads ``xs[item]``; on the other
    ranks only its shape, dtype and device are used (``torch.empty`` will
    do).  ``collect`` (default: identity) maps each finished item on the
    last stage to what is kept of it (the prefill keeps the last token).
    Returns the kept outputs stacked, (n_items, *kept_shape), on every
    rank: the last stage broadcasts them.
    """
    import torch

    from ..distributed import comm

    group = comm.group_of(group)
    n_stages, n_ticks = schedule.table.shape
    if comm.size(group) != n_stages:
        raise ValueError(f"pipeline_apply: {n_stages} stages over a group of "
                         f"{comm.size(group)} ranks")
    n_items = xs.shape[0]
    if schedule.start.shape[1] != n_items:
        raise ValueError(f"pipeline_apply: the schedule has "
                         f"{schedule.start.shape[1]} items, xs {n_items}")
    check_one_item_buffer(schedule)
    collect = collect or _identity
    sid = comm.rank(group)
    last = n_stages - 1
    item_like = xs[0]
    kept_shape = collect(torch.empty(item_like.shape, dtype=xs.dtype,
                                     device="meta")).shape
    outs = torch.empty((n_items,) + tuple(kept_shape), dtype=xs.dtype,
                       device=xs.device)
    table = schedule.table
    buf = None
    for tick in range(n_ticks):
        item = int(table[sid, tick])
        y = None
        if item >= 0:
            x = xs[item] if sid == 0 else buf
            y = stage_fn(stage_params, x)
            if sid == last:
                outs[item] = collect(y)
        # the hop: this stage's item to sid + 1; sid - 1's item into buf
        send = y if sid < last and item >= 0 else None
        take = sid > 0 and int(table[sid - 1, tick]) >= 0
        got = comm.hop(send, sid + 1, item_like if take else None, sid - 1,
                       group)
        buf = got if take else buf
    return comm.broadcast(outs, last, group)


def sequential_apply(stage_fn: Callable, stage_params: Sequence, xs, *,
                     collect: Optional[Callable] = None):
    """Oracle of :func:`pipeline_apply` in one process: every item through
    every stage (``stage_params[s]``) in a plain loop, then ``collect``."""
    import torch

    collect = collect or _identity
    outs = []
    for item in range(xs.shape[0]):
        x = xs[item]
        for params in stage_params:
            x = stage_fn(params, x)
        outs.append(collect(x))
    return torch.stack(outs)
