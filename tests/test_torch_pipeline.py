"""The port's polyhedral pipeline schedules (``repro_torch.core.pipeline``)
against the JAX package's: the vectorized frontier-table schedule, the
generated-automata schedule and the explicit-dependency brute force are
equal to each other and to the reference's, start tick for start tick,
over the cases of ``tests/test_pipeline.py``.  The execution half is not
ported (ROADMAP Queue 1 item 10) and says so.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import pipeline as RP
from repro_torch.core import pipeline as TP


def _relation(m):
    """A relation's content: its points under the finite backend (``fisl``,
    whose text shows one point only), else islpy's canonical text."""
    pts = getattr(m, "pts", None)
    return str(m) if pts is None else (str(m), sorted(map(tuple, pts)))


def _same(port, ref):
    np.testing.assert_array_equal(port.start, ref.start)
    np.testing.assert_array_equal(port.table, ref.table)
    assert port.n_ticks == ref.n_ticks
    assert port.utilization() == ref.utilization()


@settings(max_examples=30, deadline=None)
@given(
    kinds=st.lists(st.sampled_from(RP.EDGE_KINDS), min_size=1, max_size=4),
    n_items=st.integers(1, 8),
)
def test_schedule_matches_reference_and_bruteforce(kinds, n_items):
    assert TP.EDGE_KINDS == RP.EDGE_KINDS
    want = TP.reference_schedule_bruteforce(kinds, n_items)
    np.testing.assert_array_equal(
        want, RP.reference_schedule_bruteforce(kinds, n_items))
    sched = TP.derive_schedule(kinds, n_items)
    np.testing.assert_array_equal(sched.start, want)
    _same(sched, RP.derive_schedule(kinds, n_items))
    automata = TP.derive_schedule_automata(kinds, n_items)
    np.testing.assert_array_equal(automata.start, want)
    _same(automata, RP.derive_schedule_automata(kinds, n_items))
    np.testing.assert_array_equal(sched.table, automata.table)


def test_pointwise_schedule_is_classic_pipeline():
    """Pointwise edges: stage s starts item t at tick t + s (skew 1)."""
    sched = TP.derive_schedule(["pointwise"] * 3, 6)
    for s in range(4):
        for t in range(6):
            assert sched.start[s, t] == t + s
    assert sched.utilization() == pytest.approx(6 * 4 / (4 * 9))
    _same(sched, RP.derive_schedule(["pointwise"] * 3, 6))


def test_full_schedule_degenerates_to_layer_at_a_time():
    """A bidirectional (encoder) edge forces wait-for-last-write."""
    sched = TP.derive_schedule(["full"], 4)
    assert sched.start[1, 0] == 4
    assert (sched.start[1] == np.arange(4) + 4).all()
    _same(sched, RP.derive_schedule(["full"], 4))


def test_causal_schedule_skew():
    """Causal edge: the same frontier as pointwise for a 1-item-per-tick
    producer."""
    sched = TP.derive_schedule(["causal"], 5)
    assert (sched.start[1] == np.arange(5) + 1).all()
    _same(sched, RP.derive_schedule(["causal"], 5))


def test_makespan_advantage():
    """Pipelined makespan n+S-1 << sequential n*S for deep pipelines."""
    kinds, n = ["pointwise"] * 7, 16
    sched = TP.derive_schedule(kinds, n)
    assert sched.n_ticks == n + 7
    assert sched.n_ticks < n * 8 / 3
    _same(sched, RP.derive_schedule(kinds, n))


def test_edge_frontier_and_relations_equal_reference():
    """Each edge kind's relations and frontier automaton: the same
    dependence summary, and the same items unlocked after each write."""
    for kind in TP.EDGE_KINDS:
        for n in (1, 3, 6):
            tw, tr = TP.edge_relations(kind, n)
            rw, rr = RP.edge_relations(kind, n)
            assert _relation(tw) == _relation(rw)
            assert _relation(tr) == _relation(rr)
            tf, rf = TP.edge_frontier(kind, n), RP.edge_frontier(kind, n)
            for t in range(n):
                tf.observe((t,))
                rf.observe((t,))
                assert [tf.safe((c,)) for c in range(n)] == \
                    [rf.safe((c,)) for c in range(n)]
    with pytest.raises(ValueError):
        TP.edge_relations("banded", 4)


def test_pipeline_execution_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        TP.pipeline_apply()
