"""The port's polyhedral pipeline schedules (``repro_torch.core.pipeline``)
against the JAX package's: the vectorized frontier-table schedule, the
generated-automata schedule and the explicit-dependency brute force are
equal to each other and to the reference's, start tick for start tick,
over the cases of ``tests/test_pipeline.py``.

The execution half, ``pipeline_apply``, on four ``gloo`` ranks spawned once
(a ``file://`` rendezvous, 60 s group timeout, killed and failed when
late), on ``tests/test_pipeline.py``'s case (4 stages, 6 items, dim 16,
``tanh(x @ w)``, seed 0): bit-equal to the port's ``sequential_apply`` and
within 1e-5 of the reference's ``pipeline_apply`` (one JAX subprocess with
4 forced host devices) for ``pointwise`` and ``causal`` edges; ``full``
edges, whose items start more than a tick after the stage before, raise
``ValueError``, where the reference's own result misses its
``sequential_apply``.  The same ranks run a ``Stage`` split of a smoke LM
through the schedule, bit-equal to ``sequential_apply`` of the stages.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

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


# ----------------------------------------------------------------- execution
REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD, N_ITEMS, DIM = 4, 6, 16
RANK_TIMEOUT_S = 120
KINDS = ("pointwise", "causal", "full")

_RANK = r"""
import datetime, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, init, out, inp = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.configs.base import smoke_config
from repro_torch.core import pipeline as P
from repro_torch.launch.mesh import make_pod_mesh
from repro_torch.models import lm
data = dict(np.load(inp))
w, xs = torch.from_numpy(data["w"]), torch.from_numpy(data["xs"])
mine = xs if rank == 0 else torch.empty_like(xs)
fn = lambda p, x: torch.tanh(x @ p)
res = {}
for kind in %(kinds)r:
    sched = P.derive_schedule([kind] * (world - 1), xs.shape[0])
    try:
        res[kind] = P.pipeline_apply(fn, w[rank], mine, sched).numpy()
        res[kind + "_seq"] = P.sequential_apply(fn, list(w), xs).numpy()
    except ValueError as e:
        res[kind + "_error"] = np.array(str(e))
# a smoke LM split into 4 stages on a ("pod",) dimension of a mesh
import dataclasses
cfg = dataclasses.replace(smoke_config("llama3.2-3b"), n_layers=8)
model = lm.LM(cfg, "cpu", seed=0)
stages = lm.split_stages(model, world)
mesh = make_pod_mesh(world, device_type="cpu")
toks = torch.from_numpy(data["tokens"])
embed = model.embed[toks]
pos = torch.arange(toks.shape[-1])[None].expand(toks.shape[1], -1)
scfg = lm.stage_config(cfg, world)
run = lambda st, x: lm.run_stack(scfg, st, x, pos)
sched = P.derive_schedule(["pointwise"] * (world - 1), toks.shape[0])
with torch.no_grad():
    res["lm"] = P.pipeline_apply(run, stages[rank], embed if rank == 0 else
                                 torch.empty_like(embed), sched,
                                 mesh["pod"], collect=lambda y: y[:, -1]
                                 ).numpy()
    res["lm_seq"] = P.sequential_apply(run, stages, embed,
                                       collect=lambda y: y[:, -1]).numpy()
    res["lm_whole"] = lm.run_stack(cfg, model, embed.reshape(
        -1, *embed.shape[2:]), pos.repeat(toks.shape[0], 1))[:, -1].reshape(
        res["lm"].shape).numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""

_ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.core import pipeline
inp, out = sys.argv[1], sys.argv[2]
data = dict(np.load(inp))
mesh = jax.make_mesh((4,), ("stage",))
w, xs = jnp.asarray(data["w"]), jnp.asarray(data["xs"])
fn = lambda w, x: jnp.tanh(x @ w)
res = {}
for kind in %(kinds)r:
    sched = pipeline.derive_schedule([kind] * 3, xs.shape[0])
    res[kind] = np.asarray(pipeline.pipeline_apply([fn] * 4, w, xs, sched,
                                                   mesh))
    res[kind + "_seq"] = np.asarray(pipeline.sequential_apply([fn] * 4, w,
                                                              xs))
np.savez(out, **res)
"""


def _wait(procs):
    """Wait for every process within ``RANK_TIMEOUT_S``; kill and fail
    those that are late or fail."""
    outs, late = [], []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                late.append(p.args)
                outs.append("")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not late, f"late: {late}"
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    """Every rank's results and the reference's, from one spawn of four
    gloo ranks and the JAX oracle beside them."""
    tmp = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(0)
    inp = tmp / "in.npz"
    np.savez(inp, w=(rng.normal(size=(WORLD, DIM, DIM)) / np.sqrt(DIM)
                     ).astype(np.float32),
             xs=rng.normal(size=(N_ITEMS, DIM)).astype(np.float32),
             tokens=rng.integers(0, 256, (3, 2, 8)))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    rank = _RANK % dict(kinds=KINDS)
    cmds = [[sys.executable, "-c", rank, str(r), str(WORLD),
             str(tmp / "rendezvous"), str(tmp / f"rank{r}.npz"), str(inp)]
            for r in range(WORLD)]
    cmds.append([sys.executable, "-c", _ORACLE % dict(kinds=KINDS),
                 str(inp), str(tmp / "oracle.npz")])
    _wait([subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
           for c in cmds])
    got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return got, dict(np.load(tmp / "oracle.npz"))


@pytest.mark.parametrize("kind", ["pointwise", "causal"])
def test_pipeline_apply_matches_reference_and_sequential(executed, kind):
    got, want = executed
    for r in range(WORLD):
        assert got[r][kind].tobytes() == got[r][kind + "_seq"].tobytes()
        np.testing.assert_allclose(got[r][kind], want[kind], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[r][kind], want[kind + "_seq"],
                                   rtol=1e-5, atol=1e-5)


def test_full_edges_raise_where_the_reference_is_wrong(executed):
    """``full`` edges start stage 1's first item at tick 6, not 1: the port
    refuses the schedule; the reference runs it and misses its own
    sequential result (by 1.23 here)."""
    got, want = executed
    for r in range(WORLD):
        msg = str(got[r]["full_error"])
        assert "stage 1 starts item 0 at tick 6" in msg
    assert np.abs(want["full"] - want["full_seq"]).max() > 0.5


def test_check_one_item_buffer_names_stage_and_item():
    TP.check_one_item_buffer(TP.derive_schedule(["pointwise"] * 3, 5))
    with pytest.raises(ValueError, match="stage 2 starts item 0 at tick 5"):
        TP.check_one_item_buffer(
            TP.derive_schedule(["pointwise", "full"], 4))


def test_stages_through_the_schedule_equal_sequential_apply(executed):
    """A smoke LM split into four ``Stage``s on a mesh's "pod" dimension:
    the pipeline bit-equal to ``sequential_apply`` of the stages, both
    within 1e-5 of the whole stack."""
    got, _ = executed
    for r in range(WORLD):
        assert got[r]["lm"].tobytes() == got[r]["lm_seq"].tobytes()
        np.testing.assert_allclose(got[r]["lm"], got[r]["lm_whole"],
                                   rtol=1e-5, atol=1e-5)
