"""The port's autotuner (``repro_torch.tune``) against the JAX package's.

Every case of ``tests/test_tune.py`` runs here on the port, and where the
search is seeded the port is held to the reference byte for byte: the same
(model, target, workload, budget, seed, space) gives the same
``TuneResult.to_json()``, trial by trial, in both packages; the zoo
searches regenerate the committed ``configs/tuned/*.json``; and
``compile_model(tune=...)`` in each of its forms compiles the same
configuration bundle and simulates to the same counters.  The tuner scores
on the numpy plane, as the reference's does; ``TorchPlane(device="cpu")``
runs the tuned programs within the float plane's bound.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro.core as R
import repro.tune as RT
from repro.analysis import verify_program as r_verify_program
import repro_torch.core as T
import repro_torch.tune as TT
from repro_torch.analysis import verify_program
from repro_torch.tune import search as search_mod

REPO = pathlib.Path(__file__).resolve().parents[1]
CHIP = dict(topology="all_to_all", dma_pixels_per_cycle=16)


def _small_search(pkg, core, seed=0, budget=8):
    return pkg.autotune(
        core.build_lenet_like(), core.make_chip(18, **CHIP),
        pkg.TuneWorkload(n_images=3), budget=budget, seed=seed,
        space=pkg.SearchSpace(max_repl_k=16, batch=4, shortlist=2),
        label="lenet")


def _tenant_search(pkg, core, seed):
    graphs = [core.build_lenet_like(), core.build_resnet_block_chain(2)]
    return pkg.autotune(graphs, core.make_chip(12, **CHIP),
                        pkg.TuneWorkload(n_images=2), budget=4, seed=seed,
                        space=pkg.SearchSpace(batch=2, shortlist=2))


def _same_result(port, ref):
    """Trial by trial first (a drift shows where it starts), then bytes."""
    assert len(port.trials) == len(ref.trials)
    for a, b in zip(port.trials, ref.trials):
        assert a.to_json_dict() == b.to_json_dict(), a.index
    assert port.to_json() == ref.to_json()


def _plain(v):
    import dataclasses
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


# ------------------------------------------------------------- determinism
@pytest.mark.parametrize("seed", [0, 7, 11])
def test_small_search_equals_reference(seed):
    """The reference's same-seed and different-seed cases, on the port,
    and the port's bytes equal to the reference's at each seed."""
    port = _small_search(TT, T, seed=seed)
    again = _small_search(TT, T, seed=seed)
    assert port.to_json() == again.to_json()       # bytes, not just scores
    assert port.best == again.best and port.best_cycles == again.best_cycles
    assert port.best_cycles <= port.baseline_cycles
    assert any(t.stage == "simulated" for t in port.trials)
    _same_result(port, _small_search(RT, R, seed=seed))


def test_no_wallclock_or_backend_in_result_json():
    dumped = json.dumps(json.loads(_small_search(TT, T).to_json()))
    for forbidden in ("_ms", "wall", "time", "islpy", "fisl", "backend"):
        assert forbidden not in dumped, forbidden


# ------------------------------------------------------ funnel accounting
def test_funnel_accounting():
    r = _small_search(TT, T, budget=10)
    counts = r.counts
    assert counts["candidates"] == len(r.trials) <= 10
    assert counts["candidates"] == sum(counts[s] for s in TT.TRIAL_STAGES)
    assert TT.TRIAL_STAGES == RT.TRIAL_STAGES
    for t in r.trials:
        assert t.stage in TT.TRIAL_STAGES
        if t.stage == "simulated":
            assert t.cycles is not None and t.cycles > 0
            assert t.detail.startswith("bottleneck=")
        else:
            assert t.cycles is None            # never touched the engine
        if t.stage in ("compile-error", "prefilter-discard"):
            assert t.static_interval is None   # discarded before ranking
            assert t.detail                    # discard reason is named
    assert [t.index for t in r.trials] == list(range(len(r.trials)))
    _same_result(r, _small_search(RT, R, budget=10))


def test_prefilter_discards_are_never_simulated(monkeypatch):
    """A pre-filter rule that rejects every candidate wider than the base
    program (> 3 cores on lenet), injected into both packages: discarded
    configs never reach the engine, and the two funnels agree."""
    from repro.analysis.diagnostics import AnalysisDiagnostic as RDiag
    from repro.tune import search as r_search_mod
    from repro_torch.analysis.diagnostics import AnalysisDiagnostic as TDiag

    def narrow_only(real, diag):
        def f(prog, chip=None, *, max_inflight=1):
            report = real(prog, chip, max_inflight=max_inflight)
            if len(prog.cores) > 3:
                report.diagnostics.insert(0, diag(
                    check="test-width", severity="error",
                    message=f"rejected: {len(prog.cores)} cores"))
            return report
        return f

    monkeypatch.setattr(search_mod, "prefilter_program",
                        narrow_only(search_mod.prefilter_program, TDiag))
    monkeypatch.setattr(r_search_mod, "prefilter_program",
                        narrow_only(r_search_mod.prefilter_program, RDiag))
    r = _small_search(TT, T, budget=8)
    assert r.counts["prefilter-discard"] >= 1
    for t in r.trials:
        if t.stage == "prefilter-discard":
            assert t.cycles is None
            assert "test-width" in t.detail
        if t.stage == "simulated":
            assert t.n_cores is not None and t.n_cores <= 3
    assert r.best.key() == "base"     # only the base config survived
    _same_result(r, _small_search(RT, R, budget=8))


def test_multi_tenant_tenant_order_moves_score_correctly():
    """Tenant-order moves permute the compiled program list; the evaluator
    remaps its per-image tenant indices to the permuted slots (the
    tenants differ in shape, so a stale index would crash or score the
    wrong model).  The swapped trial's score is pinned by a direct
    simulation, and the search equals the reference's."""
    r = _tenant_search(TT, T, seed=0)
    swapped = [t for t in r.trials
               if t.config.tenant_order == (1, 0) and t.stage == "simulated"]
    assert swapped, "the tenant-swap move must be simulated, not crash"
    graphs = [T.build_lenet_like(), T.build_resnet_block_chain(2)]
    chip = T.make_chip(12, **CHIP)
    workload = TT.TuneWorkload(n_images=2)
    placement = T.place_tenants([graphs[1], graphs[0]], chip)
    rng = np.random.default_rng(workload.seed)
    per_graph = [
        [rng.normal(size=tuple(int(x) for x in g.values[g.inputs[0]].shape)
                    ).astype(np.float32)
         for _ in range(workload.n_images)]
        for g in graphs]
    images, tenants = [], []
    for i in range(workload.n_images):
        for t, imgs in enumerate(per_graph):
            images.append(imgs[i])
            tenants.append({1: 0, 0: 1}[t])   # graph idx -> slot in (1, 0)
    sim = T.Simulator(list(placement.programs), chip, check_raw=False,
                      engine="event", compute_plane="numpy")
    _, stats = sim.run(images, schedule=workload.schedule, tenants=tenants,
                       stalls=True)
    assert int(stats.cycles) == swapped[0].cycles
    _same_result(r, _tenant_search(RT, R, seed=0))


def test_multi_tenant_same_seed_bitwise_identical():
    runs = [_tenant_search(TT, T, seed=3) for _ in range(2)]
    assert runs[0].to_json() == runs[1].to_json()
    _same_result(runs[0], _tenant_search(RT, R, seed=3))


def test_infeasible_space_raises():
    chip = T.make_chip(18, sram_bytes=64, **CHIP)
    with pytest.raises(T.PartitionError, match="no candidate"):
        TT.autotune(T.build_lenet_like(), chip, TT.TuneWorkload(n_images=2),
                    budget=4, seed=0,
                    space=TT.SearchSpace(batch=2, shortlist=1))


def test_budget_is_a_hard_cap():
    r = _small_search(TT, T, budget=5)
    assert len(r.trials) <= 5
    _same_result(r, _small_search(RT, R, budget=5))
    with pytest.raises(ValueError, match="budget"):
        _small_search(TT, T, budget=1)


# ------------------------------------------- committed-artifact round-trip
def _zoo_images(entry, graph):
    rng = np.random.default_rng(entry.workload.seed)
    shape = tuple(int(x) for x in graph.values[graph.inputs[0]].shape)
    return [rng.normal(size=shape).astype(np.float32)
            for _ in range(entry.workload.n_images)]


@pytest.mark.parametrize("name", sorted(RT.ZOO))
def test_tuned_artifact_round_trip(name):
    """configs/tuned/<name>.json → compile_model(tune=) → verify_program
    clean → simulated cycles == the recorded score, counters equal to the
    reference's, and ``TorchPlane("cpu")`` within the float plane's bound
    of the numpy plane on the int8-exact program."""
    assert sorted(TT.ZOO) == sorted(RT.ZOO)
    art = TT.load_tuned(name)
    assert art == RT.load_tuned(name)
    entry = TT.ZOO[name]
    graph, chip = entry.build(), entry.chip()
    prog = T.compile_model(graph, chip, tune=name)
    report = verify_program(prog, chip)
    assert not report.errors(), [d.message for d in report.errors()]
    rentry = RT.ZOO[name]
    rprog = R.compile_model(rentry.build(), rentry.chip(), tune=name)
    assert report.summary() == r_verify_program(rprog, rentry.chip()).summary()
    images = _zoo_images(entry, graph)
    _, stats = T.Simulator(prog, chip, check_raw=False,
                           compute_plane="numpy").run(
        images, schedule=entry.workload.schedule)
    assert stats.cycles == art["cycles"]
    assert art["cycles"] <= art["baseline"]["cycles"]
    _, rstats = R.Simulator(rprog, rentry.chip(), check_raw=False).run(
        images, schedule=entry.workload.schedule)
    assert _plain(stats) == _plain(rstats)
    # the tuned program on the port's own plane (its plain versions here)
    qprog = T.compile_model(graph, chip, tune=name,
                            quantizer=T.dequantize_int8)
    outs = {}
    for plane in (T.NumpyPlane(), T.TorchPlane("cpu")):
        outs[type(plane).__name__], st = T.Simulator(
            qprog, chip, check_raw=False, compute_plane=plane).run(
            images, schedule=entry.workload.schedule, stalls=True)
        assert st.cycles == art["cycles"]
    for a, b in zip(outs["NumpyPlane"], outs["TorchPlane"]):
        for v in a:
            np.testing.assert_allclose(b[v], a[v], rtol=1e-5, atol=2e-5,
                                       err_msg=v)


def _dummy_result(pkg, label="custom", cfg=None):
    cfg = cfg or pkg.TuneConfig(replicate=(("conv1", 2),))
    return pkg.TuneResult(label=label, seed=0, budget=2,
                          space=pkg.SearchSpace(),
                          workload=pkg.TuneWorkload(), best=cfg,
                          best_cycles=100, baseline=cfg, baseline_cycles=100,
                          trials=[])


def test_resolve_tuned_forms():
    cfg = TT.TuneConfig(replicate=(("conv1", 2),))
    assert TT.resolve_tuned(cfg) is cfg
    assert TT.resolve_tuned(_dummy_result(TT, cfg=cfg)) is cfg
    art = TT.load_tuned("lenet")
    assert TT.resolve_tuned(art) == TT.resolve_tuned("lenet")
    p = REPO / "configs" / "tuned" / "lenet.json"
    assert TT.resolve_tuned(p) == TT.resolve_tuned("lenet")
    assert TT.TUNED_DIR == RT.TUNED_DIR == p.parent
    with pytest.raises(FileNotFoundError, match="committed configs"):
        TT.load_tuned("no-such-model")


def _tune_form(pkg, form, name):
    if form == "name":
        return name
    if form == "path":
        return REPO / "configs" / "tuned" / f"{name}.json"
    cfg = pkg.resolve_tuned(pkg.load_tuned(name))
    return cfg if form == "config" else _dummy_result(pkg, name, cfg)


@pytest.mark.parametrize("form", ["name", "path", "config", "result"])
@pytest.mark.parametrize("name", sorted(RT.ZOO))
def test_compile_tune_forms_equal_reference(name, form):
    """``compile_model(tune=)`` takes a zoo name, an artifact path, a
    ``TuneConfig`` and a ``TuneResult``: each compiles the reference's
    configuration bundle byte for byte and simulates to its counters."""
    entry, rentry = TT.ZOO[name], RT.ZOO[name]
    prog = T.compile_model(entry.build(), entry.chip(),
                           tune=_tune_form(TT, form, name))
    rprog = R.compile_model(rentry.build(), rentry.chip(),
                            tune=_tune_form(RT, form, name))
    assert T.serialize_config(prog) == R.serialize_config(rprog)
    images = _zoo_images(entry, entry.build())[:2]
    _, stats = T.Simulator(prog, entry.chip(), check_raw=False,
                           compute_plane="numpy").run(images, stalls=True)
    _, rstats = R.Simulator(rprog, rentry.chip(), check_raw=False,
                            compute_plane="numpy").run(images, stalls=True)
    assert _plain(stats) == _plain(rstats)


def test_artifact_rejects_non_zoo_label():
    with pytest.raises(ValueError, match="zoo"):
        TT.artifact_dict(_dummy_result(TT, label="model"))


def test_tune_config_json_round_trip():
    cfg = TT.TuneConfig(replicate=(("a", 3), ("b", 2)), chips=2,
                        topology="ring", chip_cuts=(3, 8),
                        tenant_order=(1, 0))
    assert TT.TuneConfig.from_json_dict(cfg.to_json_dict()) == cfg
    assert TT.TuneConfig.from_json_dict(json.loads(
        json.dumps(cfg.to_json_dict()))) == cfg
    rcfg = RT.TuneConfig.from_json_dict(cfg.to_json_dict())
    assert rcfg.to_json_dict() == cfg.to_json_dict()
    assert rcfg.key() == cfg.key()
    for pkg in (TT, RT):
        space = pkg.SearchSpace(max_repl_k=4, chip_counts=(1, 2))
        assert pkg.SearchSpace.from_json_dict(space.to_json_dict()) == space
        wl = pkg.TuneWorkload(n_images=5, seed=3)
        assert pkg.TuneWorkload.from_json_dict(wl.to_json_dict()) == wl
    assert TT.plan_key({"b": 2, "a": 3, "c": 1}) == \
        RT.plan_key({"b": 2, "a": 3, "c": 1}) == (("a", 3), ("b", 2))


# ------------------------------------------------- neighborhood primitives
def test_cut_neighbors_and_explicit_cuts():
    pg = T.partition_graph(T.build_resnet_block_chain(2))
    mesh = T.make_mesh(2, chip=T.make_chip(8, **CHIP))
    assign = T.partition_chips(pg, mesh)
    cuts = T.chip_cuts_of(assign, mesh.n_chips)
    assert len(cuts) == mesh.n_chips - 1
    assert T.partition_chips(pg, mesh, cuts=cuts) == assign
    n_parts = len(pg.partitions)
    neighbors = list(T.cut_neighbors(cuts, n_parts))
    assert neighbors
    for nb in neighbors:
        assert nb != tuple(cuts)
        assert all(0 <= b <= n_parts for b in nb)
        assert list(nb) == sorted(nb)
    rpg = R.partition_graph(R.build_resnet_block_chain(2))
    rmesh = R.make_mesh(2, chip=R.make_chip(8, **CHIP))
    rcuts = R.chip_cuts_of(R.partition_chips(rpg, rmesh), rmesh.n_chips)
    assert tuple(rcuts) == tuple(cuts)
    assert list(R.cut_neighbors(rcuts, n_parts)) == neighbors
    with pytest.raises(T.PartitionError, match="cut"):
        T.partition_chips(pg, mesh, cuts=(0, 1))   # wrong boundary count


def test_replicable_stages_names_match_replicate_keys():
    g = T.build_lenet_like()
    stages = T.replicable_stages(T.partition_graph(g))
    assert stages == R.replicable_stages(R.partition_graph(
        R.build_lenet_like()))
    anchor, iters = stages[0]
    assert iters > 1
    prog = T.compile_model(g, T.make_chip(18, **CHIP),
                           replicate={anchor: 2})
    assert prog is not None


def test_tune_kwarg_applies_mesh_and_plan():
    chip = TT.ZOO["resnet4"].chip()
    prog = T.compile_model(T.build_resnet_block_chain(4), chip,
                           tune="resnet4")
    assert TT.load_tuned("resnet4")["config"]["chips"] == 2
    assert prog.mesh is not None and prog.mesh.n_chips == 2
    prog1 = T.compile_model(T.build_resnet_block_chain(4), chip,
                            tune=TT.TuneConfig())
    assert prog1.mesh is None


@pytest.mark.parametrize("name", sorted(RT.ZOO))
def test_artifact_json_is_canonical(name):
    """The recorded search, run on the port, regenerates the committed
    file byte for byte, trial by trial as the reference does."""
    result = TT.tune_zoo_entry(name)
    committed = (REPO / "configs" / "tuned" / f"{name}.json").read_text()
    assert TT.artifact_json(result) == committed
    _same_result(result, RT.tune_zoo_entry(name))


def test_result_json_parses_and_counts_match():
    r = _small_search(TT, T)
    d = json.loads(r.to_json())
    assert d["counts"] == r.counts
    assert d["best_cycles"] == r.best_cycles
    assert len(d["trials"]) == len(r.trials)
    assert isinstance(r, TT.TuneResult)


# --------------------------------------------------------------------- CLI
_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import runpy
sys.argv = ["repro_torch.tune", "--model", sys.argv[1], "--check"]
try:
    runpy.run_module("repro_torch.tune", run_name="__main__")
finally:
    assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                   for m in sys.modules if sys.modules[m] is not None)
"""


@pytest.mark.parametrize("name", sorted(RT.ZOO))
def test_cli_check_with_jax_and_repro_blocked(name):
    """``python -m repro_torch.tune --model <name> --check`` reproduces the
    committed artifact with neither ``jax`` nor ``repro`` importable."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", _BLOCKED, name], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "reproduced bit-for-bit" in res.stdout
