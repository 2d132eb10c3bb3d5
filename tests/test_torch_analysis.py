"""The port's static verifier (``repro_torch.analysis``) against the JAX
package's.

``repro_torch.analysis`` is a copy of ``repro.analysis`` with its own
imports.  On the model zoo (plain, ``replicate="auto"``, 2-chip meshes and
co-resident tenants) the ``verify_program`` and ``prefilter_program``
reports are identical: check names, severities, cores, values, messages,
metrics, backend and passes.  Each corruption of ``tests/test_analysis.py``
is applied to both packages' programs and caught by the same checks, with
the same messages.  ``compile_model(analyze=True)`` and
``remap_program(..., analyze=True)`` behave as the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.analysis as RA
import repro.core as R
import repro.faults as RF
import repro_torch.analysis as TA
import repro_torch.core as T
import repro_torch.faults as TF

PKGS = {"ref": (R, RA, RF), "port": (T, TA, TF)}
ZOO = {"fig2": ("build_fig2_graph", {}), "lenet": ("build_lenet_like", {}),
       "resnet4": ("build_resnet_block_chain", {"n_blocks": 4}),
       "tiny_xfmr": ("build_tiny_transformer", {})}
MODES = {"plain": {}, "auto": {"replicate": "auto"}, "chips2": {"chips": 2}}


def _chip(core, n=12):
    return core.make_chip(n, "all_to_all")


def _graph(core, name):
    builder, kw = ZOO[name]
    return getattr(core, builder)(**kw)


def _report(rep):
    return ([dataclasses.astuple(d) for d in rep.diagnostics], rep.metrics,
            rep.backend, rep.checks_run)


def _both(fn):
    """``fn(core, analysis, faults)`` for each package -> (ref, port)."""
    return fn(*PKGS["ref"]), fn(*PKGS["port"])


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_reports_identical(name, mode):
    def run(core, analysis, _):
        chip = _chip(core)
        prog = core.compile_model(_graph(core, name), chip, validate=True,
                                  **MODES[mode])
        target = None if mode == "chips2" else chip
        return (analysis.verify_program(prog, target),
                analysis.prefilter_program(prog, target))
    (rv, rp), (tv, tp) = _both(run)
    assert rv.ok and not rv.diagnostics, rv.summary()
    assert _report(tv) == _report(rv)
    assert _report(tp) == _report(rp)
    assert tv.metrics["deps_checked"] > 0


def test_tenant_reports_identical():
    def run(core, analysis, _):
        pl = core.place_tenants([core.build_fig2_graph(),
                                 core.build_lenet_like()], _chip(core))
        return [analysis.verify_program(p, pl.chip) for p in pl.programs]
    ref, port = _both(run)
    assert [_report(r) for r in port] == [_report(r) for r in ref]


# ------------------------------------------------------------- corruptions
def _pick_dep(prog):
    """First (core cfg, lcu cfg, dep) whose table actually constrains."""
    for _, cfg in sorted(prog.cores.items()):
        for _, lc in sorted(cfg.lcu.items()):
            for d in lc.deps:
                if d.table is not None and not d.table.never_constrains:
                    return cfg, lc, d
    raise AssertionError("no constraining dep in program")


def _saturated_ranks(prog):
    _, _, d = _pick_dep(prog)
    r = d.table.rank.copy()
    r[r >= 0] = d.table.d_lexmax_rank
    d.table = dataclasses.replace(d.table, rank=r)


def _shifted_lexmin(prog):
    _, _, d = _pick_dep(prog)
    d.table = dataclasses.replace(d.table,
                                  d_lexmin_rank=d.table.d_lexmin_rank + 1000)


def _single_rank_entry(prog):
    _, _, d = _pick_dep(prog)
    r = d.table.rank.copy()
    r[tuple(np.argwhere(r >= 1)[-1])] -= 1
    d.table = dataclasses.replace(d.table, rank=r)


def _cleared_deps(prog):
    _pick_dep(prog)[1].deps.clear()


def _unmapped_producer(prog):
    _pick_dep(prog)[2].src_partition = 99


def _zeroed_table(prog):
    _, _, d = _pick_dep(prog)
    r = d.table.rank.copy()
    r[:] = -1
    d.table = dataclasses.replace(d.table, rank=r)


def _rewired_dep(prog):
    parts = sorted({cfg.partition_idx for cfg in prog.cores.values()})
    cfg = next(c for c in prog.cores.values() if c.partition_idx == parts[1])
    for _, lc in sorted(cfg.lcu.items()):
        for d in lc.deps:
            if d.src_partition >= 0:
                d.src_partition = parts[-1]
                return


def _duplicate_residue(prog):
    victim = next(cfg for cfg in prog.cores.values()
                  if cfg.repl_k > 1 and cfg.repl_r == 1)
    victim.repl_r = 0


# name -> (corrupt, compile kwargs, verify kwargs, checks that must fire)
CORRUPTIONS = {
    "saturated_ranks": (_saturated_ranks, {}, {}, {"frontier-unsound"}),
    "shifted_lexmin": (_shifted_lexmin, {}, {}, {"frontier-unsound"}),
    "single_rank_entry": (_single_rank_entry, {}, {},
                          {"codegen-table-mismatch"}),
    "cleared_deps": (_cleared_deps, {}, {}, {"dangling-dep"}),
    "unmapped_producer": (_unmapped_producer, {}, {}, {"dangling-dep"}),
    "duplicate_residue": (_duplicate_residue, {"replicate": "auto"}, {},
                          {"replica-residues", "dangling-dep"}),
    "zeroed_table": (_zeroed_table, {}, {}, {"gate-never-lifts"}),
    "rewired_dep": (_rewired_dep, {}, {}, {"wait-cycle"}),
    "sram_highwater": (None, {}, {"max_inflight": 1000}, {"sram-highwater"}),
}


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_corruption_caught_by_name_as_reference(kind):
    corrupt, ckw, vkw, want = CORRUPTIONS[kind]

    def run(core, analysis, _):
        chip = _chip(core)
        prog = core.compile_model(core.build_lenet_like(), chip,
                                  validate=True, **ckw)
        if corrupt is not None:
            corrupt(prog)
        return analysis.verify_program(prog, chip, **vkw)
    ref, port = _both(run)
    assert want <= set(ref.checks()) and not ref.ok
    assert _report(port) == _report(ref)


def test_dropped_dma_stream_and_link_load_as_reference():
    def run(core, analysis, _):
        prog = core.compile_model(core.build_resnet_block_chain(n_blocks=4),
                                  _chip(core, 4), chips=2, validate=True)
        clean = analysis.verify_program(prog)
        assert prog.dma_streams
        prog.dma_streams.clear()
        return clean, analysis.verify_program(prog)
    (rc, rd), (tc, td) = _both(run)
    assert rc.ok and "missing-dma-stream" in rd.checks()
    assert _report(tc) == _report(rc)
    assert _report(td) == _report(rd)


def test_check_subset_and_unknown_check_as_reference():
    chip = _chip(T)
    prog = T.compile_model(T.build_lenet_like(), chip)
    rep = TA.verify_program(prog, chip, checks=("structural",))
    assert rep.checks_run == ("structural",)
    assert "deps_checked" not in rep.metrics
    with pytest.raises(ValueError, match="unknown checks"):
        TA.verify_program(prog, chip, checks=("nonsense",))
    assert TA.ALL_CHECKS == RA.ALL_CHECKS
    assert TA.PREFILTER_CHECKS == RA.PREFILTER_CHECKS
    assert sorted(TA.__all__) == sorted(RA.__all__)


# ----------------------------------------------- analyze=True entry points
def test_compile_model_analyze_as_reference(monkeypatch):
    for core in (R, T):
        prog = core.compile_model(core.build_lenet_like(), _chip(core),
                                  analyze=True)
        assert prog is not None
    import repro_torch.core.compiler as compiler
    orig = compiler.lower

    def corrupting_lower(*a, **kw):
        prog = orig(*a, **kw)
        _cleared_deps(prog)
        return prog

    monkeypatch.setattr(compiler, "lower", corrupting_lower)
    with pytest.raises(T.CompileValidationError) as ei:
        T.compile_model(T.build_lenet_like(), _chip(T), analyze=True)
    assert ei.value.invariant == "dangling-dep"
    # validate=True alone runs only the structural checks
    T.compile_model(T.build_lenet_like(), _chip(T), validate=True)


@pytest.mark.parametrize("kw", [dict(dead_cores=(0,)),
                                dict(dead_cores=(1, 4), replicate="auto")])
def test_remap_program_analyze_as_reference(kw):
    def run(core, analysis, faults):
        chip = _chip(core)
        res = faults.remap_program(core.build_lenet_like(), chip=chip,
                                   analyze=True, **kw)
        return res, analysis.verify_program(res.program, chip)
    (rr, rv), (tr, tv) = _both(run)
    assert not set(kw["dead_cores"]) & set(tr.cores)
    assert tr.cores == rr.cores and tr.n_crossbars == rr.n_crossbars
    assert tv.ok and _report(tv) == _report(rv)
    assert T.serialize_config(tr.program) == R.serialize_config(rr.program)
