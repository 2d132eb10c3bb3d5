"""The port's fault layer (``repro_torch.faults``) and the fault path of its
``CmServer`` against the JAX package's.

``repro_torch.faults`` is a copy of ``repro.faults`` with its own imports:
schedules drawn from the same seeds are equal, ``FaultyPlane``'s perturbed
crossbars are bit-equal, ``remap_program`` gives the same programs, and on
the numpy plane a fault-injected serve gives a byte-equal
``ServeReport.to_json()`` and trace file on the cases of
``benchmarks/bench_faults.py`` (core death at three rates with and without
retry; a degraded link on a 2-chip mesh).  ``FaultyPlane`` composes with
``TorchPlane``: over the same int8 conductances it matches a numpy inner
plane to matmul rounding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.faults as RF
import repro.obs as RO
import repro.runtime as RR
import repro_torch.core as T
import repro_torch.faults as TF
import repro_torch.obs as TO
import repro_torch.runtime as TR
from repro_torch.core import NumpyPlane, TorchPlane

PKGS = {"ref": (R, RF, RR, RO), "port": (T, TF, TR, TO)}
# benchmarks/bench_faults.py's constants
DEADLINE, HORIZON = 400, 400


def _images(n, shape=(4, 8, 8), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _fig2_server(which, rate, retry, plane="numpy", **kw):
    core, faults, rt, _ = PKGS[which]
    chip = core.make_chip(8, "all_to_all")
    pl = core.place_tenants([core.build_fig2_graph()], chip,
                            quantizer=kw.get("quantizer"))
    sched = None if rate is None else faults.sample_schedule(
        8, HORIZON, core_fault_rate=rate, seed=11)
    policy = faults.RetryPolicy(max_retries=3, backoff_cycles=32) \
        if retry else None
    return rt.CmServer(pl, chip, faults=sched, deadline=DEADLINE,
                       retry=policy, compute_plane=plane, **kw)


def _mesh_server(which, add):
    core, faults, rt, _ = PKGS[which]
    chip = core.make_chip(6, "banded")
    prog = core.compile_model(core.build_resnet_block_chain(4), chip,
                              chips=2)
    sched = None if add == 0 else faults.FaultSchedule(link_faults=(
        faults.LinkFault(0, 1, cycle=100, latency_add=add, width_shrink=2),))
    return rt.CmServer(prog, faults=sched, deadline=4000,
                       retry=faults.RetryPolicy(max_retries=1),
                       compute_plane="numpy")


def _mesh_images():
    rng = np.random.default_rng(2)
    return [rng.normal(size=(4, 8, 8)).astype(np.float32) for _ in range(3)]


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("kw", [
    dict(n_cores=8, horizon=400, core_fault_rate=0.5, seed=11),
    dict(n_cores=16, horizon=1000, core_fault_rate=0.3,
         links=[(0, 1), (1, 2), (2, 3)], link_fault_rate=0.7, seed=3),
    dict(n_cores=4, horizon=7, core_fault_rate=1.0, links=[(1, 0)],
         link_fault_rate=1.0, link_latency_add=3, link_width_shrink=4,
         seed=0),
])
def test_sample_schedule_equals_reference(kw):
    ref, got = RF.sample_schedule(**kw), TF.sample_schedule(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.dead_at() == ref.dead_at()
    for by in (None, kw["horizon"] // 2):
        assert got.dead_cores(by_cycle=by) == ref.dead_cores(by_cycle=by)
    base_r, base_t = R.make_mesh(2).link, T.make_mesh(2).link
    for key in ref.link_keys():
        rb, rs = ref.link_timeline(key, base_r)
        tb, ts = got.link_timeline(key, base_t)
        np.testing.assert_array_equal(tb, rb)
        assert [(d, dataclasses.asdict(s)) for d, s in ts] == \
            [(d, dataclasses.asdict(s)) for d, s in rs]


def test_schedule_validation_equals_reference():
    for pkg in (RF, TF):
        with pytest.raises(ValueError, match="faults only degrade"):
            pkg.LinkFault(0, 1, cycle=5, latency_add=-1)
        with pytest.raises(ValueError, match="core_fault_rate"):
            pkg.sample_schedule(4, 10, core_fault_rate=1.5)
        with pytest.raises(ValueError, match="horizon"):
            pkg.sample_schedule(4, 0)


# ------------------------------------------------------------ faulty plane
@pytest.mark.parametrize("kw", [
    dict(stuck_fraction=0.2, stuck_value=0.0, drift_sigma=0.05, seed=9),
    dict(stuck_fraction=0.01, drift_sigma=0.02, seed=0),
    dict(stuck_fraction=0.5, stuck_value=1.5, seed=4),
])
def test_faulty_plane_crossbars_bit_equal(kw):
    rng = np.random.default_rng(1)
    m = rng.normal(size=(12, 20)).astype(np.float32)
    rdesc, tdesc = R.make_descriptor(m, "gemm"), T.make_descriptor(m, "gemm")
    ra, ta = RF.FaultyPlane(**kw), TF.FaultyPlane(**kw)
    rp, tp = ra._perturbed(rdesc), ta._perturbed(tdesc)
    for f in ("matrix", "wq", "wscale"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(rp, f))
    assert isinstance(ta.inner, NumpyPlane)
    V = rng.normal(size=(5, 20)).astype(np.float32)
    np.testing.assert_array_equal(ta.mxv_batch(tdesc, V),
                                  ra.mxv_batch(rdesc, V))
    np.testing.assert_array_equal(ta.mxv_one(tdesc, V[0]),
                                  ra.mxv_one(rdesc, V[0]))


class _CodesPlane(NumpyPlane):
    """The numpy plane on the descriptor's int8 conductances, the values
    ``TorchPlane`` computes with (a drifted crossbar is not int8-exact, so
    plain ``NumpyPlane`` would differ from it by the quantization)."""

    def mxv_batch(self, desc, V):
        return np.einsum("bn,mn->bm", V,
                         desc.wq.astype(np.float32) * desc.wscale[:, None])

    def mxv_one(self, desc, v):
        return self.mxv_batch(desc, v[None])[0]


def test_faulty_plane_over_torch_matches_over_numpy():
    kw = dict(stuck_fraction=0.01, drift_sigma=0.02, seed=5)
    reps = [_fig2_server("port", 0.5, True,
                         plane=TF.FaultyPlane(inner=inner, **kw),
                         quantizer=T.dequantize_int8).serve_images(
        _images(6), arrivals=[i * 40 for i in range(6)])
        for inner in (_CodesPlane(), TorchPlane("cpu"))]
    assert reps[1].to_json() == reps[0].to_json()
    assert reps[0].remap_events and reps[0].n_retries
    for a, b in zip(reps[0].requests, reps[1].requests):
        assert a.succeeded == b.succeeded
        for v in (a.output or {}):
            atol = 2e-5 + 1e-6 * float(np.abs(a.output[v]).max())
            np.testing.assert_allclose(b.output[v], a.output[v], rtol=1e-5,
                                       atol=atol)


def test_torch_plane_fault_serve_matches_numpy_plane():
    reps = [_fig2_server("port", 0.5, True, plane=plane,
                         quantizer=T.dequantize_int8).serve_images(
        _images(6), arrivals=[i * 40 for i in range(6)])
        for plane in ("numpy", TorchPlane("cpu"))]
    assert reps[1].to_json() == reps[0].to_json()
    assert reps[0].reprogram_cycles > 0
    for a, b in zip(reps[0].requests, reps[1].requests):
        for v in (a.output or {}):
            np.testing.assert_allclose(b.output[v], a.output[v], rtol=1e-5,
                                       atol=2e-5)


# ------------------------------------------------------ serve, byte-equal
@pytest.mark.parametrize("rate,retry", [(None, False)] + [
    (rate, retry) for rate in (0.25, 0.5, 0.75) for retry in (False, True)])
def test_core_death_serve_byte_equal(rate, retry):
    reps = {w: _fig2_server(w, rate, retry).serve_images(
        _images(6), arrivals=[i * 40 for i in range(6)]) for w in PKGS}
    assert reps["port"].to_json() == reps["ref"].to_json()
    assert reps["port"].to_table() == reps["ref"].to_table()
    for a, b in zip(reps["ref"].requests, reps["port"].requests):
        for v in (a.output or {}):
            np.testing.assert_array_equal(b.output[v], a.output[v])


@pytest.mark.parametrize("add", [0, 8, 32])
def test_degraded_link_serve_byte_equal(add):
    reps = {w: _mesh_server(w, add).serve_images(
        _mesh_images(), arrivals=[0, 60, 120]) for w in PKGS}
    assert reps["ref"].goodput == 1.0
    assert reps["port"].to_json() == reps["ref"].to_json()


def test_recovery_trace_bytes_equal(tmp_path):
    blobs = []
    for which in ("ref", "port"):
        rt, obs = PKGS[which][2:]
        reqs = [rt.CmRequest(rid=i, image=img, arrival=i * 40)
                for i, img in enumerate(_images(6))]
        tr = obs.TraceRecorder()
        rep = _fig2_server(which, 0.5, True).serve(reqs, trace=tr)
        path = tmp_path / f"{which}.json"
        tr.write(str(path), rep.stats.cycles - 1)
        blobs.append(path.read_bytes())
    assert blobs[0] == blobs[1]
    assert b"remap-ok" in blobs[0] and b"retry-wait" in blobs[0]


# ------------------------------------------------------------- recovery
@pytest.mark.parametrize("kw", [
    dict(dead_cores=[0]),
    dict(dead_cores=[0], reserved_cores=[1, 2, 3]),
    dict(dead_cores=[2, 5], replicate="auto"),
])
def test_remap_program_equals_reference(kw):
    res = {}
    for which in PKGS:
        core, faults = PKGS[which][:2]
        res[which] = faults.remap_program(
            core.build_lenet_like(), chip=core.make_chip(8, "all_to_all"),
            **kw)
    assert res["port"].cores == res["ref"].cores
    assert res["port"].n_crossbars == res["ref"].n_crossbars
    assert T.serialize_config(res["port"].program) == \
        R.serialize_config(res["ref"].program)


def test_remap_mesh_equals_reference():
    res = {}
    for which in PKGS:
        core, faults = PKGS[which][:2]
        chip = core.make_chip(6, "banded")
        res[which] = faults.remap_program(
            core.build_resnet_block_chain(2), mesh=core.make_mesh(3, chip=chip),
            dead_cores=[1])
    assert res["port"].cores == res["ref"].cores
    assert T.serialize_config(res["port"].program) == \
        R.serialize_config(res["ref"].program)


def test_retry_policy_and_server_checks_equal_reference():
    for faults in (RF, TF):
        p = faults.RetryPolicy(max_retries=4, backoff_cycles=10,
                               backoff_factor=3, max_backoff_cycles=200)
        assert [p.backoff(a) for a in range(1, 6)] == [10, 30, 90, 200, 200]
        with pytest.raises(ValueError):
            faults.RetryPolicy(backoff_factor=0)
    chip = T.make_chip(8, "all_to_all")
    pl = T.place_tenants([T.build_fig2_graph()], chip)
    sched = TF.FaultSchedule(core_faults=(TF.CoreFault(0, 0),))
    with pytest.raises(ValueError, match="deadline"):
        TR.CmServer(pl, chip, faults=sched, compute_plane="numpy")
    with pytest.raises(ValueError, match="reprogram_cost_cycles"):
        TR.CmServer(pl, chip, reprogram_cost_cycles=-1, compute_plane="numpy")
