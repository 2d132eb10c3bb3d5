"""The port's compiler and simulator against the JAX package's.

``repro_torch.core`` is a copy of ``repro.core`` with its own imports, so it
must not drift: on every model and compile mode below, the serialized
configuration bundle is byte-equal, every core's int8 conductances and
scales are equal, and on the numpy plane both engines under both schedules
give bit-identical outputs and equal ``SimStats`` (stall breakdowns
included), and the trace file is byte-equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.obs as RO
import repro_torch.core as T
import repro_torch.obs as TO

# name -> (builder name, builder kwargs, make_chip args, compile kwargs,
#          mesh chips or None)
CASES = {
    "fig2": ("build_fig2_graph", {}, (4, "all_to_all"), {}, None),
    "lenet12": ("build_lenet_like", {}, (8, "banded"), {}, None),
    "lenet28": ("build_lenet_like", {"img": 28}, (8, "banded"), {}, None),
    "resnet4": ("build_resnet_block_chain", {"n_blocks": 4}, (8, "banded"),
                {}, None),
    "tiny_xfmr": ("build_tiny_transformer", {}, (12, "banded"), {}, None),
    "lenet_repl_auto": ("build_lenet_like", {},
                        (18, "all_to_all", 256, 16), {"replicate": "auto"},
                        None),
    "resnet4_chips2": ("build_resnet_block_chain", {"n_blocks": 4},
                       (6, "banded"), {"chips": 2}, 2),
}


def _build(pkg, name):
    builder, bkw, chip_args, ckw, mesh_chips = CASES[name]
    g = getattr(pkg, builder)(**bkw)
    chip = pkg.make_chip(*chip_args[:3], dma_pixels_per_cycle=chip_args[3]) \
        if len(chip_args) == 4 else pkg.make_chip(*chip_args)
    prog = pkg.compile_model(g, chip, **ckw)
    target = pkg.make_mesh(mesh_chips, chip=chip) if mesh_chips else chip
    return g, target, [prog], None


def _build_tenants(pkg):
    chip = pkg.make_chip(16, "banded")
    tp = pkg.place_tenants([pkg.build_tiny_transformer(),
                            pkg.build_lenet_like()], chip)
    return None, chip, tp.programs, [0, 1, 0, 1]


_CACHE = {}


def _compiled(name):
    if name not in _CACHE:
        if name == "tenants":
            _CACHE[name] = (_build_tenants(R), _build_tenants(T))
        else:
            _CACHE[name] = (_build(R, name), _build(T, name))
    return _CACHE[name]


def _images(progs, tenants, n=2, seed=0):
    rng = np.random.default_rng(seed)
    if tenants is None:
        shp = progs[0].gcu.input_shape
        return [rng.normal(size=shp).astype(np.float32) for _ in range(n)]
    return [rng.normal(size=progs[t].gcu.input_shape).astype(np.float32)
            for t in tenants]


def _plain(v):
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


ALL = list(CASES) + ["tenants"]


@pytest.mark.parametrize("name", ALL)
def test_serialized_config_and_conductances_equal(name):
    (_, _, rprogs, _), (_, _, tprogs, _) = _compiled(name)
    assert len(rprogs) == len(tprogs)
    if name == "resnet4_chips2":      # the mesh case really cuts the chain
        assert tprogs[0].dma_streams
    for rp, tp in zip(rprogs, tprogs):
        assert T.serialize_config(tp) == R.serialize_config(rp)
        assert sorted(rp.cores) == sorted(tp.cores)
        for cid, rc in rp.cores.items():
            tc = tp.cores[cid]
            assert (rc.compute is None) == (tc.compute is None), cid
            if rc.compute is not None:
                np.testing.assert_array_equal(tc.compute.wq, rc.compute.wq)
                np.testing.assert_array_equal(tc.compute.wscale,
                                              rc.compute.wscale)
                assert tc.compute.wq.dtype == np.int8
                assert tc.compute.wscale.dtype == np.float32


@pytest.mark.parametrize("schedule", ["pipelined", "sequential"])
@pytest.mark.parametrize("engine", ["event", "reference"])
@pytest.mark.parametrize("name", ALL)
def test_numpy_plane_runs_bit_identical(name, engine, schedule):
    (_, rtarget, rprogs, tenants), (_, ttarget, tprogs, _) = _compiled(name)
    images = _images(rprogs, tenants)
    kw = dict(schedule=schedule, stalls=True)
    if tenants is not None:
        kw["tenants"] = tenants
    ro, rs = R.Simulator(rprogs if len(rprogs) > 1 else rprogs[0], rtarget,
                         engine=engine, compute_plane="numpy").run(images,
                                                                   **kw)
    to, ts = T.Simulator(tprogs if len(tprogs) > 1 else tprogs[0], ttarget,
                         engine=engine, compute_plane="numpy").run(images,
                                                                   **kw)
    assert len(ro) == len(to)
    for a, b in zip(ro, to):
        assert sorted(a) == sorted(b)
        for v in a:
            np.testing.assert_array_equal(b[v], a[v], err_msg=v)
    assert rs.stalls is not None
    assert _plain(ts) == _plain(rs)


@pytest.mark.parametrize("engine", ["event", "reference"])
def test_trace_file_bytes_equal(engine, tmp_path):
    (_, rchip, (rprog,), _), (_, tchip, (tprog,), _) = _compiled("lenet12")
    images = _images([rprog], None, n=3)
    blobs = []
    for core, obs, prog, chip in ((R, RO, rprog, rchip), (T, TO, tprog, tchip)):
        tr = obs.TraceRecorder()
        sim = core.Simulator(prog, chip, engine=engine, compute_plane="numpy")
        _, stats = sim.run(images, trace=tr)
        path = tmp_path / f"{core.__name__}.json"
        tr.write(str(path), stats.cycles - 1, sim.stage_of_core())
        blobs.append(path.read_bytes())
    assert blobs[0] == blobs[1]
    assert len(blobs[0]) > 100


def test_port_graph_zoo_equals_reference():
    """The port's builders make the same graphs (same seeds, same weights)."""
    for builder, kw in (("build_fig2_graph", {}), ("build_lenet_like", {}),
                        ("build_resnet_block_chain", {"c": 28, "img": 16}),
                        ("build_tiny_transformer", {})):
        rg, tg = getattr(R, builder)(**kw), getattr(T, builder)(**kw)
        assert [(n.name, n.op, n.inputs, n.outputs, n.attrs)
                for n in rg.nodes] == \
            [(n.name, n.op, n.inputs, n.outputs, n.attrs) for n in tg.nodes]
        assert sorted(rg.weights) == sorted(tg.weights)
        for k in rg.weights:
            np.testing.assert_array_equal(tg.weights[k], rg.weights[k])


def test_unported_compile_options_raise():
    """The compile options that once raised in the port now compile as in
    the reference: ``analyze=True`` (the static verifier) and
    ``tune="lenet"`` (the committed autotuned configuration)."""
    g = T.build_lenet_like()
    chip = T.make_chip(8, "banded")
    prog = T.compile_model(g, chip, analyze=True)
    assert T.serialize_config(prog) == R.serialize_config(
        R.compile_model(R.build_lenet_like(), R.make_chip(8, "banded"),
                        analyze=True))
    kw = dict(n_cores=18, topology="all_to_all", dma_pixels_per_cycle=16)
    tuned = T.compile_model(g, T.make_chip(**kw), tune="lenet")
    assert T.serialize_config(tuned) == R.serialize_config(
        R.compile_model(R.build_lenet_like(), R.make_chip(**kw),
                        tune="lenet"))
    assert T.serialize_config(tuned) != T.serialize_config(
        T.compile_model(g, T.make_chip(**kw)))
