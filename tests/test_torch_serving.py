"""The port's serving runtime against the JAX package's, and the port's
independence from it.

``repro_torch.runtime.CmServer`` must give a ``ServeReport.to_json()``
byte-equal to ``repro.runtime.CmServer``'s on the numpy plane (cycles are
integers, so nothing but exact equality is right), and on ``TorchPlane``
equal counters with outputs within the float plane's rtol 1e-5 / atol 2e-5.
The port imports neither ``jax`` nor ``repro``: checked by a scan of its
sources and by serving lenet in a process where both are blocked.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import repro.core as R
import repro.runtime as RR
import repro_torch.core as T
import repro_torch.runtime as TR
from repro.faults import RetryPolicy
from repro_torch.core import TorchPlane

REPO = pathlib.Path(__file__).resolve().parent.parent


def _lenet(pkg, **kw):
    g = pkg.build_lenet_like()
    chip = pkg.make_chip(8, "banded")
    return chip, pkg.compile_model(g, chip, **kw)


def _workload(n=8, seed=7):
    rng = np.random.default_rng(0)
    images = [rng.normal(size=(1, 12, 12)).astype(np.float32)
              for _ in range(n)]
    return images, RR.poisson_arrivals(n, rate=0.02, seed=seed)


def _serve(pkg, rt, server_kw, images, arrivals, priorities=None, **ckw):
    chip, prog = _lenet(pkg, **ckw)
    srv = rt.CmServer(prog, chip, **server_kw)
    return srv.serve_images(images, arrivals, priorities=priorities)


@pytest.mark.parametrize("policy,max_inflight", [("fifo", None),
                                                 ("fifo", 2),
                                                 ("priority", 2)])
def test_serve_report_json_byte_equal(policy, max_inflight):
    images, arrivals = _workload()
    prio = [i % 3 for i in range(len(images))] if policy == "priority" \
        else None
    kw = dict(compute_plane="numpy", policy=policy, max_inflight=max_inflight)
    ref = _serve(R, RR, kw, images, arrivals, prio)
    got = _serve(T, TR, kw, images, arrivals, prio)
    assert got.to_json() == ref.to_json()
    assert got.to_table() == ref.to_table()
    for a, b in zip(ref.requests, got.requests):
        for v in a.output:
            np.testing.assert_array_equal(b.output[v], a.output[v])


def test_deadline_retries_without_faults_byte_equal():
    """Requests that miss a tight deadline are retried with backoff; the
    port's epoch loop (which has no fault layer to remap with) must follow
    the reference's exactly."""
    images, arrivals = _workload(seed=3)
    kw = dict(compute_plane="numpy", max_inflight=1, deadline=150,
              retry=RetryPolicy(max_retries=2, backoff_cycles=16))
    ref = _serve(R, RR, kw, images, arrivals)
    got = _serve(T, TR, kw, images, arrivals)
    assert ref.n_retries > 0 and ref.failures()      # the path is exercised
    assert got.to_json() == ref.to_json()


def test_torch_plane_serve_counters_equal_outputs_close():
    images, arrivals = _workload()
    ref = _serve(R, RR, dict(compute_plane="numpy", max_inflight=4), images,
                 arrivals, quantizer=R.dequantize_int8)
    got = _serve(T, TR, dict(compute_plane=TorchPlane("cpu"), max_inflight=4),
                 images, arrivals, quantizer=T.dequantize_int8)
    assert got.to_json() == ref.to_json()
    for f in ("cycles", "messages", "bytes_sent"):
        assert getattr(got.stats, f) == getattr(ref.stats, f)
    for f in ("busy", "sram_high_water"):
        assert dict(getattr(got.stats, f)) == dict(getattr(ref.stats, f))
    for a, b in zip(ref.requests, got.requests):
        for v in a.output:
            np.testing.assert_allclose(b.output[v], a.output[v], rtol=1e-5,
                                       atol=2e-5)


def test_unported_server_options_raise():
    chip, prog = _lenet(T)
    with pytest.raises(NotImplementedError, match="faults"):
        TR.CmServer(prog, chip, compute_plane="numpy", faults=object(),
                    deadline=100)


def test_from_reference_graph_round_trip():
    """A graph built with the JAX package (here by hand, with an avg-pool
    and a bias the zoo builders do not combine) runs on the port."""
    rng = np.random.default_rng(11)
    g = R.Graph()
    x = g.add_input("x", (3, 10, 10))
    w1 = g.add_weight("w1", rng.normal(size=(6, 3, 3, 3), scale=0.3))
    b1 = g.add_weight("b1", rng.normal(size=(6,), scale=0.1))
    w2 = g.add_weight("w2", rng.normal(size=(5, 6 * 4 * 4), scale=0.2))
    h = g.relu("relu1", g.conv2d("conv1", x, w1, bias=b1))
    h = g.avgpool2d("pool1", h)
    out = g.gemm("fc", g.flatten("flat", h), w2)
    g.mark_output(out)
    tg = T.from_reference_graph(g)
    assert isinstance(tg, T.Graph)
    assert all(np.shares_memory(tg.weights[k], g.weights[k]) is False
               for k in g.weights)
    chip_r, chip_t = R.make_chip(4, "all_to_all"), T.make_chip(4, "all_to_all")
    pr, pt = R.compile_model(g, chip_r), T.compile_model(tg, chip_t)
    assert T.serialize_config(pt) == R.serialize_config(pr)
    imgs = [rng.normal(size=(3, 10, 10)).astype(np.float32) for _ in range(2)]
    ro, rs = R.Simulator(pr, chip_r, compute_plane="numpy").run(imgs)
    to, ts = T.Simulator(pt, chip_t, compute_plane="numpy").run(imgs)
    assert (rs.cycles, rs.messages) == (ts.cycles, ts.messages)
    for a, b in zip(ro, to):
        np.testing.assert_array_equal(b[out], a[out])
    want = T.execute_reference(tg, {"x": imgs[0]})[out]
    np.testing.assert_allclose(to[0][out], want, rtol=1e-4, atol=1e-4)


_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
from repro_torch.core import (TorchPlane, build_lenet_like, compile_model,
                              dequantize_int8, make_chip)
from repro_torch.runtime import CmServer, poisson_arrivals
chip = make_chip(8, "banded")
prog = compile_model(build_lenet_like(), chip, quantizer=dequantize_int8)
rng = np.random.default_rng(0)
images = [rng.normal(size=(1, 12, 12)).astype(np.float32) for _ in range(4)]
rep = CmServer(prog, chip, compute_plane=TorchPlane("cpu")).serve_images(
    images, poisson_arrivals(4, rate=0.02, seed=1))
assert len(rep.successes()) == 4
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("served", rep.stats.cycles)
"""


def test_port_serves_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("served ")


_IMPORT = re.compile(r"^\s*(?:from|import)\s+([\w.]+)")
_FORBIDDEN = re.compile(r"^(?:jax|jaxlib)\b|^repro\b(?!_torch)")


def test_port_sources_import_no_jax_and_no_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for path in files:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            m = _IMPORT.match(line)
            if m and _FORBIDDEN.search(m.group(1)):
                bad.append(f"{path.relative_to(REPO)}:{i}: {line.strip()}")
    assert not bad, "\n".join(bad)
