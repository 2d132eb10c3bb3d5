"""The launch tooling of the port (``repro_torch.launch.{specs, roofline,
dryrun, hillclimb, report, finalize_experiments}``) against the JAX
package's, the collective log, the train step across a "pod" axis and bf16
scores on the plain attention path.

* Model arithmetic equal to the reference's: ``model_flops`` and
  ``analytic_bytes`` for every arch x ``shapes_for`` cell; ``roofline_terms``
  given the reference's TPU rates (read from ``repro.launch.roofline``)
  equal to the reference's; ``kernel_bound`` giving PERF.md's bounds of
  kernels 1, 4, 5 and 7 at the H100's data-sheet rates.
* ``distributed.comm.CollectiveLog`` counts a hand-written program's
  collectives exactly; the log of a smoke-width sharded train step traced
  on fake tensors over a fake process group (on gloo's branches) equals,
  record for record, the log of four real ``gloo`` ranks running it, on a
  (2, 2) mesh and a (2, 1, 2) ("pod", "data", "model") mesh.
* ``make_cell`` builds every arch x shape at full size; train cells trace
  on a (2, 2) fake mesh, serving cells on one rank and on (2, 2) (the
  rank's part of the cache as ``cache_specs`` cuts it, the collectives of
  serving under a mesh), the enc-dec's raising there naming ROADMAP item
  10(k); a rank's parameter bytes at 16 x 16 equal the
  reference's per-device bytes (``param_specs``, ``jax.eval_shape``), and
  the moments summed over the mesh equal the reference's.
* Traced FLOPs: exactly a hand count of the products for a tiny config;
  within a measured band of the reference's ``cost_analysis()`` (it counts
  elementwise work too); ``run_cell_scaled``'s extrapolation within 2%
  (FLOPs) and 5% (collective bytes) of a four-layer trace.
* The (2, 1, 2) pod step's loss and gradients against the reference's
  sharded ``jax.value_and_grad`` on an ``Auto``-axis mesh of that shape.
* bf16 scores against ``repro.models.layers._gqa_scores_softmax_out``.

Every fake or ``gloo`` process group is destroyed in a ``finally``
(``dryrun.fake_world``) or lives in a subprocess.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_seq_parallel import REPO, _flat, _wait

WORLD = 4
B, S = 8, 16
TOL = 1e-4                                     # x max(1, max|g|)
MESHES = {"2x2": (2, 2), "pod": (2, 1, 2), "pod_data": (2, 2, 1)}
TINY = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
            head_dim=16, param_dtype="float32", compute_dtype="float32",
            q_chunk=16)


def _archs():
    from repro_torch.configs import archs
    return list(archs.ALL)


def _cells():
    from repro_torch.configs.base import get_arch, shapes_for
    return [(a, s) for a in _archs() for s in shapes_for(get_arch(a))]


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _mesh(key):
    from repro_torch.launch.mesh import make_host_mesh, make_pod_mesh
    shape = MESHES[key]
    return make_host_mesh(*shape, device_type="cpu") if len(shape) == 2 \
        else make_pod_mesh(*shape, device_type="cpu")


# ------------------------------------------------------ model arithmetic
@pytest.mark.parametrize("arch,shape", _cells())
def test_model_flops_and_analytic_bytes_match_reference(arch, shape):
    from repro.configs.base import SHAPES as JS, get_arch as jget
    from repro.launch import roofline as jr, specs as js
    from repro_torch.configs.base import SHAPES, get_arch
    from repro_torch.launch import roofline, specs
    cfg, jcfg = get_arch(arch), jget(arch)
    assert specs.model_flops(cfg, SHAPES[shape]) == js.model_flops(
        jcfg, JS[shape])
    for chips in (1, 4, 256, 512):
        assert roofline.analytic_bytes(cfg, SHAPES[shape], chips) == \
            jr.analytic_bytes(jcfg, JS[shape], chips)


@pytest.mark.parametrize("terms", [
    dict(flops_per_device=3.5e13, bytes_per_device=2.8e12,
         coll_bytes_per_device=5.8e9, chips=256, model_flops=2.0e16,
         analytic_bytes_per_device=1.2e9),
    dict(flops_per_device=1e12, bytes_per_device=8e12,
         coll_bytes_per_device=0.0, chips=512, model_flops=1e14),
    dict(flops_per_device=2e9, bytes_per_device=1e6,
         coll_bytes_per_device=3e11, chips=1, model_flops=1e9,
         analytic_bytes_per_device=4e5)])
def test_roofline_terms_match_reference_at_its_rates(terms):
    from repro.launch import roofline as jr
    from repro_torch.launch import roofline
    got = roofline.roofline_terms(**terms, peak_flops=jr.PEAK_FLOPS,
                                  hbm_bw=jr.HBM_BW, link_bw=jr.ICI_BW)
    assert got == jr.roofline_terms(**terms)


def test_roofline_charges_groups_across_hosts_at_the_network_rate():
    from repro_torch.launch import roofline as R
    t = R.roofline_terms(flops_per_device=0.0, bytes_per_device=0.0,
                         coll_bytes_per_device=9e9, chips=256,
                         model_flops=1.0, network_bytes_per_device=4e9)
    assert t["t_collective_s"] == pytest.approx(5e9 / R.LINK_BW
                                                + 4e9 / R.NETWORK_BW)
    assert R.spans_hosts(tuple(range(8))) is False
    assert R.spans_hosts(tuple(range(0, 256, 16))) is True


def _decode_cost(b, hq, hkv, d, positions, q_elem, kv_elem):
    """(operations, bytes) of a decode over ``positions`` cached positions
    in all (the rows' lengths summed): those K/V rows read once, q read and
    the output written once (PERF.md's row 5)."""
    return (4 * d * hq * positions,
            2 * positions * hkv * d * kv_elem + 2 * b * hq * d * q_elem)


@pytest.mark.parametrize("row,cost,dtype,want_us", [
    ("1 crossbar_mxv (256, 252, 28) f32", ("mxv", (256, 252, 28)), "f32",
     0.0877),
    ("4 flash_attention (8, 24, 8, 512, 128) bf16 causal",
     ("attn", (8, 24, 8, 512, 512, 128, 2)), "bf16", 20.03),
    ("5 flash_decode (8, 24, 8, 2048, 128) bf16, lengths 529",
     ("decode", (8, 24, 8, 128, 8 * 529, 2, 2)), "bf16", 5.20),
    ("7 selective_scan (8, 512, 8192, 16) bf16",
     ("scan", (8, 512, 8192, 16, 2)), "f32", 81.63)])
def test_kernel_bound_reproduces_perf_bounds(row, cost, dtype, want_us):
    """PERF.md §6's bounds (bytes over 3.35 TB/s or operations over the
    peak, the larger) from ``bench_kernels``' cost helpers (the decode's
    here: the bench has no decode row)."""
    from repro_torch.launch import bench_kernels as bk
    from repro_torch.launch.roofline import kernel_bound
    kind, args = cost
    ops, nbytes = {"mxv": bk.mxv_cost, "attn": bk.attn_cost,
                   "decode": _decode_cost, "scan": bk.scan_cost}[kind](*args)
    t, by = kernel_bound(ops, nbytes, dtype)
    assert round(t * 1e6, 4 if want_us < 1 else 2) == want_us, row
    assert by == "bytes"


def test_bench_kernels_refuses_the_cpu():
    res = subprocess.run([sys.executable, "-m",
                          "repro_torch.launch.bench_kernels"], env=_env(),
                         capture_output=True, text=True, timeout=300,
                         cwd=str(REPO))
    assert res.returncode != 0 and "no CUDA device" in res.stderr


# ----------------------------------------------------- the collective log
def test_collective_log_counts_a_hand_written_program():
    """On fake tensors over a fake group (as the dry run traces)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed import comm
    from repro_torch.launch.dryrun import fake_world
    with fake_world(WORLD):
        mesh = _mesh("2x2")
        model, data = mesh.get_group("model"), mesh.get_group("data")
        with FakeTensorMode(), comm.CollectiveLog(mesh) as log:
            comm.all_reduce(torch.ones(3, 5), model)
            comm.all_gather(torch.ones(2, 4, dtype=torch.bfloat16), data, 0)
            comm.reduce_scatter(torch.ones(4, 6), model, 0)
            comm.broadcast(torch.ones(7, dtype=torch.float64), 0, data)
            comm.reduce(torch.ones(5, dtype=torch.bfloat16), 0, model)
            comm.all_to_all(torch.ones(4, 3), [2, 2], [2, 2], data)
            dist.all_reduce(torch.ones(10))
        with FakeTensorMode(), comm.fake_branches("gloo"), \
                comm.CollectiveLog(mesh) as gloo:
            comm.reduce_scatter(torch.ones(4, 6), model, 0)
    me = "test_torch_launch.py:test_collective_log_counts_a_hand_written_program"
    assert [r.key() for r in log.records] == [
        ("all-reduce", "model", 2, 60, me, False),
        ("all-gather", "data", 2, 16, me, False),
        ("reduce-scatter", "model", 2, 96, me, False),
        ("broadcast", "data", 2, 56, me, False),
        ("reduce", "model", 2, 20, me, False),   # summed in f32
        ("all-to-all", "data", 2, 48, me, False),
        ("all-reduce", None, 4, 40, me, False)]
    assert [r.ranks for r in log.records][:2] == [(0, 1), (0, 2)]
    # gloo's reduce-scatter is an all-reduce of the stacked parts
    assert [r.key()[:4] for r in gloo.records] == [
        ("all-reduce", "model", 2, 96)]
    from repro_torch.launch.roofline import collective_summary
    s = collective_summary(log.records)
    assert s["all-reduce"] == {"bytes": 100.0, "count": 2}
    assert s["collective-permute"] == {"bytes": 0.0, "count": 0}


_RANK = r"""
import dataclasses, datetime, json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, init, root = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.configs.base import smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.distributed.comm import CollectiveLog
from repro_torch.launch.mesh import make_host_mesh, make_pod_mesh
from repro_torch.models import build_model, layers as L
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import adamw_init
from repro_torch.train import loop

B, S = %(b)d, %(s)d
cfg = smoke_config("llama3.2-3b")
meshes = {"2x2": make_host_mesh(2, 2, device_type="cpu"),
          "pod": make_pod_mesh(2, 1, 2, device_type="cpu"),
          "pod_data": make_pod_mesh(2, 2, 1, device_type="cpu")}
logs, res = {}, {}
batch = loop.to_device(SyntheticLMData(cfg.vocab_size, B, S, 0).next(),
                       "cpu")
for key, mesh in meshes.items():
    with L.ambient_mesh(mesh):
        model = build_model(cfg, "cpu").requires_grad_(True)
        opt = adamw_init(dict(model.named_parameters()), cfg.adam_dtype,
                         model.shards)
        step = loop.make_train_step(model)
        with CollectiveLog(mesh) as log:
            step(loop.TrainState(model, opt, 0), batch)
    logs[key] = [list(r.key()) for r in log.records]
    logs[key + "_moments"] = {n: list(m.shape) for n, m in opt.mu.items()}
    logs[key + "_coords"] = model.shards.coords


def unflat(flat):
    tree = {}
    for key, arr in flat.items():
        node, parts = tree, key.split(".")
        for a, b in zip(parts, parts[1:]):
            node = node.setdefault(a, {})
        node[parts[-1]] = arr
    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(tree)


# the pod step's loss and gradients from the reference's init
rcfg = dataclasses.replace(cfg, remat=False)
tree = unflat(dict(np.load(f"{root}/params.npz")))
data = {k: torch.from_numpy(v) for k, v in np.load(f"{root}/batch.npz").items()}
with L.ambient_mesh(meshes["pod"]):
    model = params_from_reference(tree, rcfg, "cpu").requires_grad_(True)
    loss, _ = loop.loss_and_grads(rcfg, model, data)
    res["loss"] = loss.numpy()
    for n, p in model.named_parameters():
        if p.grad is not None:
            res["g__" + n] = model.shards.whole(n, p.grad).numpy().copy()
    coords = model.shards.coords
np.savez(f"{root}/pod{rank}.npz", **res)
with open(f"{root}/logs{rank}.json", "w") as f:
    json.dump({"logs": logs, "coords": coords}, f)
dist.destroy_process_group()
"""

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding
from repro import sharding as sh
from repro.configs.base import smoke_config
from repro.models import build_model
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.models.convert import params_from_reference

root = sys.argv[1]
cfg = dataclasses.replace(smoke_config("llama3.2-3b"), remat=False)
tcfg = dataclasses.replace(tsmoke("llama3.2-3b"), remat=False)
model = build_model(cfg)
params = model.init(jax.random.key(0))
batch = {k: jnp.asarray(v) for k, v in np.load(f"{root}/batch.npz").items()}
fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
mesh = jax.make_mesh((2, 1, 2), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
put = lambda t, specs: jax.tree.map(
    lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), t, specs,
    is_leaf=lambda x: hasattr(x, "shape"))
with mesh:
    loss, g = fn(put(params, sh.param_specs(cfg, params, mesh)),
                 put(batch, sh.batch_specs(cfg, batch, mesh)))
want = {"loss": np.asarray(loss)}
port = params_from_reference(jax.tree.map(np.asarray, g), tcfg, "cpu")
for n, t in port.named_parameters():
    want["g__" + n] = t.detach().numpy()
np.savez(f"{root}/want.npz", **want)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four gloo ranks (one spawn): each rank's collective log of the
    sharded step on both meshes and the pod step's gradients; the
    reference's pod-sharded gradients (one JAX process)."""
    import jax
    from repro.configs.base import smoke_config
    from repro.models import build_model
    root = tmp_path_factory.mktemp("launch")
    rng = np.random.default_rng(5)
    np.savez(root / "batch.npz", **{
        k: rng.integers(0, 256, (B, S)).astype(np.int32)
        for k in ("tokens", "labels")})
    env = _env()
    procs = [subprocess.Popen([sys.executable, "-c", _REF, str(root)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    try:
        cfg = dataclasses.replace(smoke_config("llama3.2-3b"), remat=False)
        tree = jax.tree.map(np.asarray,
                            build_model(cfg).init(jax.random.key(0)))
        np.savez(root / "params.npz", **_flat(tree))
    finally:
        procs += [subprocess.Popen(
            [sys.executable, "-c", _RANK % dict(b=B, s=S), str(r),
             str(WORLD), str(root / "rendezvous"), str(root)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        _wait(procs)
    logs = [json.loads((root / f"logs{r}.json").read_text())
            for r in range(WORLD)]
    grads = [dict(np.load(root / f"pod{r}.npz")) for r in range(WORLD)]
    return logs, grads, dict(np.load(root / "want.npz"))


@pytest.mark.parametrize("key", list(MESHES))
def test_fake_trace_log_equals_the_gloo_ranks_log(ranks, key):
    """The fake trace of each rank of the same config, mesh and batch on
    gloo's branches: the same collectives in the same order (kind, mesh
    dimension, group size, operand bytes, issuer, backward) as that real
    rank's; every rank's the same multiset as rank 0's (the one the dry
    run traces), and on (2, 2, 1) the "pod" sums of the two data ranks in
    different orders (each sums the layers it owns)."""
    from repro_torch.configs.base import ShapeSpec, smoke_config
    from repro_torch.distributed import comm
    from repro_torch.launch.dryrun import fake_world, trace_cell
    from repro_torch.launch.specs import make_cell
    traced = []
    for r in range(WORLD):
        with fake_world(WORLD, r), comm.fake_branches("gloo"):
            stats = trace_cell(make_cell(smoke_config("llama3.2-3b"),
                                         ShapeSpec("smoke", S, B, "train"),
                                         _mesh(key)))
        traced.append([list(r.key()) for r in stats["records"]])
    keys = traced[0]
    assert len(keys) > 20 and {k[0] for k in keys} >= {"all-reduce",
                                                       "all-gather"}
    if key.startswith("pod"):
        assert "pod" in {k[1] for k in keys}
    for r in range(WORLD):
        assert ranks[0][r]["logs"][key] == traced[r], r
        assert sorted(traced[r]) == sorted(keys), r
    assert (traced[1] != keys) == (key == "pod_data")


def test_start_traces_matches_the_gloo_ranks_and_an_inline_trace(ranks):
    """``dryrun.start_traces`` (the process ``chip_smoke.py`` phase 28 and
    ``train_step_times --collectives`` start): its (2, 2) trace on gloo's
    branches equals every gloo rank's log, and its one-rank trace equals
    ``trace_cell`` run here."""
    from repro_torch.configs.base import ShapeSpec, smoke_config
    from repro_torch.launch.dryrun import (finish_traces, start_traces,
                                           trace_cell)
    from repro_torch.launch.specs import make_cell
    step = {"arch": "llama3.2-3b", "reduced": True, "seq_len": S, "batch": B}
    got = finish_traces(start_traces({
        "2x2": dict(step, mesh=[2, 2], branches="gloo"), "one": step}),
        timeout=600)
    for r in range(WORLD):
        assert ranks[0][r]["logs"]["2x2"] == got["2x2"]["records"], r
    here = trace_cell(make_cell(smoke_config("llama3.2-3b"),
                                ShapeSpec("smoke", S, B, "train"), None))
    one = got["one"]
    assert one["records"] == [] and one["flops"] == here["flops"]
    assert one["memory"] == here["memory"] and one["bytes"] == here["bytes"]
    assert one["roofline"]["t_collective_s"] == 0.0


def test_pod_ranks_hold_the_same_moments_cut_over_data_only(ranks):
    """(2, 2, 1): ZeRO-1 cuts the moments over "data" and replicates them
    over "pod", as the reference's ``opt_specs``: the ranks at one data
    index hold the same moments' shapes on both pods, and the two data
    ranks of a pod hold different ones (some layer owned by each)."""
    logs = [ranks[0][r]["logs"] for r in range(WORLD)]
    held = {(g["pod_data_coords"]["pod"], g["pod_data_coords"]["data"]):
            g["pod_data_moments"] for g in logs}
    assert sorted(held) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for d in (0, 1):
        assert held[(0, d)] == held[(1, d)]
    assert held[(0, 0)] != held[(0, 1)]


def test_pod_step_matches_the_reference(ranks):
    """``loss_and_grads`` on a (2, 1, 2) ("pod", "data", "model") mesh (the
    batch split over pod x data, gradients summed over "pod"): the loss
    and every gradient made whole within 1e-4 x max(1, max|g|) of the
    reference's sharded ``jax.value_and_grad``, on every rank."""
    _, grads, want = ranks
    wg = {k: v for k, v in want.items() if k.startswith("g__")}
    for r in range(WORLD):
        np.testing.assert_allclose(grads[r]["loss"], want["loss"], rtol=TOL,
                                   atol=TOL)
        assert set(k for k in grads[r] if k.startswith("g__")) == set(wg)
        for n, w in wg.items():
            np.testing.assert_allclose(
                grads[r][n], w, rtol=TOL,
                atol=TOL * max(1.0, float(np.abs(w).max())), err_msg=n)
    coords = sorted((c["pod"], c["model"]) for c in
                    (ranks[0][r]["coords"] for r in range(WORLD)))
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


# ------------------------------------------------------ cells and traces
@pytest.mark.parametrize("arch,shape", _cells())
def test_make_cell_builds_every_cell_at_full_size(arch, shape):
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import tensor_bytes
    from repro_torch.launch.specs import make_cell
    cell = make_cell(arch, shape, None)
    assert cell.kind == SHAPES[shape].kind and cell.placements is None
    with cell.mode:
        model = cell.args[0] if cell.kind != "train" else cell.args[0].model
        n = sum(p.numel() for p in model.parameters())
        # param_count() leaves the norms out
        assert 0 < n - cell.cfg.param_count() <= 1e-2 * n
        assert tensor_bytes(cell.args) > 0


@pytest.mark.parametrize("arch", _archs())
def test_train_cell_traces_on_a_2x2_fake_mesh(arch):
    from repro_torch.configs.base import ShapeSpec, smoke_config
    from repro_torch.launch.dryrun import fake_world, trace_cell
    from repro_torch.launch.specs import make_cell
    with fake_world(WORLD):
        cell = make_cell(smoke_config(arch), ShapeSpec("t", S, B, "train"),
                         _mesh("2x2"))
        stats = trace_cell(cell)
    assert stats["flops"] > 0 and stats["coll_bytes"] > 0
    mem = stats["memory"]
    assert mem["temp_size_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert set(cell.placements) == {"params", "moments", "batch"}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", _archs())
def test_serving_cells_trace_on_one_rank_and_raise_on_a_mesh(arch, kind):
    """Every serving cell traces on one rank (no collective) and on a (2,
    2) fake mesh: the rank's program issues the collectives of serving
    under a mesh, its decode cache is the ``cache_specs`` cut of the whole
    (shapes, and the bytes ``dryrun.cache_bytes`` records), its logits'
    spec the reference's ``logit_sh``; the enc-dec raises there, naming
    item 10(k)."""
    from repro_torch.configs.base import ShapeSpec, smoke_config
    from repro_torch.launch.dryrun import fake_world, trace_cell
    from repro_torch.launch.specs import make_cell
    from repro_torch.models import lm
    from repro_torch.sharding import rules
    cfg = smoke_config(arch)
    shape = ShapeSpec("t", S, B, kind)
    stats = trace_cell(make_cell(cfg, shape, None))
    assert stats["flops"] > 0 and stats["records"] == []
    with fake_world(WORLD):
        mesh = _mesh("2x2")
        if cfg.is_encdec:
            with pytest.raises(NotImplementedError, match=r"item 10\(k\)"):
                make_cell(cfg, shape, mesh)
            return
        cell = make_cell(cfg, shape, mesh)
        stats = trace_cell(cell)
    assert stats["flops"] > 0 and stats["records"]
    assert cell.placements["logits"] == ("data", "model")
    whole = lm.init_cache(cfg, B, S, "meta")
    want = rules._tree_zip(lambda t, p: rules.local_shape(
        t.shape, p, {"data": 2, "model": 2}), whole,
        cell.placements["cache"])
    if kind == "decode":
        cache = cell.args[1]
        got = rules._tree_map(lambda _, t: tuple(t.shape),
                              {k: cache[k] for k in ("layers", "length")})
        assert got == want
    # the batch divides over "data": every leaf's rows are halved
    assert want["length"] == (B // 2,)


def test_accumulated_step_under_a_mesh_raises():
    from repro_torch.configs.base import ShapeSpec, smoke_config
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.specs import make_cell
    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), grad_accum=2)
    with fake_world(WORLD):
        with pytest.raises(NotImplementedError, match=r"item 10\(f\)"):
            make_cell(cfg, ShapeSpec("t", S, B, "train"), _mesh("2x2"))


class _Coords:
    """A duck-typed 16 x 16 mesh at one rank's coordinates."""
    mesh_dim_names = ("data", "model")
    shape = (16, 16)

    def __init__(self, data, model):
        self._c = {"data": data, "model": model}

    def get_local_rank(self, axis):
        return self._c[axis]


def test_rank_bytes_at_16x16_match_the_reference():
    """llama3.2-3b train_4k on 16 x 16: the traced rank's parameter bytes
    are the reference's per-device bytes under ``param_specs`` and its
    moments' ZeRO-1 share; every rank's moments summed over the mesh are
    the reference's per-device moments x 256 (``opt_specs``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh
    from repro import sharding as jsh
    from repro.configs.base import get_arch as jget
    from repro.models import build_model as jbuild
    from repro.optim import adamw_init as jadam
    from repro_torch.launch.dryrun import fake_world, tensor_bytes
    from repro_torch.launch.specs import make_cell
    from repro_torch.sharding.rules import ModelShards

    def per_device(tree, specs, sizes):
        total = 0
        for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                    PartitionSpec))):
            n = int(np.prod(leaf.shape))
            for e in spec:
                for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                    n //= sizes[a]
            total += n * jnp.dtype(leaf.dtype).itemsize
        return total

    jcfg = jget("llama3.2-3b")
    params = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.key(0)))
    amesh = AbstractMesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    pspecs = jsh.param_specs(jcfg, params, amesh)
    want_p = per_device(params, pspecs, sizes)
    moments = jax.eval_shape(lambda p: jadam(p, jcfg.adam_dtype).mu, params)
    want_m = per_device(moments, jsh.opt_specs(jcfg, pspecs, params, amesh),
                        sizes)
    with fake_world(256):
        from repro_torch.launch.mesh import make_production_mesh
        cell = make_cell("llama3.2-3b", "train_4k",
                         make_production_mesh(device_type="cpu"))
        state = cell.args[0]
        with cell.mode:
            got_p = tensor_bytes(state.model)
            got_m = tensor_bytes(state.opt.mu)
    assert got_p == want_p
    assert got_m == want_m              # no owners here: 28 % 16 != 0
    place = cell.placements
    elem = 4 if jcfg.adam_dtype == "float32" else 2
    shapes = {n: tuple(p.shape) for n, p in state.model.named_parameters()}
    total = 0
    for d in range(16):
        for m in range(16):
            sh = ModelShards(_Coords(d, m), place["params"], place["moments"])
            total += sum(int(np.prod(sh.moment_shape(n, shape)))
                         for n, shape in shapes.items())
    assert total * elem == want_m * 256


def _tiny_products(cfg, b, s):
    """FLOPs of the matrix products of one train step of a one-layer dense
    decoder, as the port's program runs them on the CPU path: the
    projections (q, k, v, o, gate, up, down) and the tied head forward,
    each twice more backward (dX, dW); attention's QK^T and PV forward, and
    backward ``attention_bwd_ref``'s five (the scores again, dV, dP, dQ,
    dK); with remat the layer's forward again, but for its last product
    (``torch.utils.checkpoint`` stops once the saved tensors are back)."""
    t, d, hd = b * s, cfg.d_model, cfg.hd
    proj = {"q": d * cfg.n_heads * hd, "k": d * cfg.n_kv_heads * hd,
            "v": d * cfg.n_kv_heads * hd, "o": cfg.n_heads * hd * d,
            "gate": d * cfg.d_ff, "up": d * cfg.d_ff, "down": cfg.d_ff * d}
    layer = sum(2 * t * w for w in proj.values())
    head = 2 * t * d * cfg.vocab_size
    attn = 2 * b * cfg.n_heads * s * s * hd            # one product
    total = 3 * (layer + head) + 2 * attn + 5 * attn
    if cfg.remat:
        total += layer - 2 * t * proj["down"] + 2 * attn
    return total


@pytest.mark.parametrize("remat", [False, True])
def test_traced_flops_equal_a_hand_count(remat):
    from repro_torch.configs.base import ShapeSpec, smoke_config
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.specs import make_cell
    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), n_layers=1,
                              remat=remat)
    stats = trace_cell(make_cell(cfg, ShapeSpec("t", 8, 2, "train"), None))
    assert stats["flops"] == _tiny_products(cfg, 2, 8)


_REF_FLOPS = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import AxisType
from repro.configs import base
from repro.launch.roofline import cost_dict
from repro.launch.specs import make_cell
base.SHAPES["tiny"] = base.ShapeSpec("tiny", 64, 8, "train")
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for depth in (1, 2):
    cell = make_cell("llama3.2-3b", "tiny", mesh,
                     overrides=dict(%(tiny)r, n_layers=depth,
                                    static_unroll=True))
    with mesh:
        c = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                    donate_argnums=cell.donate).lower(*cell.args).compile()
    out[depth] = float(cost_dict(c).get("flops", 0.0))
print(json.dumps(out))
"""


def test_traced_flops_against_the_reference_cost_analysis():
    """A dense train cell (llama3.2-3b at TINY widths, B 8 x S 64) on a
    (2, 2) mesh at one and two layers: the port's traced FLOPs per rank
    against the reference's per-device ``cost_analysis()`` (four host
    devices, ``Auto`` axes).  XLA counts elementwise work (norms, softmax,
    RoPE, AdamW) that ``FlopCounterMode`` does not: readings 0.958 and
    0.959 of it, so the band is [0.93, 0.99]."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import fake_world, trace_cell
    from repro_torch.launch.specs import make_cell
    res = subprocess.run([sys.executable, "-c", _REF_FLOPS % dict(tiny=TINY)],
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for depth in (1, 2):
        with fake_world(WORLD):
            got = trace_cell(make_cell(
                "llama3.2-3b", ShapeSpec("tiny", 64, 8, "train"),
                _mesh("2x2"), dict(TINY, n_layers=depth)))["flops"]
        assert 0.93 <= got / want[str(depth)] <= 0.99, (depth, got, want)


def test_scaled_matches_a_four_layer_trace():
    """The differential depth (one and two layers, extrapolated to four)
    against a four-layer trace: llama3.2-3b train_4k on 16 x 16."""
    from repro_torch.launch.dryrun import _trace_stats
    s1, s2, s4 = (_trace_stats("llama3.2-3b", "train_4k", False, d)
                  for d in (1, 2, 4))
    for key, tol in (("flops", 0.02), ("coll_bytes", 0.05)):
        pred = s1[key] + (s2[key] - s1[key]) * 3
        assert s4[key] > 0
        assert abs(pred - s4[key]) / s4[key] < tol, (key, pred, s4[key])


def test_dryrun_cli_multi_pod_ok():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-3b", "--shape", "train_4k", "--mesh", "multi", "--out",
         ""], env=_env(), capture_output=True, text=True, timeout=600,
        cwd=str(REPO))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "[OK] llama3.2-3b x train_4k x 2x16x16" in res.stdout


def test_train_step_times_log_equals_the_trace_under_torchrun(tmp_path):
    """``train_step_times --meshes 1x4,2x2 --variant baseline --collectives`` on
    four CPU ranks: every rank's logged collectives equal the dry run's
    trace of the same step (gloo's branches), record for record."""
    out = tmp_path / "steps.json"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train_step_times",
         "--variant", "baseline", "--arch", "llama3.2-3b", "--meshes",
         "1x4,2x2", "--reduced", "--depth", "2", "--device", "cpu",
         "--seq-len", "16", "--steps", "2", "--collectives", "--out", str(out)],
        env=_env(), capture_output=True, text=True, timeout=400)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    rec = json.loads(out.read_text())
    for spec, m in rec["meshes"].items():
        d = m["dryrun"]
        assert "error" not in d and d["records"] > 10, (spec, d)
        for r in d["per_rank"]:
            assert r["log_equal"] and r["logged_bytes"] == d["coll_bytes"]
            assert r["t_collective_ms"] > 0


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single", "multi"])
@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k",
                                        "long_500k"])
def test_run_cell_records_serving_on_a_mesh_as_failed(tmp_path, shape_name,
                                                      multi_pod):
    """A serving cell on the 16 x 16 and 2 x 16 x 16 meshes records ``ok``
    with the rank's cache bytes: the whole cache's over 16 x the batch
    ranks where the batch axes ("pod" and "data") divide the batch
    (prefill_32k, decode_32k: the rows over them, llama's head dim over
    "model"), over 256 where they do not (long_500k's B = 1: the positions
    over "data" instead, "pod" replicating), the lengths cut with the rows;
    only the enc-dec there is recorded as failed, naming item 10(k)."""
    from repro_torch.configs.base import SHAPES, get_arch
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import lm
    rec = run_cell("llama3.2-3b", shape_name, multi_pod, str(tmp_path))
    assert rec["ok"], rec.get("error")
    mesh = "multi" if multi_pod else "single"
    assert json.loads((tmp_path / f"llama3.2-3b_{shape_name}_{mesh}.json")
                      .read_text())["ok"] is True
    shape = SHAPES[shape_name]
    whole = lm.init_cache(get_arch("llama3.2-3b"), shape.global_batch,
                          shape.seq_len, "meta")
    kv = sum(t.numel() * t.element_size() for e in whole["layers"]
             for t in e.values())
    length = whole["length"].numel() * 4
    batch_ranks = 32 if multi_pod else 16
    rows = batch_ranks if shape.global_batch % batch_ranks == 0 else 1
    assert rec["cache_bytes"] == kv // (16 * (rows if rows > 1 else 16)) \
        + length // rows
    assert rec["collectives"]["all-reduce"]["count"] > 0
    bad = run_cell("seamless-m4t-large-v2", shape_name, multi_pod,
                   str(tmp_path))
    assert not bad["ok"] and "item 10(k)" in bad["error"]


@pytest.mark.parametrize("variant", ["baseline", "seq", "seq_bf16",
                                     "bf16scores", "seq_causal",
                                     "seq_causal_bf16", "causal", "kv_int8",
                                     "seq_attn_only", "seq_causal_attn_only"])
def test_hillclimb_variant_traces_at_depth_one(variant, capsys):
    from repro_torch.launch import hillclimb
    rec = hillclimb.run("llama3.2-3b", "train_4k", variant, 1, False, "", {})
    assert rec["flops"] > 0 and rec["coll_bytes"] > 0
    assert rec["roofline_at_depth"]["t_compute_s"] > 0
    assert "top collectives by operand bytes" in capsys.readouterr().out


def test_hillclimb_variants_are_the_reference_s():
    from repro.launch import hillclimb as jh
    from repro_torch.launch import hillclimb
    assert hillclimb.VARIANTS == jh.VARIANTS


# ------------------------------------------------------- report, tables
def _records():
    rng = np.random.default_rng(3)
    recs = []
    for arch, shape in [("qwen2-moe-a2.7b", "train_4k"),
                        ("llama3.2-3b", "prefill_32k"),
                        ("falcon-mamba-7b", "long_500k"),
                        ("jamba-1.5-large-398b", "decode_32k"),
                        ("llama3.2-3b", "train_4k")]:
        for dom in ("compute", "memory", "collective"):
            t = rng.uniform(1e-6, 3.0, 4)
            recs.append({"arch": arch, "shape": shape, "multi_pod": False,
                         "ok": True, "tag": "scaled", "roofline": {
                             "t_compute_s": float(t[0]),
                             "t_memory_s": float(t[1]),
                             "t_memory_hlo_ub_s": float(t[2]),
                             "t_collective_s": float(t[3]),
                             "dominant": dom,
                             "useful_flops_ratio": float(t[0] / 3),
                             "roofline_fraction": float(t[1] / 4)}})
    recs.append(dict(recs[0], multi_pod=True))
    recs.append(dict(recs[1], ok=False))
    return recs


def test_report_tables_match_the_reference():
    from repro.launch import report as jr
    from repro_torch.launch import report
    recs = _records()
    for mp in (False, True):
        assert report.table(recs, multi_pod=mp) == jr.table(recs,
                                                            multi_pod=mp)
    assert report.failures(recs) == jr.failures(recs)
    for x in (3.2, 0.5, 2e-4, 7e-7):
        assert report.fmt_s(x) == jr.fmt_s(x)


def test_finalize_tables_match_the_reference(tmp_path):
    """``roofline_table`` equal; ``levers_table`` equal with the lever
    column left out (the port's levers name its knobs and kernels); the
    injection into a Markdown file equal."""
    from repro.launch import finalize_experiments as jf
    from repro_torch.launch import finalize_experiments as f
    recs = [r for r in _records() if r["ok"]]
    assert f.roofline_table(recs) == jf.roofline_table(recs)
    drop = lambda t: [row.rsplit("|", 2)[0] for row in t.splitlines()]
    assert drop(f.levers_table(recs)) == drop(jf.levers_table(recs))
    md = "# x\n**TABLE-PLACEHOLDER-ROOFLINE**\n"
    table = f.roofline_table(recs)
    assert f.inject(md, "TABLE-PLACEHOLDER-ROOFLINE", table) == jf.inject(
        md, "TABLE-PLACEHOLDER-ROOFLINE", table)
    d = tmp_path / "dry"
    d.mkdir()
    for i, r in enumerate(recs):
        (d / f"r{i}.json").write_text(json.dumps(r))
    path = tmp_path / "E.md"
    path.write_text("<!-- TABLE-PLACEHOLDER-ROOFLINE -->\nSTALE-ROWS\n"
                    "<!-- /TABLE-PLACEHOLDER-ROOFLINE -->\n"
                    "**TABLE-PLACEHOLDER-LEVERS**\n")
    res = subprocess.run([sys.executable, "-m",
                          "repro_torch.launch.finalize_experiments",
                          str(path), "--dir", str(d)], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    text = path.read_text()
    from repro_torch.launch.report import load
    assert "STALE-ROWS" not in text and f.roofline_table(
        [r for r in load(str(d), "scaled") if not r["multi_pod"]]) in text


# ------------------------------------------------------------ bf16 scores
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_scores_match_the_reference(causal):
    """``attention_ref(..., scores_dtype="bfloat16")`` against the
    reference's ``_gqa_scores_softmax_out`` with bf16 scores, within the
    bf16 attention tests' 5e-2; and the casts make a difference (f32
    scores differ)."""
    import jax.numpy as jnp
    from repro.models.layers import _gqa_scores_softmax_out
    from repro_torch.kernels import ref
    rng = np.random.default_rng(7)
    b, s, hq, hkv, d = 2, 33, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) * 2
               for h in (hq, hkv, hkv))
    mask = np.tril(np.ones((s, s), bool)) if causal else np.ones((s, s),
                                                                  bool)
    want = np.asarray(_gqa_scores_softmax_out(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(mask)[None, None, None], 1.0 / np.sqrt(d),
        scores_dtype=jnp.bfloat16))
    t = lambda x: torch.from_numpy(x).transpose(1, 2)
    got = ref.attention_ref(t(q), t(k), t(v), causal=causal,
                            scores_dtype="bfloat16").transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)
    f32 = ref.attention_ref(t(q), t(k), t(v), causal=causal).transpose(1, 2)
    assert not torch.equal(f32, got)


def test_bf16_scores_are_refused_on_the_card():
    """``build_model`` refuses the knob for a model on the card, and so do
    ``ops.attention``'s wrapper path for tensors on the card (fake CUDA
    tensors here), which every attention layer calls whatever its model
    was built with; CPU and fake CPU tensors take the plain path."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    base = smoke_config("llama3.2-3b")
    cfg = dataclasses.replace(base, scores_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="f32 registers"):
        build_model(cfg, "cuda")
    model = build_model(cfg, "cpu")
    assert model.cfg.scores_dtype == "bfloat16"
    shape = (1, base.n_heads, 8, base.hd)
    with FakeTensorMode():
        q = torch.empty(shape)
        ops.attention(q, q, q, scores_dtype="bfloat16")      # the plain path
        q = torch.empty(shape, device="cuda")
        with pytest.raises(NotImplementedError, match="f32 registers"):
            ops.attention(q, q, q, scores_dtype="bfloat16")


_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch.launch.specs, repro_torch.launch.roofline
import repro_torch.launch.dryrun, repro_torch.launch.hillclimb
import repro_torch.launch.report, repro_torch.launch.finalize_experiments
import repro_torch.launch.bench_kernels, repro_torch.distributed.comm
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_launch_modules_import_neither_jax_nor_repro():
    res = subprocess.run([sys.executable, "-c", _BLOCKED], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_serve_step_times_refuses_reduced_on_the_card(capsys):
    """``--reduced`` is for the CPU: on the card (the default device) the
    tool refuses before it starts a process group, naming the head dims
    the card's kernels are built for."""
    from repro_torch.launch import serve_step_times
    with pytest.raises(SystemExit) as e:
        serve_step_times.main(["--reduced", "--runs", "llama_1x4"])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


def test_serve_step_times_under_torchrun(tmp_path):
    """``serve_step_times`` under ``torchrun`` on four CPU ranks at the
    smoke configs: every rank of a run reports its prefill and decode
    times, the one-card run's logits and greedy tokens are the mesh's
    (the same function), and the dry run's bound stands beside them (no
    prefill trace for the Mamba model)."""
    from repro_torch.configs.base import smoke_config
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = tmp_path / "serve.json"
    runs = "llama_1x4,llama_2x2,llama_b1_32k_2x2,falcon_1x4"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.serve_step_times",
         "--reduced", "--prompt", "16", "--new", "4",
         "--device", "cpu", "--runs", runs, "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["backend"] == "gloo" and rec["world"] == WORLD
    for name in runs.split(","):
        run = rec["runs"][name]
        assert len(run["per_rank"]) == WORLD
        assert run["layers"] == smoke_config(run["arch"]).n_layers
        for r in run["per_rank"]:
            assert r["prefill_ms"] > 0 and r["decode_ms_per_token"] > 0
        one = run["one_card"]
        assert one["greedy_agree"] == 1.0 and one["prefill_logits_err"] < TOL
        bound = run["dryrun"]
        assert bound["decode"]["bound_ms"] > 0
        assert (bound["prefill"] is None) == name.startswith("falcon")
