"""The port's distributed layer (``repro_torch.distributed``) against the JAX
package's ``repro.distributed``, on the CPU.

* The accumulated train step (``make_accum_train_step``, n_micro = 4) at
  smoke width in f32, the reference's init carried across by
  ``models/convert.py``: against the reference's ``make_accum_train_step``
  at ``tests/test_torch_train.py``'s tolerances (loss rtol 1e-5, parameters
  and moments 1e-6 x max(1, max|x|)); against the port's plain step at the
  reference's ``test_accum_step_matches_plain_step`` bounds (rtol 2e-4,
  atol 2e-6); with ``grad_compression="int8"``: the reference's own
  accumulator compressed by the port bit-equal to the reference's
  compressed tree, and the step's compressed gradients within a quantum of
  the reference's (half the port's block's plus half the reference's: the
  port compresses each per-layer tensor, the reference each leaf stacked
  over periods, so the blocks differ where a layer's size is not a
  multiple of the block).
* ``Trainer`` takes the accumulated step only where the config asks for
  it: with the defaults a run is bit-identical to a run of
  ``make_train_step``; with ``grad_accum`` and ``grad_compression`` it is
  bit-identical to ``make_accum_train_step``'s, eager and through the
  trainer's graph path (``TrainGraph`` replaced by an eager emulation of a
  replay, ``test_torch_train_graph._EmulatedGraph``).
* ``plan_mesh`` and ``degrade_sequence`` give the reference's plans over a
  ``hypothesis`` sweep of 1-600 devices and the reference test's four
  architectures, with and without ``global_batch``, and its own cases.
* Four ``gloo`` ranks on the CPU, one spawn running every check (each rank
  a process; rendezvous through a file under ``tmp_path``, a 60 s process
  group timeout, the parent killing ranks that are late and failing):
  ``ring_all_reduce`` (n_chunks 1 and 3) equal to ``x.sum(0)`` at rtol 1e-6
  and bit-equal to the reference's ring, ``ring_all_reduce_sharded``;
  ``hierarchical_psum`` on a (2, 2) ``("pod", "data")`` mesh, int8 and
  exact, bit-equal to the reference's, and ``hierarchical_psum_sharded``;
  ``rescale_tree``'s local shards equal to the slices of the reference's
  ``NamedSharding.devices_indices_map`` by mesh coordinate;
  ``make_mesh_from_plan`` over all four ranks and over the first three.
  The reference's results come from one JAX subprocess with
  ``--xla_force_host_platform_device_count=4``, as
  ``tests/test_distributed.py`` runs its own.
* The new modules import neither ``jax`` nor ``repro``; the kernel modules
  import nothing of the distributed layer, the sharding rules or the
  training loop, and the distributed layer imports no training loop at
  import time.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke
from repro.distributed import CompressionSpec as JSpec
from repro.distributed import compress_with_feedback as jcompress
from repro.distributed import degrade_sequence as jdegrade
from repro.distributed import make_accum_train_step as jaccum
from repro.distributed import plan_mesh as jplan
from repro.models import build_model as jbuild
from repro.optim import adamw_init as jadamw_init
from repro.train import TrainState as JTrainState
from repro_torch import distributed as tdist
from repro_torch.configs.base import get_arch
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.distributed import overlap
from repro_torch.distributed.compression import (CompressionSpec,
                                                 compress_in_place,
                                                 quantize_blockwise)
from repro_torch.models.convert import (params_from_reference,
                                        tree_from_reference,
                                        tree_to_reference)
from repro_torch.optim import adamw_init
from repro_torch.train import TrainState, Trainer
from repro_torch.train import loop as train_loop
from repro_torch.train.loop import make_train_step, to_device
from test_torch_train import _one_torch_thread  # noqa: F401
from test_torch_train_graph import emulated_graphs  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "llama3.2-3b"
N_MICRO = 4
_CACHE = {}


def _setup():
    """The reference's smoke llama (init from key 0, as numpy), its f32
    state, and a (8, 16) batch from seed 0, as the reference's
    ``test_accum_step_matches_plain_step`` has them."""
    if "setup" not in _CACHE:
        cfg = jsmoke(ARCH)
        jm = jbuild(cfg)
        params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 16)
                                        ).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (8, 16)
                                        ).astype(np.int32)}
        _CACHE["setup"] = (jm, params, batch)
    return _CACHE["setup"]


def _jstate(params):
    p = jax.tree.map(jnp.asarray, params)
    return JTrainState(p, jadamw_init(p, "float32"), jnp.zeros((), jnp.int32))


def _port_state(params):
    model = params_from_reference(params, tsmoke(ARCH), "cpu"
                                  ).requires_grad_(True)
    return TrainState(model, adamw_init(dict(model.named_parameters())), 0)


def _close_tree(got, want, tol):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(1.0, np.abs(b).max()))


def _port_step(params, batch, compression=None, capture=None):
    """One accumulated step of the port from the reference's init; with
    ``capture``, the accumulator before and after compression recorded."""
    state = _port_state(params)
    step = overlap.make_accum_train_step(state.model, n_micro=N_MICRO,
                                         compression=compression)
    if capture is not None:
        def spy(acc, spec):
            capture["before"] = {k: v.clone() for k, v in acc.items()}
            compress_in_place(acc, spec)
            capture["after"] = {k: v.clone() for k, v in acc.items()}
        orig, overlap.compress_in_place = overlap.compress_in_place, spy
    try:
        new, met = step(state, to_device(batch, "cpu"))
    finally:
        if capture is not None:
            overlap.compress_in_place = orig
    return new, met


def test_accum_step_matches_the_reference():
    jm, params, batch = _setup()
    js, jmet = jax.jit(jaccum(jm, n_micro=N_MICRO))(
        _jstate(params), {k: jnp.asarray(v) for k, v in batch.items()})
    state, met = _port_step(params, batch)
    assert set(met) == set(jmet) == {"loss", "lr", "ce", "aux", "grad_norm"}
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    assert met["lr"] == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert state.step == 1 and state.opt.count == int(js.opt.count) == 1
    model = state.model
    _close_tree(tree_to_reference(model, dict(model.named_parameters())),
                js.params, 1e-6)
    _close_tree(tree_to_reference(model, state.opt.mu), js.opt.mu, 1e-6)
    _close_tree(tree_to_reference(model, state.opt.nu), js.opt.nu, 1e-6)


def test_accum_step_matches_the_plain_step():
    """The reference's ``test_accum_step_matches_plain_step``, on the
    port: n_micro accumulation == the full-batch step (f32)."""
    _, params, batch = _setup()
    plain_state = _port_state(params)
    s1, m1 = make_train_step(plain_state.model)(plain_state,
                                                to_device(batch, "cpu"))
    s2, m2 = _port_step(params, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for (n, a), b in zip(s1.model.named_parameters(),
                         s2.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=n)


def _ref_accumulator(jm, params, batch):
    """The reference's accumulated gradient, in its scan's order: each
    micro-batch's gradient cast to f32, divided by n_micro and added."""
    p = jax.tree.map(jnp.asarray, params)
    acc = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p)
    size = batch["tokens"].shape[0] // N_MICRO
    grad = jax.jit(jax.grad(lambda q, mb: jm.loss(q, mb)[0]))
    for i in range(N_MICRO):
        mb = {k: jnp.asarray(v[i * size:(i + 1) * size])
              for k, v in batch.items()}
        acc = jax.tree.map(lambda a, g: a + g.astype(jnp.float32) / N_MICRO,
                           acc, grad(p, mb))
    return acc


def _block_scales(x: np.ndarray, block: int) -> np.ndarray:
    """Each element's quantum: its block's scale, over the flat view."""
    _, s = quantize_blockwise(torch.from_numpy(np.array(x)),
                              block)
    return np.repeat(s.numpy(), block)[:x.size].reshape(x.shape)


def test_int8_accum_step_compresses_as_the_reference():
    jm, params, batch = _setup()
    spec = CompressionSpec(kind="int8")
    acc = _ref_accumulator(jm, params, batch)
    want, _ = jcompress(acc, jax.tree.map(jnp.zeros_like, acc),
                        JSpec(kind="int8"))
    # the reference's own accumulator, compressed by the port, leaf by leaf
    # in the reference's (stacked) layout: bit-equal
    flat = {str(i): torch.from_numpy(np.array(a)) for i, a in
            enumerate(jax.tree.leaves(acc))}
    compress_in_place(flat, spec)
    for i, w in enumerate(jax.tree.leaves(want)):
        assert flat[str(i)].numpy().tobytes() == np.asarray(w).tobytes()
    # the step's own accumulator: within a quantum of the reference's
    cap = {}
    state, met = _port_step(params, batch, spec, cap)
    model = state.model
    ref_acc = tree_from_reference(model, jax.tree.map(np.asarray, acc))
    ref_c = tree_from_reference(model, jax.tree.map(np.asarray, want))
    ref_scale = tree_from_reference(model, jax.tree.map(
        lambda a: _block_scales(np.asarray(a), spec.block), acc))
    for k, got in cap["after"].items():
        before = cap["before"][k]
        np.testing.assert_allclose(before.numpy(), ref_acc[k].numpy(),
                                   rtol=0, atol=1e-6 * max(
                                       1.0, ref_acc[k].abs().max().item()))
        quantum = 0.5 * (_block_scales(before.numpy(), spec.block)
                         + ref_scale[k].numpy())
        diff = np.abs(got.numpy() - ref_c[k].numpy())
        assert (diff <= quantum * (1 + 1e-6)).all(), k
    assert np.isfinite(float(met["grad_norm"]))


# ----------------------------------------------------------------- Trainer
def _trainer(**over):
    cfg = dataclasses.replace(tsmoke(ARCH), **over)
    return Trainer(cfg=cfg, batch=8, seq_len=16, peak_lr=1e-2, device="cpu")


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("over", [{}, {"grad_accum": 4},
                                  {"grad_accum": 4,
                                   "grad_compression": "int8"},
                                  {"grad_compression": "int8"}])
def test_trainer_takes_the_accumulated_step_only_when_asked(over):
    """3 steps of ``Trainer.run`` against 3 of ``make_train_step`` (the
    defaults) or ``make_accum_train_step`` (the config's ``grad_accum`` and
    compression) on the same init and data: losses and parameters
    bit-equal."""
    tr = _trainer(**over)
    state = tr.init_state()
    body = train_loop.train_body(state.model, state.opt)
    assert body.__qualname__.split(".")[0] == (
        "accum_step_body" if over else "step_body")
    got = tr.run(3, state=state)
    want = _trainer(**over)
    wstate = want.init_state()
    step = overlap.make_accum_train_step(
        wstate.model, n_micro=max(want.cfg.grad_accum, 1),
        peak_lr=want.peak_lr, compression=overlap.compression_of(want.cfg)
    ) if over else make_train_step(wstate.model, peak_lr=want.peak_lr)
    losses = []
    for _ in range(3):
        wstate, met = step(wstate, to_device(want.data.next(), "cpu"))
        losses.append(float(met["loss"]))
    assert tr.history == losses
    wparams = _params(wstate.model)
    for n, p in _params(got.model).items():
        assert torch.equal(p, wparams[n]), n


def test_accumulated_graph_path_is_bit_equal_to_eager(emulated_graphs):
    """4 steps of the int8 accumulated step: 2 eager on the capture stream,
    a capture, replays of the emulated graph, against ``compile=False``."""
    over = {"grad_accum": 4, "grad_compression": "int8"}
    runs = {}
    for compile in (False, True):
        cfg = dataclasses.replace(tsmoke(ARCH), **over)
        tr = Trainer(cfg=cfg, batch=8, seq_len=16, peak_lr=1e-2,
                     device="cpu", compile=compile)
        state = tr.run(4)
        runs[compile] = (tr.history, tr.grad_norms, _params(state.model),
                         list(tr.replayed))
    assert runs[True][3] == [False, False, True, True]
    assert len(emulated_graphs) == 1
    assert runs[True][0] == runs[False][0] and \
        runs[True][1] == runs[False][1]
    for n, p in runs[True][2].items():
        assert torch.equal(p, runs[False][2][n]), n


# ----------------------------------------------------------- elastic plans
PLAN_ARCHS = ["qwen2-7b", "gemma-2b", "qwen3-moe-235b-a22b",
              "falcon-mamba-7b"]


@settings(max_examples=120, deadline=None)
@given(n=st.integers(1, 600), arch=st.sampled_from(PLAN_ARCHS),
       batch=st.sampled_from([None, 1, 7, 48, 256, 1000]),
       pod=st.sampled_from([256, 64]))
def test_plan_mesh_is_the_references(n, arch, batch, pod):
    want = jplan(n, jget_arch(arch), global_batch=batch, pod_size=pod)
    got = tdist.plan_mesh(n, get_arch(arch), global_batch=batch,
                          pod_size=pod)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.utilization == want.utilization


@pytest.mark.parametrize("n,failures", [(512, [64, 64, 128]), (8, [1] * 9),
                                        (300, [0, 299, 5])])
def test_degrade_sequence_is_the_references(n, failures):
    assert tdist.degrade_sequence(n, failures) == jdegrade(n, failures)


@pytest.mark.parametrize("case", ["pod_loss", "batch_divisibility"])
def test_plan_mesh_reference_cases(case):
    cfg = get_arch("qwen2-7b")
    if case == "pod_loss":
        full = tdist.plan_mesh(512, cfg, pod_size=256)
        assert full.n_pods == 2 and full.mesh_shape == (2, 16, 16)
        degraded = tdist.plan_mesh(448, cfg, pod_size=256)
        assert (degraded.n_used, degraded.model_axis, degraded.n_idle) == \
            (448, 16, 0)
    else:
        plan = tdist.plan_mesh(48, cfg, global_batch=256)
        assert 256 % (plan.n_used // plan.model_axis) == 0


# ---------------------------------------------------- four ranks on gloo
WORLD = 4
RANK_TIMEOUT_S = 120

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
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.base import get_arch
from repro_torch.distributed import (
    CompressionSpec, hierarchical_psum, hierarchical_psum_sharded,
    make_mesh_from_plan, plan_mesh, rescale_tree, ring_all_reduce,
    ring_all_reduce_sharded)
data = dict(np.load(inp))
res = {}
x = data["ring_x"]
for nc in (1, 3):
    res[f"ring_{nc}"] = ring_all_reduce(torch.from_numpy(x[rank]),
                                        n_chunks=nc).numpy()
line = init_device_mesh("cpu", (world,), mesh_dim_names=("d",))
res["ring_sharded"] = ring_all_reduce_sharded(
    line, torch.from_numpy(x), "d", n_chunks=3).numpy()
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
coord = mesh.get_coordinate()
res["coord"] = np.array(coord)
h = torch.from_numpy(data["hier_x"])
spec = CompressionSpec(kind="int8", block=32)
mine = h[coord[0] * 2 + coord[1]]
res["hier"] = hierarchical_psum(mine, mesh, spec=spec).numpy()
res["hier_exact"] = hierarchical_psum(mine, mesh).numpy()
res["hier_sharded"] = hierarchical_psum_sharded(mesh, h, spec=spec).numpy()
specs = {"w": (("pod", "data"), None), "b": (None, "data"),
         "e": ("pod", "data"), "r": (None, None)}
tree = {k: data["tree_" + k] for k in specs}
placed = rescale_tree(tree, specs, mesh)
for k in specs:
    res["shard_" + k] = placed[k].to_local().numpy()
llama = get_arch("llama3.2-3b")
res["plan4"] = np.array(make_mesh_from_plan(plan_mesh(4, llama), "cpu").shape)
m3 = make_mesh_from_plan(plan_mesh(3, llama), "cpu")
res["plan3"] = np.array(m3.shape)
c3 = m3.get_coordinate()
res["plan3_coord"] = np.array(c3 if c3 is not None else [-1, -1])
np.savez(out, **res)
dist.destroy_process_group()
"""

_ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed import CompressionSpec, hierarchical_psum, \
    ring_all_reduce
inp, out = sys.argv[1], sys.argv[2]
data = dict(np.load(inp))
res = {}
line = jax.make_mesh((4,), ("d",))
for nc in (1, 3):
    def body(xl, nc=nc):
        return ring_all_reduce(xl[0], "d", n_chunks=nc)[None]
    res[f"ring_{nc}"] = np.asarray(shard_map(
        body, mesh=line, in_specs=P("d"), out_specs=P("d"))(data["ring_x"]))
mesh = jax.make_mesh((2, 2), ("pod", "data"))
for name, spec in (("hier", CompressionSpec(kind="int8", block=32)),
                   ("hier_exact", None)):
    def body(xl, spec=spec):
        return hierarchical_psum(xl[0], fast_axis="data", slow_axis="pod",
                                 spec=spec)[None]
    res[name] = np.asarray(shard_map(
        body, mesh=mesh, in_specs=P(("pod", "data")),
        out_specs=P(("pod", "data")))(data["hier_x"]))
specs = {"w": P(("pod", "data"), None), "b": P(None, "data"),
         "e": P("pod", "data"), "r": P(None, None)}
devs = mesh.devices
for k, spec in specs.items():
    x = data["tree_" + k]
    idx = NamedSharding(mesh, spec).devices_indices_map(x.shape)
    for i in range(2):
        for j in range(2):
            res[f"shard_{k}_{i}{j}"] = x[idx[devs[i, j]]]
np.savez(out, **res)
"""


def _inputs(path):
    rng = np.random.default_rng(0)
    np.savez(path, ring_x=np.arange(4 * 37, dtype=np.float32).reshape(
        4, 37) * 0.25 + rng.standard_normal((4, 37)).astype(np.float32),
        hier_x=rng.standard_normal((4, 64)).astype(np.float32),
        tree_w=rng.standard_normal((8, 6)).astype(np.float32),
        tree_b=rng.standard_normal((3, 4)).astype(np.float32),
        tree_e=rng.standard_normal((4, 6)).astype(np.float32),
        tree_r=rng.standard_normal((2, 2)).astype(np.float32))


def _spawn(cmds, env):
    """Start every command; wait for all within ``RANK_TIMEOUT_S``; kill
    the rest and fail on one that is late or fails."""
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
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
def ranks(tmp_path_factory):
    """Every rank's results and the reference's, from one spawn of four
    gloo ranks and the JAX oracle beside them."""
    tmp = tmp_path_factory.mktemp("gloo")
    inp = tmp / "in.npz"
    _inputs(inp)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    cmds = [[sys.executable, "-c", _RANK, str(r), str(WORLD),
             str(tmp / "rendezvous"), str(tmp / f"rank{r}.npz"), str(inp)]
            for r in range(WORLD)]
    cmds.append([sys.executable, "-c", _ORACLE, str(inp),
                 str(tmp / "oracle.npz")])
    _spawn(cmds, env)
    got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return got, dict(np.load(tmp / "oracle.npz")), dict(np.load(inp))


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_ring_all_reduce_on_four_gloo_ranks(ranks, n_chunks):
    got, want, inp = ranks
    total = inp["ring_x"].sum(0)
    for r in range(WORLD):
        mine = got[r][f"ring_{n_chunks}"]
        np.testing.assert_allclose(mine, total, rtol=1e-6)
        assert mine.tobytes() == want[f"ring_{n_chunks}"][r].tobytes()
        if n_chunks == 3:
            assert np.array_equal(got[r]["ring_sharded"],
                                  want["ring_3"])


@pytest.mark.parametrize("kind", ["int8", "exact"])
def test_hierarchical_psum_on_a_2x2_mesh(ranks, kind):
    got, want, inp = ranks
    key = "hier" if kind == "int8" else "hier_exact"
    for r in range(WORLD):
        assert tuple(got[r]["coord"]) == (r // 2, r % 2)
        assert got[r][key].tobytes() == want[key][r].tobytes()
        if kind == "int8":
            assert np.array_equal(got[r]["hier_sharded"], want["hier"])
    if kind == "int8":          # the reference test's bound, as a check
        err = np.abs(got[0]["hier"] - inp["hier_x"].sum(0))
        assert err.max() < 8 * np.abs(inp["hier_x"].sum(0)).max() / 127


@pytest.mark.parametrize("leaf", ["w", "b", "e", "r"])
def test_rescale_tree_shards_as_named_sharding(ranks, leaf):
    got, want, _ = ranks
    for r in range(WORLD):
        i, j = got[r]["coord"]
        assert np.array_equal(got[r][f"shard_{leaf}"],
                              want[f"shard_{leaf}_{i}{j}"])


def test_make_mesh_from_plan_on_four_gloo_ranks(ranks):
    got, _, _ = ranks
    llama = get_arch("llama3.2-3b")
    for n in (3, 4):
        plan = tdist.plan_mesh(n, llama)
        assert dataclasses.asdict(plan) == dataclasses.asdict(
            jplan(n, jget_arch("llama3.2-3b")))
    for r in range(WORLD):
        assert tuple(got[r]["plan4"]) == tdist.plan_mesh(4, llama).mesh_shape
        assert tuple(got[r]["plan3"]) == (3, 1)
        assert tuple(got[r]["plan3_coord"]) == ((r, 0) if r < 3 else (-1, -1))


# ------------------------------------------------------------------ imports
_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch.distributed as d
import repro_torch.distributed.compression, repro_torch.distributed.overlap
import repro_torch.distributed.elastic, repro_torch.kernels.compress
import repro_torch.sharding, repro_torch.sharding.rules
import repro_torch.train.loop
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print(",".join(sorted(d.__all__)))
"""


def test_new_modules_import_neither_jax_nor_repro():
    import repro.distributed as jd
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    # the reference's exports, less its shard_map shim
    want = set(jd.__all__) - {"shard_map", "HAS_NATIVE_SHARD_MAP"}
    assert set(res.stdout.strip().split(",")) == want


@pytest.mark.parametrize("module,above", [
    ("repro_torch.kernels.compress", "repro_torch.distributed"),
    ("repro_torch.distributed.compression", "repro_torch.train"),
    ("repro_torch.distributed", "repro_torch.train"),
    ("repro_torch.train.loop", None),
])
def test_layers_import_only_what_is_below_them(module, above):
    """The kernel layer does not import the distributed layer, nor the
    distributed layer the training loop (``make_accum_train_step`` reaches
    the loop's step wrapper only when called); each imports on its own in a
    fresh process."""
    code = (f"import sys, {module}\n"
            f"above = {above!r}\n"
            "assert above is None or not any(\n"
            "    m == above or m.startswith(above + '.') for m in sys.modules"
            "), sorted(m for m in sys.modules if m.startswith(str(above)))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_kernel_modules_import_no_layer_above_them():
    """No import in ``repro_torch/kernels`` (inside functions too) reaches
    the distributed layer, the sharding rules or the training loop: a
    kernel's plain version lives beside its kernel."""
    import ast
    above = ("distributed", "sharding", "train")
    for path in sorted((REPO / "src" / "repro_torch" / "kernels").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [a.name for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            for name in names:
                parts = name.split(".")
                assert not any(p in above for p in parts), (path.name, name)
