"""The sharded train step: tensor parallelism over "model", ZeRO-1 moments
over "data" and FSDP, as ``sharding/rules.py`` lays them out, on four
``gloo`` ranks on the CPU, against the JAX package.

* The reference's sharded step: its model's ``jax.value_and_grad(loss)``
  under ``jax.jit`` on a CPU mesh of the same shape (four host devices,
  ``AxisType.Auto`` axes: jax 0.9's default ``Explicit`` axes stop its
  embedding gather), the parameters placed by ``repro.sharding.
  param_specs`` and the batch by ``batch_specs``, run in subprocesses with
  no file of ``src/repro/`` edited; and the same call unsharded.  The port
  runs ``train.loop.loss_and_grads`` on a model built under each
  ``("data", "model")`` mesh, (2, 2) and (1, 4) (``params_from_reference``
  cuts the reference's init to each rank's shards), the same numpy inputs:
  llama3.2-3b, falcon-mamba-7b at 4 layers, qwen2-moe-a2.7b and jamba at
  smoke width, jamba and qwen3-moe-235b-a22b with ``fsdp=True``.  The loss
  and every parameter's gradient, made whole (``ModelShards.whole``), within
  ``TOL`` x max(1, max|g|) of both (readings of the reference's sharded
  gradients against its unsharded ones: <= 1.6e-6).
* Each rank holds the spec's shapes (1/mm of a tensor split over "model",
  1/dd over "data"), Mamba's ``in_proj`` as ``[xin_r | z_r]``, its moments
  as ``opt_specs`` lays them out (a stacked layer's on its owning data
  rank only).
* One ``Trainer`` step under each mesh matches the one-rank ``Trainer``'s
  step: loss and global norm within ``TOL``, and each parameter's change
  within ``DELTA_TOL`` (relative L2) of the one-rank step's change, at peak
  lr ``PEAK_LR`` so that the first step moves each element by about 1e-2
  (Adam's first update is about lr sign(g); an element whose gradient is
  near zero moves by less, and there the two steps' rounding differs);
  every copy of a parameter is bit-equal on the ranks that hold it.
* A checkpoint written on (2, 2) restores on (1, 4) and on one rank, bit
  for bit.
* Planted faults miss the tolerance: (a) a shard's gradient summed over
  "model"; (b) a row-parallel output not summed; (c) every tensor counted
  in the norm on every rank; and in ZeRO-1's update on (2, 2): no
  parameter updated, the wrong data rank updating an owned layer, the cut
  tensors' slices gathered out of order.
* ``cuda`` tests (no JAX): AdamW's norm across ranks against the one-rank
  norm of the whole tree and bit-equal to the one-call kernels at one
  rank; the flash kernels and the scan, forward and backward, at the local
  shapes of the four-card meshes, against their plain versions.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_seq_parallel import REPO, _flat, _wait

WORLD = 4
B, S = 4, 16
# key: (arch, layers (None: the smoke depth), fsdp)
CASES = {"llama": ("llama3.2-3b", None, False),
         "falcon": ("falcon-mamba-7b", 4, False),
         "qwen2moe": ("qwen2-moe-a2.7b", None, False),
         "jamba": ("jamba-1.5-large-398b", None, False),
         "jamba_fsdp": ("jamba-1.5-large-398b", None, True),
         "qwen3moe_fsdp": ("qwen3-moe-235b-a22b", None, True)}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}        # (data, model)
POD_MESHES = {"2x1x2": (2, 1, 2), "2x2x1": (2, 2, 1)}   # (pod, data, model)
TOL = 1e-4                                     # x max(1, max|g|)
TRAINED = ("falcon", "qwen2moe", "jamba_fsdp")
PEAK_LR = 1.0              # the first step's lr: PEAK_LR / 100 (warm-up)
DELTA_TOL = 2e-2           # a change's relative L2 (readings <= 5.4e-3)
ZERO1_FAULTS = ("no_update", "owner_wrong", "slice_wrong")
FAULTS = ("model_summed", "row_unsummed", "norm_every_rank") + ZERO1_FAULTS


def config(module, key):
    arch, layers, fsdp = CASES[key]
    cfg = module.smoke_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, fsdp=fsdp)


def _batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


_RANK = r"""
import dataclasses, datetime, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, init, out, root = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
import repro_torch.configs.base as base
from repro_torch.checkpoint import ckpt
from repro_torch.launch.mesh import make_host_mesh, make_pod_mesh
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_reference
from repro_torch.sharding import rules
from repro_torch.train import loop

CASES, MESHES, TRAINED = %(cases)r, %(meshes)r, %(trained)r
POD_MESHES = %(pod_meshes)r
ZERO1_FAULTS, LR = %(zero1)r, %(lr)r
B, S = %(b)d, %(s)d


def config(key):
    arch, layers, fsdp = CASES[key]
    cfg = base.smoke_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, fsdp=fsdp)


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


def grads(cfg, model, batch):
    for p in model.parameters():
        p.grad = None
    loss, _ = loop.loss_and_grads(cfg, model, batch)
    g = {n: model.shards.whole(n, p.grad).numpy().copy()
         for n, p in model.named_parameters() if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return loss, g


res = {}
meshes = {k: make_host_mesh(*v, device_type="cpu") for k, v in MESHES.items()}
meshes.update({k: make_pod_mesh(*v, device_type="cpu")
               for k, v in POD_MESHES.items()})
for key in CASES:
    cfg = config(key)
    tree = unflat(dict(np.load(f"{root}/params_{key}.npz")))
    data = dict(np.load(f"{root}/batch_{key}.npz"))
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    for mk in MESHES:
        mesh = meshes[mk]
        with L.ambient_mesh(mesh):
            model = params_from_reference(tree, cfg, "cpu").requires_grad_(
                True)
            loss, g = grads(cfg, model, batch)
            whole = {n: model.shards.whole(n, p.detach()).numpy()
                     for n, p in model.named_parameters()}
        tag = f"{key}_{mk}"
        res["loss_" + tag] = loss.numpy()
        for n, a in g.items():
            res[f"g_{tag}__{n}"] = a
        # the rank's shapes against the spec's, and its in_proj halves
        shards = model.shards
        for n, p in model.named_parameters():
            want = rules.shard(torch.from_numpy(whole[n]), shards.params[n],
                               shards.coords, shards.sizes)
            res[f"shape_{tag}__{n}"] = np.array(
                [list(p.shape), list(want.shape), list(whole[n].shape)])
            res[f"part_{tag}__{n}"] = np.array(torch.equal(p.detach(), want))
        res["split_" + tag] = np.array(shards.split)

# planted faults: falcon-mamba (row-parallel x_proj, out_proj, the vocab
# tables) under (1, 4)
key, mesh = "falcon", meshes["1x4"]
cfg = config(key)
tree = unflat(dict(np.load(f"{root}/params_{key}.npz")))
batch = {k: torch.from_numpy(v)
         for k, v in np.load(f"{root}/batch_{key}.npz").items()}
real_reduce, real_model_reduce = loop.MeshStep.reduce_grads, L.reduce_model


def model_summed(self, params):
    from repro_torch.distributed import comm
    with torch.no_grad():
        for p in params.values():
            if p.grad is not None:
                g = p.grad
                for group in self.groups:
                    g = comm.all_reduce(g, group)
                p.grad = g


for fault in ("model_summed", "row_unsummed"):
    if fault == "model_summed":
        loop.MeshStep.reduce_grads = model_summed
    else:
        L.reduce_model = lambda y, group: y
    try:
        with L.ambient_mesh(mesh):
            model = params_from_reference(tree, cfg, "cpu").requires_grad_(
                True)
            _, g = grads(cfg, model, batch)
    finally:
        loop.MeshStep.reduce_grads = real_reduce
        L.reduce_model = real_model_reduce
    for n, a in g.items():
        res[f"fault_{fault}__{n}"] = a

# one Trainer step a mesh against the one-rank Trainer's; the norm fault
# and ZeRO-1's faults
import contextlib
from repro_torch.distributed import comm
from repro_torch.kernels import adamw as kadamw
real_counted, real_owns = rules.ModelShards.counted, rules.ModelShards.owns
real_step, real_gather = kadamw.adamw_step, comm.all_gather


def no_update(*a, counted=None, sum_norm=None, **kw):
    return kadamw.global_norm_ref(a[1], counted, sum_norm, a[5].device)


def out_of_order(x, group, dim=0):
    parts = real_gather(x, group, dim).chunk(comm.size(group), dim)
    return torch.cat(parts[::-1], dim)


def then_misplace(*a, **kw):
    # the update right, then the cut tensors' slices gathered reversed
    out = real_step(*a, **kw)
    comm.all_gather = out_of_order
    return out


@contextlib.contextmanager
def planted(name):
    if name == "norm_every_rank":
        rules.ModelShards.counted = lambda self, n: True
    elif name == "no_update":
        kadamw.adamw_step = no_update
    elif name == "owner_wrong":           # the other data rank of two
        rules.ModelShards.owns = lambda self, n: self.moments[n].owner in (
            None, 1 - self.coords["data"])
    elif name == "slice_wrong":
        kadamw.adamw_step = then_misplace
    try:
        yield
    finally:
        rules.ModelShards.counted, rules.ModelShards.owns = (real_counted,
                                                             real_owns)
        kadamw.adamw_step, comm.all_gather = real_step, real_gather


for key in TRAINED:
    cfg = config(key)
    one = loop.Trainer(cfg, batch=B, seq_len=S, device="cpu", seed=0,
                       peak_lr=LR)
    one_state = one.init_state()
    for n, p in one_state.model.named_parameters():
        res[f"init_{key}__{n}"] = p.detach().numpy().copy()
    one_state = one.run(1, state=one_state)
    res[f"one_loss_{key}"] = np.array(one.history + one.grad_norms)
    for n, p in one_state.model.named_parameters():
        res[f"one_{key}__{n}"] = p.detach().numpy().copy()
    runs = [(mk, mk) for mk in (*MESHES, *POD_MESHES)]
    if key == "falcon":
        runs.append(("norm_every_rank", "1x4"))
        runs += [(f, "2x2") for f in ZERO1_FAULTS]
    for tag_m, mk in runs:
        tr = loop.Trainer(cfg, batch=B, seq_len=S, device="cpu", seed=0,
                          peak_lr=LR)
        with planted(tag_m), L.ambient_mesh(meshes[mk]):
            state = tr.run(1)
        with L.ambient_mesh(meshes[mk]):
            whole = {n: state.model.shards.whole(n, p.detach()).numpy()
                     for n, p in state.model.named_parameters()}
            if key == "falcon" and tag_m == "2x2":
                path = ckpt.save_checkpoint(f"{root}/ckpt", 1, state)
                # a rank that does not write holds no whole tensor
                res["ckpt_kept"] = np.array(
                    ckpt._arrays(state, keep=False) is None)
        tag = f"{key}_{tag_m}"
        res["trained_loss_" + tag] = np.array(tr.history + tr.grad_norms)
        for n, p in state.model.named_parameters():
            res[f"trained_{tag}__{n}"] = whole[n]
            res[f"local_{tag}__{n}"] = p.detach().numpy().copy()
            spec = state.model.shards.params[n].spec
            res[f"axes_{tag}__{n}"] = np.array(
                [a in rules.spec_axes(spec) for a in ("data", "model", "pod")])
        for n, m in state.opt.mu.items():
            res[f"mu_{tag}__{n}"] = np.array(list(m.shape) or [-1])
        res["tcoords_" + tag] = np.array(
            [state.model.shards.coords.get(a, 0)
             for a in ("data", "model", "pod")])

# the checkpoint of (2, 2) restored on (1, 4) and on one rank
dist.barrier()
cfg = config("falcon")
with L.ambient_mesh(meshes["1x4"]):
    tr = loop.Trainer(cfg, batch=B, seq_len=S, device="cpu", seed=7)
    restored, _ = ckpt.restore_checkpoint(path, tr.init_state())
    arrays = ckpt.state_arrays(restored)
saved = np.load(path)
same = lambda a, b: np.array_equal(np.atleast_1d(a).view(np.uint8),
                                   np.atleast_1d(b).view(np.uint8))
res["ckpt_1x4"] = np.array(all(same(arrays[k], saved[k])
                               for k in saved.files if k != "__extra__"))
one = loop.Trainer(cfg, batch=B, seq_len=S, device="cpu", seed=7)
restored, _ = ckpt.restore_checkpoint(path, one.init_state())
arrays = ckpt.state_arrays(restored)
res["ckpt_one"] = np.array(all(same(arrays[k], saved[k])
                               for k in saved.files if k != "__extra__"))
np.savez(out, **res)
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

key, root, runs = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
CASES, MESHES = %(cases)r, %(meshes)r
arch, layers, fsdp = CASES[key]
over = dict(fsdp=fsdp, remat=False)    # remat: the same function, once
if layers is not None:
    over["n_layers"] = layers
cfg = dataclasses.replace(smoke_config(arch), **over)
tcfg = dataclasses.replace(tsmoke(arch), **over)
model = build_model(cfg)
params = model.init(jax.random.key(0))
batch = {k: jnp.asarray(v)
         for k, v in np.load(f"{root}/batch_{key}.npz").items()}
fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
want = {}


def keep(tag, loss, g):
    want["loss_" + tag] = np.asarray(loss)
    port = params_from_reference(jax.tree.map(np.asarray, g), tcfg, "cpu")
    for n, t in port.named_parameters():
        want[f"g_{tag}__{n}"] = t.detach().numpy()


if "one" in runs:
    keep(f"{key}_one", *fn(params, batch))
for mk in runs[runs[0] == "one":]:
    mesh = jax.make_mesh(MESHES[mk], ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    put = lambda t, specs: jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), t, specs,
        is_leaf=lambda x: hasattr(x, "shape"))
    with mesh:
        keep(f"{key}_{mk}", *fn(put(params, sh.param_specs(cfg, params, mesh)),
                                put(batch, sh.batch_specs(cfg, batch, mesh))))
np.savez(f"{root}/want_{key}_{'_'.join(runs)}.npz", **want)
"""

# the reference's processes (case, its runs): jamba's 8 Mamba-heavy layers
# take the longest to compile, so its runs go apart
REF_SPLIT = [(key, runs) for key in CASES
             for runs in ((("one",), ("2x2",), ("1x4",))
                          if key.startswith("jamba")
                          else (("one",) + tuple(MESHES),))]


def _spawn(script, argv_list, env):
    return [subprocess.Popen([sys.executable, "-c", script, *argv], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for argv in argv_list]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results (one spawn of four gloo ranks) and the
    reference's (a JAX process a case, started first), all run at once."""
    import jax
    from repro.configs import base as jbase
    from repro.models import build_model
    from repro_torch.configs import base as tbase
    root = tmp_path_factory.mktemp("shardtrain")
    fmt = dict(cases=CASES, meshes=MESHES, pod_meshes=POD_MESHES,
               trained=TRAINED, b=B, s=S, zero1=ZERO1_FAULTS, lr=PEAK_LR)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    for key in CASES:
        np.savez(root / f"batch_{key}.npz", **_batch(config(tbase, key)))
    procs = _spawn(_REF % fmt, [[key, str(root), ",".join(runs), ""]
                                for key, runs in REF_SPLIT], env)
    try:
        for key in CASES:
            cfg = dataclasses.replace(config(jbase, key), remat=False)
            tree = jax.tree.map(np.asarray,
                                build_model(cfg).init(jax.random.key(0)))
            np.savez(root / f"params_{key}.npz", **_flat(tree))
    finally:
        procs += _spawn(_RANK % fmt, [
            [str(r), str(WORLD), str(root / "rendezvous"),
             str(root / f"rank{r}.npz"), str(root)] for r in range(WORLD)],
            env)
        _wait(procs)
    got = [dict(np.load(root / f"rank{r}.npz")) for r in range(WORLD)]
    want = {}
    for key, runs in REF_SPLIT:
        want.update(np.load(root / f"want_{key}_{'_'.join(runs)}.npz"))
    return got, want


def _of(res, prefix):
    return {k[len(prefix) + 2:]: v for k, v in res.items()
            if k.startswith(prefix + "__")}


def _close(got, want):
    return np.allclose(got, want, rtol=TOL,
                       atol=TOL * max(1.0, float(np.abs(want).max())))


def _misses(got, want):
    """The names whose tensor misses the tolerance."""
    return [n for n, w in want.items()
            if not _close(got.get(n, np.zeros_like(w)), w)]


def _change_misses(got, want, init):
    """{name: relative L2 of the change from ``init`` against ``want``'s
    change} where it misses ``DELTA_TOL``."""
    out = {}
    for n, w in want.items():
        d = w - init[n]
        rel = float(np.linalg.norm(got[n] - init[n] - d)
                    / max(float(np.linalg.norm(d)), 1e-30))
        if rel > DELTA_TOL:
            out[n] = rel
    return out


@pytest.mark.parametrize("key", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("against", ["sharded", "unsharded"])
def test_sharded_loss_and_grads_match_reference(ranks, key, mesh, against):
    got, want = ranks
    tag = f"{key}_{mesh}"
    wtag = f"{key}_{mesh if against == 'sharded' else 'one'}"
    wg = _of(want, "g_" + wtag)
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["loss_" + tag], want["loss_" + wtag],
                                   rtol=TOL, atol=TOL)
        g = _of(got[r], "g_" + tag)
        assert set(g) == set(wg)
        assert _misses(g, wg) == [], (tag, r)


@pytest.mark.parametrize("key", list(CASES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_the_specs_shards(ranks, key, mesh):
    """The rank's shapes are the spec's (1/mm over "model", 1/dd over
    "data"), its values its part of the whole; something is split."""
    got, _ = ranks
    tag = f"{key}_{mesh}"
    dd, mm = MESHES[mesh]
    for r in range(WORLD):
        assert bool(got[r]["split_" + tag])
        for n, (mine, spec, whole) in _of(got[r], "shape_" + tag).items():
            assert list(mine) == list(spec), (n, r)
            assert bool(got[r][f"part_{tag}__{n}"]), (n, r)
        shapes = _of(got[r], "shape_" + tag)
        # what splits where: the heads, d_ff, experts, channels, the vocab
        if key == "llama":
            assert shapes["layers.0.attn.wq"][0][1] * mm == \
                shapes["layers.0.attn.wq"][2][1]
            assert shapes["layers.0.mlp.down"][0][0] * mm == \
                shapes["layers.0.mlp.down"][2][0]
            assert shapes["embed"][0][0] * mm == shapes["embed"][2][0]
        if key == "qwen2moe":
            assert shapes["layers.0.moe.w_gate"][0][0] * mm == \
                shapes["layers.0.moe.w_gate"][2][0]
        if key == "falcon":
            assert shapes["layers.0.mamba.conv_w"][0][0] * mm == \
                shapes["layers.0.mamba.conv_w"][2][0]
        if key.endswith("fsdp"):
            name = "layers.0.mlp.gate" if key == "jamba_fsdp" else \
                "layers.0.attn.wq"
            assert shapes[name][0][0] * dd == shapes[name][2][0]


def test_in_proj_holds_both_halves_of_the_ranks_channels(ranks):
    """Mamba's in_proj (d, 2 Din) on model rank r of mm: columns [r k,
    (r+1) k) of xin and the same of z (k = Din / mm), not the flat split's
    r-th 2k columns."""
    got, _ = ranks
    for mesh, (dd, mm) in MESHES.items():
        tag = f"falcon_{mesh}"
        for r in range(WORLD):
            mine, _, whole = _of(got[r], "shape_" + tag)[
                "layers.0.mamba.in_proj"]
            assert mine[1] * mm == whole[1]
            assert bool(got[r][f"part_{tag}__layers.0.mamba.in_proj"])
    from repro_torch.sharding.rules import Placement, shard
    t = torch.arange(16)[None].expand(2, 16)
    parts = [shard(t, Placement((None, "model"), halves=True), {"model": r},
                   {"model": 4})[0].tolist() for r in range(4)]
    assert parts == [[0, 1, 8, 9], [2, 3, 10, 11], [4, 5, 12, 13],
                     [6, 7, 14, 15]]


@pytest.mark.parametrize("key", TRAINED)
@pytest.mark.parametrize("mesh", [*MESHES, *POD_MESHES])
def test_trainer_step_matches_the_one_rank_step(ranks, key, mesh):
    """One ``Trainer`` step a mesh against the one-rank step: the loss and
    the global norm (each element counted once, across pods too), and
    each parameter's change.  The pod meshes' gradients are summed over
    "data" then over "pod" (``optim.adamw._zero1_step``)."""
    got, _ = ranks
    tag = f"{key}_{mesh}"
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["trained_loss_" + tag],
                                   got[r][f"one_loss_{key}"], rtol=TOL,
                                   atol=TOL)
        assert _change_misses(_of(got[r], "trained_" + tag),
                              _of(got[r], "one_" + key),
                              _of(got[r], "init_" + key)) == {}


@pytest.mark.parametrize("key", TRAINED)
@pytest.mark.parametrize("mesh", [*MESHES, *POD_MESHES])
def test_every_copy_is_bit_equal_and_moments_are_zero1(ranks, key, mesh):
    """Ranks that hold the same part of a parameter (the same place on the
    axes its spec splits) hold the same bits, on every pod; a rank holds a
    stacked layer's moments only where it owns them (ZeRO-1 over "data",
    the same on every pod)."""
    got, _ = ranks
    tag = f"{key}_{mesh}"
    dd = MESHES[mesh][0] if mesh in MESHES else POD_MESHES[mesh][1]
    local = [_of(g, "local_" + tag) for g in got]
    coords = [g["tcoords_" + tag] for g in got]
    for n, axes in _of(got[0], "axes_" + tag).items():
        for r in range(1, WORLD):
            if all(coords[r][i] == coords[0][i] for i in range(3) if axes[i]):
                assert np.array_equal(local[r][n].view(np.uint8),
                                      local[0][n].view(np.uint8)), (n, r)
    if dd > 1 and key == "falcon":
        held = [[list(_of(g, "mu_" + tag)[f"layers.{i}.mamba.in_proj"])
                 != [0] for i in range(4)] for g in got]
        for r in range(WORLD):                 # layers 0-1 on data rank 0
            assert held[r] == [coords[r][0] == 0] * 2 + \
                [coords[r][0] == 1] * 2


def test_checkpoint_reshards_on_load(ranks):
    """Written on (2, 2); restored on (1, 4) and on one rank, each state
    written out again is the file, bit for bit.  A rank that does not
    write keeps no host copy."""
    got, _ = ranks
    for r in range(WORLD):
        assert bool(got[r]["ckpt_1x4"]) and bool(got[r]["ckpt_one"])
        assert bool(got[r]["ckpt_kept"])


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_miss_the_tolerance(ranks, fault):
    got, want = ranks
    if fault == "norm_every_rank":
        ok = got[0]["trained_loss_falcon_1x4"]
        bad = got[0]["trained_loss_falcon_norm_every_rank"]
        one = got[0]["one_loss_falcon"]          # [loss, global norm]
        assert _close(ok, one) and not _close(bad, one)
        return
    if fault in ZERO1_FAULTS:
        one, init = _of(got[0], "one_falcon"), _of(got[0], "init_falcon")
        assert _change_misses(_of(got[0], "trained_falcon_2x2"), one,
                              init) == {}
        missed = _change_misses(_of(got[0], "trained_falcon_" + fault), one,
                                init)
        # the layers' owned tensors, or the cut vocab tables
        assert "embed" in missed if fault == "slice_wrong" else \
            "layers.0.mamba.in_proj" in missed, missed
        return
    wg = _of(want, "g_falcon_1x4")
    assert _misses(_of(got[0], "g_falcon_1x4"), wg) == []
    assert _misses(_of(got[0], "fault_" + fault), wg)


_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch.sharding.rules, repro_torch.models, repro_torch.models.convert
import repro_torch.checkpoint.ckpt, repro_torch.optim.adamw
import repro_torch.kernels.adamw, repro_torch.train.loop
import repro_torch.launch.train_step_times, repro_torch.models.lm
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_touched_modules_import_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_train_step_times_baseline_under_torchrun(tmp_path):
    """``train_step_times --variant baseline --meshes 1x4,2x2`` under
    ``torchrun`` on four CPU ranks: falcon-mamba's smoke config sharded as
    the rules lay it out, at the variant's batch of 8; every rank of a mesh
    reports the same losses, and the first is the one-card step's (the same
    function), which a CPU always runs."""
    import json
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = tmp_path / "steps.json"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train_step_times",
         "--variant", "baseline", "--arch", "falcon-mamba-7b", "--meshes",
         "1x4,2x2", "--reduced", "--depth", "2", "--device", "cpu",
         "--seq-len", "16", "--steps", "2", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["variant"] == "baseline" and rec["arch"] == "falcon-mamba-7b"
    assert rec["batch"] == 8 and rec["layers"] == 2
    base = rec["one_card"]["loss"]
    for spec, (dd, mm) in MESHES.items():
        m = rec["meshes"][spec]
        assert (m["data"], m["model"]) == (dd, mm)
        for r in m["per_rank"]:
            assert r["loss"] == m["per_rank"][0]["loss"]
        np.testing.assert_allclose(m["per_rank"][0]["loss"], base,
                                   rtol=1e-5)


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _tree(dev, seed=0):
    """A mixed tree: bf16 parameters with f32 moments, an f32 parameter."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shapes = [(1000, 24), (4096,), (3, 77), (8192 * 3 + 5,)]
    ps, gs, ms, vs = [], [], [], []
    for i, sh in enumerate(shapes):
        dt = torch.float32 if i == 1 else torch.bfloat16
        ps.append(torch.randn(sh, generator=gen).to(dt).to(dev))
        gs.append((torch.randn(sh, generator=gen) * 0.1).to(dt).to(dev))
        ms.append((torch.randn(sh, generator=gen) * 0.01).to(dev))
        vs.append((torch.rand(sh, generator=gen) * 0.01).to(dev))
    return ps, gs, ms, vs


@pytest.mark.cuda
def test_adamw_norm_across_ranks_on_the_card(cuda_device):
    """Two "ranks" in one process: each updates half the tree, the norm's
    partials of the other half added by ``sum_norm``: the norm within f64
    rounding of the whole tree's (one call) and of the plain split, each
    update bit-equal to the plain version's; at one rank (``sum_norm``
    the identity, every tensor counted) bit-equal to the one-call
    kernels."""
    from repro_torch.kernels import adamw as K
    hyper = torch.tensor([1e-3, 0.1, 0.05], device=cuda_device)
    dec = [True, False, True, True]
    clone = lambda t: [x.clone() for x in t]
    whole = _tree(cuda_device)
    one = [clone(x) for x in whole]
    g1 = K.adamw_step(*one, dec, hyper)
    ident = [clone(x) for x in whole]
    g2 = K.adamw_step(*ident, dec, hyper, counted=[True] * 4,
                      sum_norm=lambda t: t)
    assert torch.equal(g1, g2)
    for a, b in zip(sum(one, []), sum(ident, [])):
        assert torch.equal(a, b)
    halves = ([0, 2], [1, 3])
    parts = []
    for h in halves:                       # each half's partials alone
        sub = [clone([x[i] for i in h]) for x in whole]
        K.adamw_step(*sub, [dec[i] for i in h], hyper,
                     sum_norm=lambda t: parts.append(t.clone()) or t)
    for k, h in enumerate(halves):
        sub = [clone([x[i] for i in h]) for x in whole]
        ref = [[t.cpu() for t in s] for s in sub]
        g = K.adamw_step(*sub, [dec[i] for i in h], hyper,
                         sum_norm=lambda t: parts[0] + parts[1])
        def others(t, h=h):             # the other half's squares
            t = t.clone()
            t[0] += sum(torch.sum(torch.square(whole[1][i].cpu().to(
                torch.float64))) for i in range(4) if i not in h)
            return t
        gr = K.global_norm_ref(ref[1], sum_norm=others)
        assert abs(float(g) - float(g1)) <= 1e-6 * float(g1)
        assert abs(float(gr) - float(g1)) <= 1e-6 * float(g1)
        # the plain update at the kernels' norm: every tensor bit-equal
        K.adamw_step_ref(*ref, [dec[i] for i in h], hyper.cpu(),
                         sum_norm=lambda t: g.cpu().double() ** 2)
        for a, b in zip(sum(sub, []), sum(ref, [])):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,dtype", [(12, 4, torch.bfloat16),
                                          (6, 2, torch.bfloat16),
                                          (8, 8, torch.float32),
                                          (4, 4, torch.float32)])
def test_flash_at_the_local_heads(cuda_device, hq, hkv, dtype):
    """The flash kernels, forward with lse and backward, at a model rank's
    heads (llama's 24/8 and qwen2-moe's 16/16 over 2 and 4 model ranks),
    causal, D 128, against their plain versions, with
    ``test_torch_kernels_cuda``'s bounds."""
    from test_torch_kernels_cuda import _attn_close, _bshd, _grad_close
    from repro_torch.kernels import flash_attn, ref
    rng = np.random.default_rng(hq * 10 + hkv)
    b, s, d = 2, 256, 128
    q = _bshd(rng, b, s, hq, d, cuda_device, dtype)
    k = _bshd(rng, b, s, hkv, d, cuda_device, dtype)
    v = _bshd(rng, b, s, hkv, d, cuda_device, dtype)
    do = _bshd(rng, b, s, hq, d, cuda_device, dtype)
    o, lse = flash_attn.flash_attention_fwd(q, k, v, True)
    want_o, want_lse = ref.attention_lse_ref(q, k, v, True)
    _attn_close(o, want_o, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5 * max(
        1.0, want_lse.abs().max().item()))
    got = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, True)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, True)
    for g, w in zip(got, want):
        _grad_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("din", [4096, 2048])
def test_scan_at_the_local_channels(cuda_device, din):
    """The selective scan, forward and backward, at a model rank's Mamba
    channels (falcon-mamba's Din 8192 over 2 and 4 model ranks), bf16, B/C
    strided, against the plain versions, with ``test_torch_kernels_cuda``'s
    bounds; the launch plan keeps its working warps at the card's
    target."""
    from test_torch_kernels_cuda import (_randn, _scan_args, _scan_close,
                                         _scan_grad_close)
    from repro_torch.kernels import mamba_scan, ref
    rng = np.random.default_rng(din)
    b, l, n = 4, 512, 16
    args = _scan_args(rng, b, l, din, n, cuda_device, torch.bfloat16,
                      strided=True)
    plan = mamba_scan.scan_plan(b, l, din, n, torch.bfloat16)
    assert plan.working_warps >= min(mamba_scan.TARGET_WARPS,
                                     b * din * mamba_scan.GROUP // 8 // 32)
    y, h = mamba_scan.selective_scan(*args, return_state=True)
    wy, wh = ref.selective_scan_ref(*args, return_state=True)
    _scan_close(y, wy)
    _scan_close(h, wh)
    dy = _randn(rng, (b, l, din), cuda_device)
    got = mamba_scan.selective_scan_bwd(*args, dy)
    want = ref.selective_scan_bwd_ref(*args, dy)
    for g, w in zip(got, want):
        _scan_grad_close(g, w, torch.bfloat16)
