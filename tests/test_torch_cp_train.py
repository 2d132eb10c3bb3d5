"""Context parallelism trains: the loss, every parameter's gradient and a
``Trainer`` step under ``attn_shard="seq"`` on four ``gloo`` ranks, against
the JAX package, on the CPU.

* The reference differentiates its own sequence-parallel code in one
  process: ``jax.value_and_grad`` of its model's ``loss`` with
  ``repro.models.layers._mesh_axis`` patched to give the model axis mm
  (``static_unroll=True``: its ``lax.map`` path misorders rows,
  ``test_torch_seq_parallel.test_reference_lax_map_misorders_rows``).  The
  port runs ``train.loop``'s step body (each data rank's rows of the batch,
  every rank's loss scaled by 1 / (dd mm), the gradients summed over the
  mesh) on four ranks spawned once (``test_torch_seq_parallel``'s harness:
  a ``file://`` rendezvous, 60 s group timeout, late ranks killed and
  failed) under ``("data", "model")`` meshes of (2, 2), the batch split
  over "data", and (1, 4): llama3.2-3b and qwen2-moe-a2.7b smoke at 4
  layers, jamba smoke at its own depth, every ``causal_bound`` x
  ``seq_residual``, the reference's init carried across by
  ``models/convert.py``, the same numpy inputs.  Loss and every gradient
  within rtol = atol = 1e-4 x max(1, max|g|) (readings of the reference's
  own patched gradients against its unsharded ones: ~3e-7), on every rank.
* One ``Trainer`` step under each mesh leaves the parameters bit-equal on
  every rank; ``comm.reduce_scatter`` and its backward; planted faults (a gather whose backward keeps its own slice
  instead of reduce-scattering, a loss left unscaled, the striped
  backward given stride 1) miss the tolerance; the accumulated step under
  a mesh raises; a step across ranks is not captured.
* The plain striped backward (``ref.attention_bwd_ref`` with
  ``q_stride``) against autograd of ``ref.attention_ref`` and, rank by
  rank, against ``jax.vjp`` of the reference's ``_seq_parallel_attention``.
* ``cuda`` tests (no JAX): the backward kernels at ``q_stride`` 2, 4, 8, D
  64/128/256, bf16 and f32, against the plain backward; stride 1 equal to
  the call without it.
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
B, S = 2, 16
MODELS = {"llama3.2-3b": 4, "qwen2-moe-a2.7b": 4,
          "jamba-1.5-large-398b": None}        # None: the smoke depth
VARIANTS = [(cb, sr) for cb in (False, True) for sr in (True, False)]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}        # (data, model)
TOL = 1e-4                                     # x max(1, max|g|)
TRAINED = [("llama3.2-3b", True, True), ("qwen2-moe-a2.7b", False, True)]
FAULTS = ("gather_slices", "loss_unscaled", "stride_one")


def _ref_tree(name, layers):
    import jax
    from repro.configs.base import smoke_config
    from repro.models import build_model
    cfg = smoke_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, jax.tree.map(np.asarray,
                             build_model(cfg).init(jax.random.key(0)))


def _batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    return {"tokens": tokens, "labels": rng.integers(0, cfg.vocab_size,
                                                     (B, S))}


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
from repro_torch.configs.base import smoke_config
from repro_torch.distributed import comm
from repro_torch.kernels import flash_attn
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_reference
from repro_torch.train import loop

MODELS, VARIANTS, MESHES = %(models)r, %(variants)r, %(meshes)r
TRAINED, B, S = %(trained)r, %(b)d, %(s)d


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


def config(name, cb, sr):
    cfg = smoke_config(name)
    if MODELS[name] is not None:
        cfg = dataclasses.replace(cfg, n_layers=MODELS[name])
    return dataclasses.replace(cfg, attn_shard="seq", causal_bound=cb,
                               seq_residual=sr)


def model_of(name, cfg):
    tree = unflat(dict(np.load(f"{root}/params_{name}.npz")))
    return params_from_reference(tree, cfg, "cpu").requires_grad_(True)


def grads(cfg, model, batch):
    for p in model.parameters():
        p.grad = None
    loss, met = loop.loss_and_grads(cfg, model, batch)
    g = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
         if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return loss, met, g


res = {}
meshes = {k: make_host_mesh(*v, device_type="cpu") for k, v in MESHES.items()}
for name in MODELS:
    data = dict(np.load(f"{root}/batch_{name}.npz"))
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    for mk, mesh in meshes.items():
        for cb, sr in VARIANTS:
            cfg = config(name, cb, sr)
            model = model_of(name, cfg)
            with L.ambient_mesh(mesh):
                loss, met, g = grads(cfg, model, batch)
            tag = f"{name}_{mk}_{int(cb)}{int(sr)}"
            res["loss_" + tag] = loss.numpy()
            res["aux_" + tag] = met["aux"].numpy()
            for n, a in g.items():
                res[f"g_{tag}__{n}"] = a

# planted faults, llama under (1, 4), striped and blocked
name, mesh = "llama3.2-3b", meshes["1x4"]
data = dict(np.load(f"{root}/batch_{name}.npz"))
batch = {k: torch.from_numpy(v) for k, v in data.items()}
cfg = config(name, True, True)


def gather_slices(ctx, g):
    n, r = comm.size(ctx.group), comm.rank(ctx.group)
    return g.chunk(n, ctx.dim)[r].contiguous(), None, None


def unscaled():
    return real_step()._replace(ranks=1)


def stride_one(q, k, v, o, lse, do, causal=True, q_stride=1):
    return real_bwd(q, k, v, o, lse, do, causal)


real_gather_bwd = comm._AllGather.backward
real_step, real_bwd = loop.mesh_step, flash_attn.attention_bwd_ref
for fault in %(faults)r:
    model = model_of(name, cfg)
    if fault == "gather_slices":
        comm._AllGather.backward = staticmethod(gather_slices)
    elif fault == "loss_unscaled":
        loop.mesh_step = unscaled
    else:
        flash_attn.attention_bwd_ref = stride_one
    try:
        with L.ambient_mesh(mesh):
            _, _, g = grads(cfg, model, batch)
    finally:
        comm._AllGather.backward = real_gather_bwd
        loop.mesh_step, flash_attn.attention_bwd_ref = real_step, real_bwd
    for n, a in g.items():
        res[f"fault_{fault}__{n}"] = a

# one Trainer step a mesh: the parameters on every rank
for name, cb, sr in TRAINED:
    cfg = config(name, cb, sr)
    for mk, mesh in meshes.items():
        tr = loop.Trainer(cfg, batch=B, seq_len=S, device="cpu", seed=0)
        with L.ambient_mesh(mesh):
            state = tr.run(1)
        tag = f"{name}_{mk}"
        res["trained_loss_" + tag] = np.array(tr.history)
        for n, p in state.model.named_parameters():
            res[f"trained_{tag}__{n}"] = p.detach().numpy().copy()

# reduce_scatter over the (1, 4) mesh's model group, and its backward
group = meshes["1x4"].get_group("model")
x = (torch.arange(8, dtype=torch.float32) * (rank + 1)).requires_grad_(True)
y = comm.reduce_scatter(x, group)
y.backward(torch.full((2,), float(rank + 1)))
res["rs_y"], res["rs_gx"] = y.detach().numpy(), x.grad.numpy()

# the accumulated step under a mesh raises
acc = dataclasses.replace(config("llama3.2-3b", True, True), grad_accum=2)
tr = loop.Trainer(acc, batch=B, seq_len=S, device="cpu", seed=0)
try:
    with L.ambient_mesh(meshes["2x2"]):
        tr.run(1)
    res["accum_refused"] = np.array(False)
except NotImplementedError as e:
    res["accum_refused"] = np.array("ROADMAP" in str(e))
np.savez(out, **res)
dist.destroy_process_group()
"""


_REF = r"""
import dataclasses, sys
import jax
import jax.numpy as jnp
import numpy as np
import repro.models.layers as JL
from repro.configs.base import smoke_config
from repro.models import build_model
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.models.convert import params_from_reference

name, root, meshes = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
MODELS, VARIANTS, MESHES = %(models)r, %(variants)r, %(meshes)r
cfg, tcfg = smoke_config(name), tsmoke(name)
if MODELS[name] is not None:
    cfg = dataclasses.replace(cfg, n_layers=MODELS[name])
    tcfg = dataclasses.replace(tcfg, n_layers=MODELS[name])
params = build_model(cfg).init(jax.random.key(0))
batch = {k: jnp.asarray(v)
         for k, v in np.load(f"{root}/batch_{name}.npz").items()}
for mk in meshes:
    JL._mesh_axis = lambda n, mm=MESHES[mk][1]: mm if n == "model" else 1
    want = {}
    for cb, sr in VARIANTS:
        # remat off: the same function, its forward run once, not twice
        c = dataclasses.replace(cfg, attn_shard="seq", causal_bound=cb,
                                seq_residual=sr, static_unroll=True,
                                remat=False)
        model = build_model(c)
        (loss, met), g = jax.value_and_grad(lambda p: model.loss(p, batch),
                                            has_aux=True)(params)
        tag = f"{name}_{mk}_{int(cb)}{int(sr)}"
        want["loss_" + tag] = np.asarray(loss)
        want["aux_" + tag] = np.asarray(met["aux"])
        # the gradient tree laid out as the parameters it is the gradient of
        port = params_from_reference(jax.tree.map(np.asarray, g), tcfg,
                                     "cpu")
        for n, t in port.named_parameters():
            want[f"g_{tag}__{n}"] = t.detach().numpy()
    np.savez(f"{root}/want_{name}_{mk}.npz", **want)
"""


# the reference's processes (model, meshes): jamba's Mamba layers take the
# longest in JAX's op-by-op execution, so its meshes run apart
REF_SPLIT = [("llama3.2-3b", tuple(MESHES)), ("qwen2-moe-a2.7b", tuple(MESHES)),
             ("jamba-1.5-large-398b", ("2x2",)),
             ("jamba-1.5-large-398b", ("1x4",))]


def _spawn(script, argv_list, env):
    return [subprocess.Popen([sys.executable, "-c", script, *argv], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for argv in argv_list]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results (one spawn of four gloo ranks) and the
    reference's (its patched sequence-parallel code differentiated in JAX
    processes, :data:`REF_SPLIT`, started first), all run at once."""
    from repro_torch.configs.base import smoke_config
    root = tmp_path_factory.mktemp("cptrain")
    for name in MODELS:
        np.savez(root / f"batch_{name}.npz", **_batch(smoke_config(name)))
    fmt = dict(models=MODELS, variants=VARIANTS, meshes=MESHES,
               trained=TRAINED, b=B, s=S, faults=FAULTS)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = _spawn(_REF % fmt, [[name, str(root), ",".join(meshes), ""]
                                for name, meshes in REF_SPLIT], env)
    try:
        for name, layers in MODELS.items():
            _, tree = _ref_tree(name, layers)
            np.savez(root / f"params_{name}.npz", **_flat(tree))
    finally:
        procs += _spawn(_RANK % fmt, [
            [str(r), str(WORLD), str(root / "rendezvous"),
             str(root / f"rank{r}.npz"), str(root)] for r in range(WORLD)],
            env)
        _wait(procs)
    got = [dict(np.load(root / f"rank{r}.npz")) for r in range(WORLD)]
    want = {}
    for name in MODELS:
        for mk in MESHES:
            want.update(np.load(root / f"want_{name}_{mk}.npz"))
    return got, want


def _grads_of(res, prefix):
    return {k[len(prefix) + 2:]: v for k, v in res.items()
            if k.startswith(prefix + "__")}


def _misses(got, want):
    """The parameters whose gradient misses the tolerance."""
    return [n for n, w in want.items()
            if not np.allclose(got.get(n, np.zeros_like(w)), w, rtol=TOL,
                               atol=TOL * max(1.0, np.abs(w).max()))]


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cb,sr", VARIANTS)
def test_cp_loss_and_grads_match_reference(ranks, name, mesh, cb, sr):
    got, want = ranks
    tag = f"{name}_{mesh}_{int(cb)}{int(sr)}"
    wg = _grads_of(want, "g_" + tag)
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["loss_" + tag], want["loss_" + tag],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[r]["aux_" + tag], want["aux_" + tag],
                                   rtol=TOL, atol=TOL)
        g = _grads_of(got[r], "g_" + tag)
        assert set(g) == set(wg)
        for n, w in wg.items():
            np.testing.assert_allclose(
                g[n], w, rtol=TOL, atol=TOL * max(1.0, np.abs(w).max()),
                err_msg=f"{tag} {n} rank {r}")


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_miss_the_tolerance(ranks, fault):
    got, want = ranks
    wg = _grads_of(want, "g_llama3.2-3b_1x4_11")
    assert _misses(_grads_of(got[0], "g_llama3.2-3b_1x4_11"), wg) == []
    assert _misses(_grads_of(got[0], "fault_" + fault), wg)


@pytest.mark.parametrize("name", [t[0] for t in TRAINED])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_trainer_step_leaves_parameters_equal_on_every_rank(ranks, name,
                                                            mesh):
    got, _ = ranks
    tag = f"{name}_{mesh}"
    mine = _grads_of(got[0], "trained_" + tag)
    assert mine and np.isfinite(got[0]["trained_loss_" + tag]).all()
    for r in range(1, WORLD):
        theirs = _grads_of(got[r], "trained_" + tag)
        assert set(theirs) == set(mine)
        for n, a in mine.items():
            assert np.array_equal(a, theirs[n]), (tag, n, r)
        assert np.array_equal(got[r]["trained_loss_" + tag],
                              got[0]["trained_loss_" + tag])


def test_reduce_scatter_and_its_backward(ranks):
    """Rank r of four holds (r + 1) arange(8): it gets part r of the sum,
    10 arange(8)[2r:2r + 2]; its backward is the all-gather of every
    rank's gradient (rank r's: r + 1)."""
    got, _ = ranks
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r]["rs_y"],
                                      10 * np.arange(8)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got[r]["rs_gx"],
                                      np.repeat(np.arange(1, 5), 2))


def test_accumulated_step_under_a_mesh_raises(ranks):
    got, _ = ranks
    assert all(bool(g["accum_refused"]) for g in got)


def test_step_across_ranks_is_not_captured():
    from repro_torch.capture import resolve_compile
    cuda = torch.device("cuda", 0)
    assert resolve_compile("auto", cuda, 4) is False
    assert resolve_compile(False, cuda, 2) is False
    assert resolve_compile("auto", cuda) is True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        resolve_compile(True, cuda, 2)


def test_train_step_times_under_torchrun(tmp_path):
    """``python -m repro_torch.launch.train_step_times --meshes 1x4,2x2``
    under ``torchrun`` on four CPU ranks, with the one-card baseline: one
    JSON record, every rank's steps, the same losses on every rank of a
    mesh and the baseline's first loss (the same function)."""
    import json
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = tmp_path / "steps.json"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train_step_times",
         "--meshes", "1x4,2x2", "--reduced", "--depth", "2", "--device",
         "cpu", "--seq-len", "16", "--steps", "2", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == rec
    assert rec["backend"] == "gloo" and rec["world"] == 4
    assert rec["variant"] == "seq_causal" and rec["layers"] == 2
    base = rec["one_card"]["loss"]
    assert len(base) == 2 and rec["one_card"]["tokens_per_s"][1] > 0
    assert rec["one_card"]["replayed"] == [False, False] and rec["batch"] == 2
    for spec, (dd, mm) in MESHES.items():
        m = rec["meshes"][spec]
        assert (m["data"], m["model"]) == (dd, mm)
        assert len(m["per_rank"]) == 4
        for r in m["per_rank"]:
            assert r["loss"] == m["per_rank"][0]["loss"]
            assert len(r["step_ms"]) == 2 and r["tokens_per_s"][1] > 0
            assert r["replayed"] == [False, False]
        np.testing.assert_allclose(m["per_rank"][0]["loss"][0], base[0],
                                   rtol=1e-5)


# ------------------------------------------------- the plain striped backward
@pytest.mark.parametrize("q_stride,g", [(1, 0), (2, 0), (2, 1), (3, 2),
                                        (4, 3)])
def test_plain_striped_backward_matches_autograd(q_stride, g):
    """``attention_bwd_ref`` with ``q_stride`` (the FlashAttention-2
    formulas written out) against autograd of ``attention_ref``, both in
    f32, at 1e-5 x max(1, max|g|): GQA 2, the last row at the last key and
    the first ``g`` keys before the first row's position."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(q_stride * 10 + g)
    b, hq, hkv, sq, d = 2, 4, 2, 13, 16
    sk = (sq - 1) * q_stride + g + 1
    q, do = (torch.from_numpy(rng.standard_normal((b, hq, sq, d),
                                                  dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, hkv, sk, d),
                                                 dtype=np.float32))
            for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.attention_ref(*leaves, causal=True, q_stride=q_stride)
    want = torch.autograd.grad(out, leaves, do)
    o, lse = ref.attention_lse_ref(q, k, v, True, q_stride)
    got = ref.attention_bwd_ref(q, k, v, o, lse, do, True, q_stride)
    torch.testing.assert_close(o, out.detach(), rtol=1e-6, atol=1e-6)
    for a, w in zip(got, want):
        torch.testing.assert_close(
            a, w, rtol=1e-5, atol=1e-5 * max(1.0, w.abs().max().item()))


@pytest.mark.parametrize("mm", [2, 4])
@pytest.mark.parametrize("striped", [False, True])
def test_striped_backward_by_rank_matches_seq_parallel_attention(mm,
                                                                  striped):
    """Each rank's rows through ``flash_attention`` under autograd (its
    plain version on CPU tensors) over the keys up to its last row: dq by
    row, dk and dv summed over the ranks, against ``jax.vjp`` of the
    reference's ``_seq_parallel_attention`` (unrolled) at 1e-5 x
    max(1, max|g|)."""
    import jax
    import jax.numpy as jnp
    import repro.models.layers as JL
    from repro.configs.base import smoke_config
    from repro_torch.kernels import flash_attn
    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), q_chunk=4,
                              causal_bound=striped, attn_shard="seq",
                              static_unroll=True)
    rng = np.random.default_rng(11)
    b, s, hq, hkv, d = 2, 32, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, do = (rng.standard_normal((b, s, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    kpos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))

    def grads(q_, k_, v_, do_):
        _, vjp = jax.vjp(lambda *a: JL._seq_parallel_attention(
            cfg, *a, kpos, 1.0 / np.sqrt(d), jnp.float32, mm), q_, k_, v_)
        return vjp(do_)
    want = [np.asarray(t) for t in jax.jit(grads)(q, k, v, do)]
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    sl = s // mm
    for g in range(mm):
        rows = np.arange(g, s, mm) if striped else \
            np.arange(g * sl, (g + 1) * sl)
        n = rows[-1] + 1
        tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_(True)
                      for a in (q[:, rows], k[:, :n], v[:, :n]))
        o = flash_attn.flash_attention(
            tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
            causal=True, q_stride=mm if striped else 1)
        o.transpose(1, 2).backward(torch.from_numpy(do[:, rows]))
        dq[:, rows] = tq.grad.numpy()
        dk[:, :n] += tk.grad.numpy()
        dv[:, :n] += tv.grad.numpy()
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got, w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the backward kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("q_stride", [2, 4, 8])
def test_striped_backward_kernels_match_plain(cuda_device, dtype, d,
                                              q_stride):
    """The backward kernels (``flash_attn.bwd_kernels``: the tensor-core
    pair for bf16 at D <= 128, else the CUDA-core pair) against
    ``attention_bwd_ref`` on the same inputs and lse, the forward's limits:
    2e-3 x max(1, max|g|) in f32, 2^-6 x max|g| in bf16; at stride 1 equal
    to the call without a stride."""
    from repro_torch.kernels import flash_attn
    from repro_torch.kernels.ref import attention_bwd_ref
    gen = torch.Generator(device=cuda_device).manual_seed(q_stride * d)
    b, hq, hkv, sq = 2, 4, 2, 70
    for g in (0, q_stride - 1):
        sk = (sq - 1) * q_stride + g + 1
        q, do = (torch.randn((b, sq, hq, d), generator=gen,
                             device=cuda_device).to(dtype).transpose(1, 2)
                 for _ in range(2))
        k, v = (torch.randn((b, sk, hkv, d), generator=gen,
                            device=cuda_device).to(dtype).transpose(1, 2)
                for _ in range(2))
        o, lse = flash_attn.flash_attention_fwd(q, k, v, True, q_stride)
        got = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, True,
                                             q_stride)
        want = attention_bwd_ref(q, k, v, o, lse, do, True, q_stride)
        for a, w in zip(got, want):
            m = w.float().abs().max().item()
            lim = 2e-3 * max(1.0, m) if dtype == torch.float32 \
                else 2.0 ** -6 * m
            assert torch.isfinite(a).all()
            assert (a.float() - w.float()).abs().max().item() <= lim
        o1, lse1 = flash_attn.flash_attention_fwd(q, k, v, True)
        one = flash_attn.flash_attention_bwd(q, k, v, o1, lse1, do, True)
        same = flash_attn.flash_attention_bwd(q, k, v, o1, lse1, do, True,
                                              q_stride=1)
        assert all(torch.equal(x, y) for x, y in zip(one, same))
