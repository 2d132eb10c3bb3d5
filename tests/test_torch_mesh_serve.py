"""Serving under a mesh: ``models.prefill`` and ``models.decode_step`` on a
model built under a ``("data", "model")`` or ``("pod", "data", "model")``
mesh, its cache laid out by ``sharding.rules.cache_specs``, on four
``gloo`` ranks on the CPU, against the JAX package.

* The oracles, in subprocesses with no file of ``src/repro/`` edited: the
  reference's ``Model.prefill`` and ``Model.decode_step`` unsharded, and
  the same under ``jax.jit`` on a four-host-device CPU mesh of each shape
  (``AxisType.Auto`` axes), the parameters placed by ``param_specs``, the
  batch by ``batch_specs`` and the cache by ``cache_specs``.  The decode
  steps take the unsharded reference's greedy tokens, on every side.
* The port, the same numpy inputs and weights (``convert.
  params_from_reference`` cuts them to each rank's shards): the prefill's
  logits and 8 decode steps' logits, gathered (``models.gather_logits``),
  within ``TOL`` x max(1, max|logit|) of both oracles; the greedy tokens
  equal; each rank's cache part of the shape ``cache_specs`` cuts and,
  dequantized, within ``TOL`` x max(1, max|kv|) of that cut of the
  reference's cache.  The cases cover every layout: the KV heads over
  "model" (llama3.2-3b at (2, 2), phi3 at (2, 2), qwen2-vl), the head dim
  over "model" (llama3.2-3b's 2 KV heads at (1, 4), gemma-2b's one KV head,
  phi3-medium-14b's 10 at (1, 4)), the positions over "data" (B = 1 on (2,
  1), (2, 2) and (4, 1)), Mamba's channels (falcon-mamba-7b at 4 layers),
  expert parallelism and the decode's dispatch group across data ranks
  (qwen2-moe-a2.7b at B = 8), FSDP (jamba ``fsdp=True``), the pod axis (2,
  1, 2), float and int8 caches.
* Planted faults miss the tolerance: an empty window contributing the mean
  of its V; the partial scores not summed over "model"; each data rank
  routing its own rows as the MoE's dispatch group; the rank's o taken as
  its ``wo`` rows' columns without the gather over the head dim.
* The plain versions of the new decode kernels (the partial mode and its
  merge, the scores and the apply over a slice of the head dim) against the
  Pallas decode kernels in interpret mode, over windows of 2 and 4 ranks
  (empty ones among them) and slices of 2 and 4.
* ``cuda`` tests (no JAX): the kernels against their plain versions at the
  four-card meshes' local shapes.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_seq_parallel import REPO, _flat, _wait

WORLD = 4
S, MAX_LEN, STEPS = 8, 32, 8
TOL = 1e-4
# key: (arch, overrides, kv_dtype, batch, meshes)
CASES = {
    "llama": ("llama3.2-3b", {}, "compute", 4,
              ("2x2", "1x4", "4x1", "2x1x2")),
    "llama_int8": ("llama3.2-3b", {}, "int8", 4, ("2x2", "1x4")),
    "llama_b1": ("llama3.2-3b", {}, "compute", 1, ("2x1", "2x2", "4x1")),
    "llama_b1_int8": ("llama3.2-3b", {}, "int8", 1, ("2x2",)),
    "gemma": ("gemma-2b", dict(n_heads=8, n_kv_heads=1), "compute", 4,
              ("2x2", "1x4")),
    "phi3": ("phi3-medium-14b", dict(n_heads=40, n_kv_heads=10), "compute",
             4, ("1x4", "2x2")),
    "falcon": ("falcon-mamba-7b", dict(n_layers=4), "compute", 4,
               ("2x2", "1x4")),
    "qwen2moe": ("qwen2-moe-a2.7b", {}, "compute", 8, ("2x2", "1x4")),
    "jamba_fsdp": ("jamba-1.5-large-398b", dict(fsdp=True), "compute", 4,
                   ("2x2",)),
    "qwen2vl": ("qwen2-vl-7b", {}, "compute", 4, ("2x2", "1x4")),
}
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1), "2x1": (2, 1),
          "2x1x2": (2, 1, 2)}
# fault: (case, mesh)
FAULTS = {"empty_window": ("llama_b1", "4x1"),
          "scores_unsummed": ("llama", "1x4"),
          "moe_rows_apart": ("qwen2moe", "2x2"),
          "o_cols_ungathered": ("phi3", "1x4")}
RUNS = [(key, mesh) for key, c in CASES.items() for mesh in c[4]]
# the reference's processes, each a few cases in turn (so few run at once)
REF_SPLIT = [("llama", "llama_int8", "falcon"),
             ("llama_b1", "llama_b1_int8", "gemma", "jamba_fsdp"),
             ("phi3", "qwen2moe", "qwen2vl")]


def config(module, key):
    arch, over, kv, _, _ = CASES[key]
    return dataclasses.replace(module.smoke_config(arch), kv_dtype=kv,
                               **over)


def _inputs(cfg, b, seed=3):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return {"embeds": rng.normal(size=(b, S, cfg.d_model)).astype(
            np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, S)).astype(
        np.int32)}


_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import sharding as sh
from repro.configs.base import smoke_config
from repro.models import build_model

keys, root = sys.argv[1].split(","), sys.argv[2]
CASES, MESHES = %(cases)r, %(meshes)r
MAX_LEN, STEPS = %(max_len)d, %(steps)d


def flat(tree, prefix):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix[:-1]] = np.asarray(tree)
        return
    for k, v in items:
        flat(v, f"{prefix}{k}.")


def run(tag, p, bt, place_cache=lambda c: c, toks=None):
    logits, cache = pre(p, bt)
    cache = place_cache(cache)
    got = [np.asarray(logits)]
    fed = []
    for i in range(STEPS):
        t = jnp.argmax(logits, -1).astype(jnp.int32) if toks is None \
            else jnp.asarray(toks[i])
        fed.append(np.asarray(t))
        logits, cache = dec(p, cache, t)
        got.append(np.asarray(logits))
    out[tag + "_logits"] = np.stack(got)
    flat(jax.tree.map(np.asarray, cache), tag + "_cache__")
    return np.stack(fed)


def case(key):
    global out, pre, dec
    arch, over, kv, b, meshes = CASES[key]
    cfg = dataclasses.replace(smoke_config(arch), kv_dtype=kv, **over)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    batch = {k: jnp.asarray(v)
             for k, v in np.load(f"{root}/batch_{key}.npz").items()}
    pre = jax.jit(lambda p, bt: model.prefill(p, bt, MAX_LEN))
    dec = jax.jit(model.decode_step)
    out = {}
    toks = run("one", params, batch)
    out["tokens"] = toks
    for mk in meshes:
        sharded(cfg, params, batch, mk, toks)
    np.savez(f"{root}/want_{key}.npz", **out)


def sharded(cfg, params, batch, mk, toks):
    shape = MESHES[mk]
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = jax.sharding.Mesh(devs, names,
                             axis_types=(AxisType.Auto,) * len(shape))
    put = lambda t, specs: jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, P(*s))), t, specs,
        is_leaf=lambda x: hasattr(x, "shape"))
    with mesh:
        pp = put(params, sh.param_specs(cfg, params, mesh))
        bt = put(batch, sh.batch_specs(cfg, batch, mesh))
        run(mk, pp, bt, lambda c: put(c, sh.cache_specs(cfg, c, mesh)), toks)


for key in keys:
    case(key)
"""


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
from repro_torch import models
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L, lm
from repro_torch.models.convert import (cache_from_reference,
                                        cache_to_reference,
                                        params_from_reference)
from repro_torch.sharding import rules

CASES, MESHES, FAULTS = %(cases)r, %(meshes)r, %(faults)r
MAX_LEN, STEPS = %(max_len)d, %(steps)d


def config(key):
    arch, over, kv, _, _ = CASES[key]
    return dataclasses.replace(base.smoke_config(arch), kv_dtype=kv, **over)


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


meshes = {}
for mk, shape in MESHES.items():
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    meshes[mk] = make_mesh(shape, names, "cpu")


def serve(key, mk):
    cfg = config(key)
    tree = unflat(dict(np.load(f"{root}/params_{key}.npz")))
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(f"{root}/batch_{key}.npz").items()}
    if "tokens" in batch:
        batch["tokens"] = batch["tokens"].to(torch.int64)
    toks = torch.from_numpy(np.load(f"{root}/tokens_{key}.npz")["tokens"])
    mesh = meshes[mk]
    with L.ambient_mesh(mesh):
        model = params_from_reference(tree, cfg, "cpu")
        logits, cache = models.prefill(cfg, model, batch, MAX_LEN)
        got = [models.gather_logits(cfg, model, logits, cache)]
        for i in range(STEPS):
            tok = models.step_input(cfg, model, toks[i].to(torch.int64))
            logits, cache = models.decode_step(cfg, model, cache, tok)
            got.append(models.gather_logits(cfg, model, logits, cache))
    return torch.stack(got).numpy(), cache


res = {}
for key, (_, _, _, _, mks) in CASES.items():
    for mk in mks:
        if rank >= int(np.prod(MESHES[mk])):
            continue
        tag = f"{key}_{mk}"
        logits, cache = serve(key, mk)
        res["logits_" + tag] = logits
        part = cache["part"]
        res["coords_" + tag] = np.array(
            [rules.mesh_coords(meshes[mk])[a] for a in meshes[mk].mesh_dim_names])
        res["part_" + tag] = np.array(
            [list(part.rows or (-1, -1)), list(part.window or (-1, -1)),
             list(part.heads or (-1, -1)), list(part.dims or (-1, -1))])
        for i, entry in enumerate(cache["layers"]):
            for name, leaf in entry.items():
                res[f"cache_{tag}__layers.{i}.{name}"] = leaf.numpy()
        res[f"cache_{tag}__length"] = cache["length"].numpy()
        # the reference's final cache cut to this rank's part and gathered
        # back (convert), and this rank's cache gathered whole
        want = {k[len("one_cache__"):]: v for k, v in
                np.load(f"{root}/want_{key}.npz").items()
                if k.startswith("one_cache__")}
        with L.ambient_mesh(meshes[mk]):
            cut = cache_from_reference(unflat(want), config(key), "cpu",
                                       meshes[mk])
            back = cache_to_reference(cut, meshes[mk], lambda t: t.numpy())
            whole = cache_to_reference(cache, meshes[mk], lambda t: t.numpy())
        res["cut_part_" + tag] = np.array(cut["part"] == part)
        res["back_" + tag] = np.array(all(
            np.array_equal(back["layers"][i][n], want[f"layers.{i}.{n}"])
            for i, e in enumerate(back["layers"]) for n in e) and
            np.array_equal(back["length"], want["length"]))
        for i, entry in enumerate(cut["layers"]):
            for name, leaf in entry.items():
                res[f"cut_{tag}__layers.{i}.{name}"] = leaf.numpy()
        for i, entry in enumerate(whole["layers"]):
            for name, leaf in entry.items():
                res[f"whole_{tag}__layers.{i}.{name}"] = leaf


# planted faults
real = dict(partial=ops.decode_attention_partial, scores=L._whole_scores,
            moe=lm._moe_decode, heads=L._whole_heads)


def empty_window(q, k, v, length, w0=0, use_kernel=True, k_scale=None,
                 v_scale=None):
    # a window wholly past the row's length contributes its mean of V
    o, lse = real["partial"](q, k, v, length, w0, use_kernel, k_scale,
                             v_scale)
    o0, lse0 = real["partial"](q, k, v, torch.zeros_like(length), w0,
                               use_kernel, k_scale, v_scale)
    empty = (length <= w0)[:, None]
    return torch.where(empty[..., None], o0, o), torch.where(empty, lse0, lse)


def moe_rows_apart(cfg, p, h, part):
    # each data rank routes its own rows as the dispatch group
    return real["moe"](cfg, p, h, None)


def o_cols_ungathered(o):
    # the rank's o over its slice taken as the columns its wo rows take
    mm, r = L._model_place()
    b = o.shape[0]
    flat = o.reshape(b, -1)
    n = flat.shape[1]
    full = torch.zeros((b, mm * n), dtype=o.dtype)
    full[:, r * n:(r + 1) * n] = flat
    return full.reshape(b, o.shape[1], -1)


for fault, (key, mk) in FAULTS.items():
    if fault == "empty_window":
        ops.decode_attention_partial = empty_window
    elif fault == "scores_unsummed":
        L._whole_scores = lambda sc: sc
    elif fault == "moe_rows_apart":
        lm._moe_decode = moe_rows_apart
    else:
        L._whole_heads = o_cols_ungathered
    try:
        if rank < int(np.prod(MESHES[mk])):
            res["fault_" + fault] = serve(key, mk)[0]
    finally:
        ops.decode_attention_partial = real["partial"]
        L._whole_scores, L._whole_heads = real["scores"], real["heads"]
        lm._moe_decode = real["moe"]
np.savez(out, **res)
dist.barrier()
dist.destroy_process_group()
"""


def _spawn(script, argv_list, env):
    return [subprocess.Popen([sys.executable, "-c", script, *argv], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for argv in argv_list]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every rank's results (one spawn of four gloo ranks, after the
    reference's greedy tokens) and the reference's (one JAX process a
    case)."""
    import jax
    from repro.configs import base as jbase
    from repro.models import build_model
    from repro_torch.configs import base as tbase
    root = tmp_path_factory.mktemp("meshserve")
    fmt = dict(cases=CASES, meshes=MESHES, faults=FAULTS, max_len=MAX_LEN,
               steps=STEPS)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    for key, (_, _, _, b, _) in CASES.items():
        np.savez(root / f"batch_{key}.npz", **_inputs(config(tbase, key), b))
    procs = _spawn(_REF % fmt, [[",".join(keys), str(root)]
                                for keys in REF_SPLIT], env)
    try:
        for key in CASES:
            tree = jax.tree.map(np.asarray, build_model(
                config(jbase, key)).init(jax.random.key(0)))
            np.savez(root / f"params_{key}.npz", **_flat(tree))
        _wait(procs)
        procs = []
        for key in CASES:
            toks = np.load(root / f"want_{key}.npz")["tokens"]
            np.savez(root / f"tokens_{key}.npz", tokens=toks)
        procs = _spawn(_RANK % fmt, [
            [str(r), str(WORLD), str(root / "rendezvous"),
             str(root / f"rank{r}.npz"), str(root)] for r in range(WORLD)],
            env)
    finally:
        _wait(procs)
    got = [dict(np.load(root / f"rank{r}.npz")) for r in range(WORLD)]
    want = {key: dict(np.load(root / f"want_{key}.npz")) for key in CASES}
    return got, want


def _err(got, want):
    """max|got - want| / max(1, max|want|)."""
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


def _ranks(mesh):
    return range(int(np.prod(MESHES[mesh])))


@pytest.mark.parametrize("key,mesh", RUNS)
@pytest.mark.parametrize("against", ["sharded", "unsharded"])
def test_logits_match_reference(served, key, mesh, against):
    """Prefill's logits and 8 decode steps', gathered, on every rank."""
    got, want = served
    w = want[key][(mesh if against == "sharded" else "one") + "_logits"]
    for r in _ranks(mesh):
        g = got[r][f"logits_{key}_{mesh}"]
        assert g.shape == w.shape
        for i in range(len(w)):
            assert _err(g[i], w[i]) <= TOL, (key, mesh, r, i,
                                              _err(g[i], w[i]))


@pytest.mark.parametrize("key,mesh", RUNS)
def test_greedy_tokens_match_reference(served, key, mesh):
    got, want = served
    toks = want[key]["tokens"]
    for r in _ranks(mesh):
        g = got[r][f"logits_{key}_{mesh}"]
        np.testing.assert_array_equal(g[:-1].argmax(-1), toks)
        np.testing.assert_array_equal(
            g.argmax(-1), want[key][f"{mesh}_logits"].argmax(-1))


def _dequantized(tree, prefix):
    """{layer i: {"k", "v" (or "conv", "ssm")}: f32 arrays}, int8 codes
    times their scales."""
    layers = {}
    for name, arr in tree.items():
        if name.startswith(prefix + "layers."):
            i, leaf = name[len(prefix) + 7:].split(".")
            layers.setdefault(int(i), {})[leaf] = arr
    out = {}
    for i, entry in layers.items():
        if "k_scale" in entry:
            out[i] = {n: entry[n].astype(np.float32) * entry[n + "_scale"]
                      for n in ("k", "v")}
        else:
            out[i] = {n: a.astype(np.float32) for n, a in entry.items()}
    return out


@pytest.mark.parametrize("key,mesh", RUNS)
def test_each_rank_holds_the_cache_specs_cut(served, key, mesh):
    """Each rank's cache after the 8 steps: every leaf of the shape
    ``cache_specs`` cuts, its values (dequantized) that cut of the
    reference's unsharded cache; which layout each case takes."""
    from repro_torch.configs import base as tbase
    from repro_torch.sharding import rules
    got, want = served
    cfg = config(tbase, key)
    shape = MESHES[mesh]
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    sizes = dict(zip(names, shape))
    w = want[key]
    ref_tree = {"layers": [], "length": torch.from_numpy(
        w["one_cache__length"])}
    for i in sorted({int(k[len("one_cache__layers."):].split(".")[0])
                     for k in w if k.startswith("one_cache__layers.")}):
        prefix = f"one_cache__layers.{i}."
        ref_tree["layers"].append({k[len(prefix):]: torch.from_numpy(v)
                                   for k, v in w.items()
                                   if k.startswith(prefix)})
    places = rules.cache_placements(cfg, ref_tree, sizes)
    for r in _ranks(mesh):
        tag = f"{key}_{mesh}"
        coords = dict(zip(names, got[r]["coords_" + tag].tolist()))
        cut = rules.cache_shard(ref_tree, places, coords, sizes)
        mine = {k[len(f"cache_{tag}__"):]: v for k, v in got[r].items()
                if k.startswith(f"cache_{tag}__")}
        want_flat = {f"layers.{i}.{n}": t.numpy()
                     for i, e in enumerate(cut["layers"])
                     for n, t in e.items()}
        want_flat["length"] = cut["length"].numpy()
        assert set(mine) == set(want_flat)
        for n, a in want_flat.items():
            assert mine[n].shape == a.shape, (n, r)
        np.testing.assert_array_equal(mine["length"], want_flat["length"])
        g, wd = _dequantized(mine, ""), _dequantized(want_flat, "")
        for i in wd:
            for n in wd[i]:
                assert _err(g[i][n], wd[i][n]) <= TOL, (n, i, r)
    # the layouts the cases are there for
    part = got[0]["part_" + f"{key}_{mesh}"]
    rows, window, heads, dims = (tuple(x) for x in part)
    layout = {("llama", "2x2"): "heads", ("llama", "1x4"): "dims",
              ("llama_b1", "4x1"): "window", ("llama_b1", "2x2"): "window",
              ("gemma", "2x2"): "dims", ("phi3", "1x4"): "dims",
              ("phi3", "2x2"): "heads"}.get((key, mesh))
    if layout == "heads":
        assert heads != (-1, -1) and dims == (-1, -1)
    elif layout == "dims":
        assert dims != (-1, -1) and heads == (-1, -1)
    elif layout == "window":
        assert window != (-1, -1) and rows == (-1, -1)


@pytest.mark.parametrize("key,mesh", RUNS)
def test_convert_cuts_and_gathers_the_reference_cache(served, key, mesh):
    """``convert.cache_from_reference`` under the mesh cuts the reference's
    cache to the rank's part (the part ``init_cache`` makes: the same
    layout, the values within ``TOL`` of the rank's own cache after the
    same steps, dequantized), ``cache_to_reference`` gathers it back bit
    for bit, and gathers the rank's cache whole, within ``TOL`` of the
    reference's."""
    got, want = served
    tag = f"{key}_{mesh}"
    ref = {k[len("one_cache__"):]: v for k, v in want[key].items()
           if k.startswith("one_cache__")}
    for r in _ranks(mesh):
        res = got[r]
        assert bool(res["cut_part_" + tag]) and bool(res["back_" + tag])
        for prefix, against in (("cut", "cache"), ("whole", None)):
            mine = {k[len(f"{prefix}_{tag}__"):]: v for k, v in res.items()
                    if k.startswith(f"{prefix}_{tag}__")}
            other = ref if against is None else {
                k[len(f"{against}_{tag}__"):]: v for k, v in res.items()
                if k.startswith(f"{against}_{tag}__")}
            g, w = _dequantized(mine, ""), _dequantized(other, "")
            assert g.keys() == w.keys()
            for i in w:
                for n in w[i]:
                    assert g[i][n].shape == w[i][n].shape
                    assert _err(g[i][n], w[i][n]) <= TOL, (prefix, n, i, r)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_miss_the_tolerance(served, fault):
    """Each fault moves some rank's logits past the tolerance of the
    unsharded reference, where the real path is within it."""
    got, want = served
    key, mesh = FAULTS[fault]
    w = want[key]["one_logits"]
    worst = max(_err(got[r]["fault_" + fault][i], w[i])
                for r in _ranks(mesh) for i in range(len(w)))
    assert worst > TOL, (fault, worst)
    real = max(_err(got[r][f"logits_{key}_{mesh}"][i], w[i])
               for r in _ranks(mesh) for i in range(len(w)))
    assert real <= TOL


# ------------------------------------------- the kernels' plain versions
LENGTHS = (0, 1, 63, 64, 65, 127, 128, 133)


def _pallas(q, k, v, k8=None):
    """The Pallas decode kernel (interpret mode), one call a row (it takes
    a scalar length): ``{length: (B, Hq, D)}``."""
    import jax.numpy as jnp
    from repro.kernels.decode_attn import flash_decode as pallas_decode
    from repro.kernels.decode_attn_int8 import flash_decode_int8
    out = {}
    for n in LENGTHS:
        if k8 is None:
            out[n] = np.asarray(pallas_decode(q, k, v, n, bk=64))
        else:
            out[n] = np.asarray(flash_decode_int8(
                *(jnp.asarray(x) for x in (q, *k8)), n, bk=64))
    return out


def _quant(x):
    amax = np.abs(x).max(-1, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8), scale


@pytest.fixture(scope="module")
def decode_case():
    rng = np.random.default_rng(7)
    b, hq, hkv, s, d = len(LENGTHS), 8, 2, 128, 64
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    (k8, ks), (v8, vs) = _quant(k), _quant(v)
    want = _pallas(q, k, v)
    want8 = _pallas(q, k, v, (k8, ks, v8, vs))
    return q, k, v, (k8, ks, v8, vs), want, want8


def _rows(got, want):
    """Row i of ``got`` against the Pallas call at ``LENGTHS[i]``."""
    return np.stack([want[n][i] for i, n in enumerate(LENGTHS)]), \
        np.asarray(got, np.float32)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("slices", [1, 2, 4])
def test_plain_windows_and_slices_match_pallas(decode_case, quant, ranks,
                                               slices):
    """The cache split over ``ranks`` windows of the positions (empty ones
    among them: most rows end before the last windows) and ``slices`` of
    the head dim: the windows' partials through ``decode_scores`` (summed
    over the slices) and ``decode_apply``, or through the split-KV partial
    mode at one slice, merged by ``decode_merge``, against the Pallas
    kernel over the whole cache; the emptied windows give lse = -inf."""
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import decode_attn_int8 as di
    q, k, v, (k8, ks, v8, vs), want, want8 = decode_case
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    s, d = k.shape[2], k.shape[3]
    w, dp = s // ranks, d // slices
    os_, ls_ = [], []
    for i in range(ranks):
        win = slice(i * w, (i + 1) * w)
        if quant:
            kw, vw = t(k8[:, :, win]), t(v8[:, :, win])
            ksw, vsw = t(ks[:, :, win]), t(vs[:, :, win])
        else:
            kw, vw = t(k[:, :, win]), t(v[:, :, win])
        if slices == 1:
            o, lse = (di.flash_decode_int8_partial(t(q), kw, ksw, vw, vsw,
                                                   lengths, i * w) if quant
                      else da.flash_decode_partial(t(q), kw, vw, lengths,
                                                   i * w))
        else:
            cut = [slice(j * dp, (j + 1) * dp) for j in range(slices)]
            sc = sum((di.decode_scores_int8(t(q)[..., c], kw[..., c], ksw,
                                            lengths, i * w, d ** -0.5)
                      if quant else
                      da.decode_scores(t(q)[..., c], kw[..., c], lengths,
                                       i * w, d ** -0.5)) for c in cut)
            parts = [di.decode_apply_int8(sc, vw[..., c], vsw, lengths, i * w)
                     if quant else
                     da.decode_apply(sc, vw[..., c], lengths, i * w)
                     for c in cut]
            o = torch.cat([p[0] for p in parts], -1)
            lse = parts[0][1]
            for p in parts[1:]:
                assert torch.equal(p[1], lse)
        # rows that end before the window (a row of length 0 takes it)
        empty = (lengths > 0) & (lengths <= i * w)
        assert torch.isneginf(lse[empty]).all()
        assert torch.isfinite(lse[~empty]).all()
        assert (o[empty] == 0).all()
        os_.append(o)
        ls_.append(lse)
    got = da.decode_merge(torch.stack(os_), torch.stack(ls_))
    w_, g_ = _rows(got, want8 if quant else want)
    np.testing.assert_allclose(g_, w_, rtol=2e-5 if quant else 2e-3,
                               atol=2e-5 if quant else 2e-3)


def test_plain_windows_planted_fault_misses(decode_case):
    """An empty window that contributes its mean of V (the one-card rule
    for ``length <= 0``, wrong for a window past the row's end) misses."""
    from repro_torch.kernels import decode_attn as da
    q, k, v, _, want, _ = decode_case
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    w = k.shape[2] // 2
    os_, ls_ = [], []
    for i in range(2):
        win = slice(i * w, (i + 1) * w)
        empty = lengths <= i * w
        fake = torch.where(empty, torch.zeros_like(lengths), lengths)
        o, lse = da.flash_decode_partial(t(q), t(k[:, :, win]),
                                         t(v[:, :, win]), fake, i * w)
        os_.append(o)
        ls_.append(lse)
    got = da.decode_merge(torch.stack(os_), torch.stack(ls_))
    w_, g_ = _rows(got, want)
    assert not np.allclose(g_, w_, rtol=2e-3, atol=2e-3)


def test_kernels_launch_counters_and_signatures():
    """The new wrappers count their launches under their own names, and
    the C entry points take the window and the lse."""
    from repro_torch.kernels import _build, decode_attn, decode_attn_int8
    from repro_torch.kernels import launch_counts
    names = set(launch_counts())
    for n in ("flash_decode_partial", "flash_decode_int8_partial",
              "decode_merge", "decode_scores", "decode_scores_int8",
              "decode_apply", "decode_apply_int8"):
        assert n in names
    src = (pathlib.Path(decode_attn.__file__).resolve().parent / "csrc"
           / "decode_attn.cu").read_text()
    for k in ("decode_scores_kernel", "decode_apply_kernel",
              "decode_merge_parts"):
        assert k in src
    for e in ("decode_scores_f32", "decode_scores_int8_bf16",
              "decode_apply_bf16", "decode_apply_int8"):
        assert e in _build.SIGNATURES
    assert decode_attn.CHUNK == 64 and decode_attn_int8.LAUNCHES


def test_refused_families_name_item_10k():
    """The enc-dec and ``attn_shard="seq"`` keep whole parameters under a
    mesh and do not serve there: both raise naming item 10(k)."""
    import torch.distributed as dist

    from repro_torch.configs.base import smoke_config
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch import models
    from repro_torch.models import layers as L
    for arch, over in (("seamless-m4t-large-v2", {}),
                       ("llama3.2-3b", dict(attn_shard="seq"))):
        cfg = dataclasses.replace(smoke_config(arch), **over)
        with fake_world(4):
            mesh = make_host_mesh(2, 2, device_type="cpu")
            with L.ambient_mesh(mesh):
                model = models.build_model(cfg, "cpu")
                with pytest.raises(NotImplementedError, match=r"10\(k\)"):
                    models.init_cache(cfg, model, 4, 16, 8)
        assert not dist.is_initialized()


# ------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# the four-card meshes' local shapes at decode: (B, Hq, Hkv, W, D) of the
# partial mode, and (B, Hq, Hkv, W, D') of the slices
PARTIAL_SHAPES = [(1, 24, 4, 16384, 128), (1, 24, 8, 8192, 128),
                  (8, 12, 4, 544, 128)]
SLICE_SHAPES = [(8, 40, 10, 544, 32), (8, 8, 1, 544, 128),
                (8, 8, 1, 544, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PARTIAL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_mode_on_the_card(cuda_device, shape, dtype):
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import decode_attn_int8 as di
    from repro_torch.kernels import ref
    b, hq, hkv, w, d = shape
    g = torch.Generator(device="cpu").manual_seed(0)
    q = torch.randn(b, hq, d, generator=g).to(dtype).to(cuda_device)
    k, v = (torch.randn(b, hkv, w, d, generator=g).to(dtype).to(cuda_device)
            for _ in range(2))
    lengths = torch.tensor([0, w // 2, w + 100, 3 * w, 1, 64, 65, w][:b],
                           dtype=torch.int32, device=cuda_device)
    tol = 2e-3 if dtype == torch.float32 else 5e-2
    for w0 in (0, w):
        o, lse = da.flash_decode_partial(q, k, v, lengths, w0)
        wo, wl = ref.decode_partial_ref(q, k, v, lengths, w0)
        fin = torch.isfinite(wl)
        assert torch.equal(torch.isfinite(lse), fin)
        torch.testing.assert_close(o, wo, rtol=tol, atol=tol)
        assert ((lse - wl)[fin].abs() <= 1e-5 * wl[fin].abs().clamp(
            min=1)).all()
        k8, ks = (x.to(cuda_device) for x in _quant_t(k))
        v8, vs = (x.to(cuda_device) for x in _quant_t(v))
        o8, l8 = di.flash_decode_int8_partial(q, k8, ks, v8, vs, lengths, w0)
        w8, wl8 = ref.decode_int8_partial_ref(q, k8, ks, v8, vs, lengths, w0)
        torch.testing.assert_close(o8, w8, rtol=tol, atol=tol)
    m = da.decode_merge(torch.stack([o, o]), torch.stack([lse, lse]))
    torch.testing.assert_close(m, ref.decode_merge_ref(
        torch.stack([o, o]), torch.stack([lse, lse])), rtol=1e-6, atol=1e-6)


def _quant_t(x):
    x = x.float().cpu()
    amax = x.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), \
        scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SLICE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slice_kernels_on_the_card(cuda_device, shape, dtype):
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import decode_attn_int8 as di
    from repro_torch.kernels import ref
    b, hq, hkv, w, dp = shape
    g = torch.Generator(device="cpu").manual_seed(1)
    q = torch.randn(b, hq, dp, generator=g).to(dtype).to(cuda_device)
    k, v = (torch.randn(b, hkv, w, dp, generator=g).to(dtype).to(cuda_device)
            for _ in range(2))
    lengths = torch.tensor([0, 1, 63, 64, 65, w - 1, w, w + 9][:b],
                           dtype=torch.int32, device=cuda_device)
    tol = 2e-3 if dtype == torch.float32 else 5e-2
    sc = da.decode_scores(q, k, lengths, 0, 0.1)
    torch.testing.assert_close(sc, ref.decode_scores_ref(q, k, lengths, 0,
                                                         0.1),
                               rtol=tol, atol=tol)
    o, lse = da.decode_apply(sc, v, lengths)
    wo, wl = ref.decode_apply_ref(sc, v, lengths)
    torch.testing.assert_close(o, wo, rtol=tol, atol=tol)
    assert ((lse - wl).abs() <= 1e-5 * wl.abs().clamp(min=1)).all()
    if dp % 16 == 0:
        k8, ks = (x.to(cuda_device) for x in _quant_t(k))
        v8, vs = (x.to(cuda_device) for x in _quant_t(v))
        sc8 = di.decode_scores_int8(q, k8, ks, lengths, 0, 0.1)
        torch.testing.assert_close(
            sc8, ref.decode_scores_ref(q, k8, lengths, 0, 0.1, ks),
            rtol=tol, atol=tol)
        o8, _ = di.decode_apply_int8(sc8, v8, vs, lengths)
        torch.testing.assert_close(
            o8, ref.decode_apply_ref(sc8, v8, lengths, 0, vs)[0],
            rtol=tol, atol=tol)


_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch.models, repro_torch.models.convert
import repro_torch.launch.serve_step_times, repro_torch.launch.specs
import repro_torch.launch.dryrun, repro_torch.kernels.ops
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_touched_modules_import_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
