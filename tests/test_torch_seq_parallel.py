"""Context parallelism (``attn_shard="seq"``, ``seq_residual``,
``causal_bound``, the sequence-parallel MoE) and the pipelined prefill of
the port against the JAX package, on the CPU.

* The reference runs its own sequence-parallel code in one process:
  ``repro.models.layers._mesh_axis`` is patched in the test to give the
  model axis mm (no mesh, so every ``_constrain`` falls through), and its
  ``backbone`` computes the blocked or striped attention and the (B mm,
  S/mm) MoE groups.  The port runs the same forward on four ``gloo``
  ranks (one spawn, a ``file://`` rendezvous, 60 s group timeout, killed
  and failed when late) under a ``("data", "model")`` mesh of (2, 2) and
  (1, 4): llama3.2-3b and qwen2-moe-a2.7b smoke at 4 layers, jamba smoke
  at its own depth, blocked and striped, ``seq_residual`` both ways, the
  reference's init carried across by ``models/convert.py``; h and the aux
  loss at the LM tolerance (rtol = atol = 1e-4) on every rank.
* Without context parallelism nothing changes: a model size of 1,
  ``attn_shard`` "default" or "replicate" under mm = 2, bit-equal to no
  mesh; a prefill under CP fills the whole cache on every model rank,
  equal to the one-rank prefill; a loss and a recorded backward under CP
  (every model rank's result scaled by 1/mm, the gradients summed over the
  model ranks) give the reference's gradients (its ``jax.value_and_grad``
  with ``_mesh_axis`` patched).
* The pipelined prefill (``launch.pipeline_prefill``), baseline 4 x 1 and
  ``seq_causal`` 2 x 2, on ``tests/test_pipeline_prefill.py``'s case
  (llama smoke, 4 layers, ``q_chunk`` 8, S 16, batch 4, ``n_micro`` 2,
  f32) against the reference's ``run_stack`` per micro-batch at the last
  token, rtol = atol = 2e-4 (that test's own bound).
* The striped plain attention (``flash_attention_plain`` with
  ``q_stride``) against the reference's ``_seq_parallel_attention``;
  ``q_stride`` 1 is today's mask; strides the keys cannot hold raise.
* ``cuda`` tests (no JAX): the flash kernel at ``q_stride`` 2, 4, 8 against
  its plain version, D 64/128/256, bf16 and f32; stride 1 equal to the
  call without it.
* The new modules import neither ``jax`` nor ``repro``.
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

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
RANK_TIMEOUT_S = 120
TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = {"llama3.2-3b": 4, "qwen2-moe-a2.7b": 4,
          "jamba-1.5-large-398b": None}        # None: the smoke depth
WITH_MOE = ("qwen2-moe-a2.7b", "jamba-1.5-large-398b")
VARIANTS = [(cb, sr) for cb in (False, True) for sr in (True, False)]
B, S = 2, 16
PF = dict(layers=4, q_chunk=8, seq=16, batch=4, micro=2)   # the prefill case


def _flat(tree, prefix=""):
    """A reference tree of dicts and lists as ``{"a.0.b": array}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _ref_params(name, layers=None, **over):
    import jax
    from repro.configs.base import smoke_config
    from repro.models import lm as jlm
    cfg = smoke_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cfg = dataclasses.replace(cfg, **over)
    return cfg, jlm.init_lm(cfg, jax.random.key(0))


def _inputs(cfg, params, seed=1):
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    x = np.asarray(params["embed"])[tokens]
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    return tokens, x, pos


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
from repro_torch.launch.mesh import make_host_mesh, make_pod_mesh
from repro_torch.launch import pipeline_prefill as pp
from repro_torch.models import layers as L, lm
from repro_torch.models.convert import params_from_reference

MODELS = %(models)r
VARIANTS = %(variants)r
B, S, PF = %(b)d, %(s)d, %(pf)r


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


def model_of(name, layers, **over):
    cfg = smoke_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cfg = dataclasses.replace(cfg, **over)
    tree = unflat(dict(np.load(f"{root}/params_{name}.npz")))
    return cfg, params_from_reference(tree, cfg, "cpu")


res = {}
meshes = {2: make_host_mesh(2, 2, device_type="cpu"),
          4: make_host_mesh(1, 4, device_type="cpu")}
one = make_pod_mesh(4, 1, 1, device_type="cpu")   # model size 1
for name, layers in MODELS.items():
    cfg, model = model_of(name, layers)
    data = dict(np.load(f"{root}/inputs_{name}.npz"))
    x, pos = torch.from_numpy(data["x"]), torch.from_numpy(data["pos"])
    tokens = torch.from_numpy(data["tokens"])
    with torch.no_grad():
        h0, a0, _ = lm.backbone(cfg, model, x, pos)
        for mm, mesh in meshes.items():
            for cb, sr in VARIANTS:
                c = dataclasses.replace(cfg, attn_shard="seq",
                                        causal_bound=cb, seq_residual=sr)
                with L.ambient_mesh(mesh):
                    h, a, _ = lm.backbone(c, model, x, pos)
                tag = f"{name}_{mm}_{int(cb)}{int(sr)}"
                res["h_" + tag], res["aux_" + tag] = h.numpy(), a.numpy()
        # nothing changes without context parallelism
        same = []
        for mesh, shard in ((one, "seq"), (meshes[2], "default"),
                            (meshes[2], "replicate")):
            c = dataclasses.replace(cfg, attn_shard=shard,
                                    causal_bound=True)
            with L.ambient_mesh(mesh):
                h, a, _ = lm.backbone(c, model, x, pos)
            same.append(torch.equal(h, h0) and torch.equal(a, a0))
        res["unchanged_" + name] = np.array(same)
        # a prefill under CP fills the whole cache on every model rank
        want_l, want_c = lm.prefill(cfg, model, tokens, S + 4)
        for sr in (True, False):
            c = dataclasses.replace(cfg, attn_shard="seq", causal_bound=True,
                                    seq_residual=sr)
            with L.ambient_mesh(meshes[2]):
                got_l, got_c = lm.prefill(c, model, tokens, S + 4)
                h, _, _ = lm.backbone(c, model, x, pos)
            own = lm._logits(model, h[:, -1])
            tag = f"{name}_{int(sr)}"
            res["prefill_logits_" + tag] = np.array(
                [(got_l - own).abs().max().item(),
                 (got_l - want_l).abs().max().item(),
                 want_l.abs().max().item()])
            errs = []
            for ge, we in zip(got_c["layers"], want_c["layers"]):
                for k in we:
                    errs.append((ge[k] - we[k]).abs().max().item())
            res["prefill_cache_" + tag] = np.array(errs)
            res["prefill_length_" + tag] = got_c["length"].numpy()
    # a loss and a recorded backward: every data rank holds the whole batch,
    # so each model rank's result scaled by 1/mm and the gradients summed
    # over the model ranks
    c = dataclasses.replace(cfg, attn_shard="seq")
    mesh, mm = meshes[2], 2
    group = mesh.get_group("model")
    model.requires_grad_(True)
    with L.ambient_mesh(mesh):
        loss, _ = lm.lm_loss(c, model, {"tokens": tokens, "labels": tokens})
        (loss / mm).backward()
    res["cp_loss_" + name] = loss.detach().numpy()
    for n, p in model.named_parameters():
        res[f"cp_g_{name}__{n}"] = comm.all_reduce(p.grad, group).numpy()
    model.requires_grad_(False)
    w = torch.from_numpy(data["w"])
    xg = x.clone().requires_grad_(True)
    with L.ambient_mesh(mesh):
        h, _, _ = lm.backbone(c, model, xg, pos)
        ((h * w).sum() / mm).backward()
    res["cp_xg_" + name] = comm.all_reduce(xg.grad, group).numpy()

# the pipelined prefill: baseline 4 x 1, seq_causal 2 x 2
cfg, model = model_of("llama3.2-3b", PF["layers"], q_chunk=PF["q_chunk"])
toks = torch.from_numpy(np.load(f"{root}/prefill_tokens.npz")["tokens"])
for variant, (pods, mm) in (("baseline", (4, 1)), ("seq_causal", (2, 2))):
    mesh = make_pod_mesh(pods, 1, mm, device_type="cpu")
    c = pp.variant_config(cfg, variant)
    stages = lm.split_stages(model, pods)
    stage = stages[mesh.get_local_rank("pod")]
    fn, sched = pp.make_pipelined_prefill(c, mesh, PF["micro"], PF["seq"],
                                          PF["batch"])
    sent, real_hop = [], comm.hop
    def spy(send, *a):
        if send is not None:
            sent.append(tuple(send.shape))
        return real_hop(send, *a)
    comm.hop = spy
    try:
        res["prefill_" + variant] = fn(stage, toks).numpy()
    finally:
        comm.hop = real_hop
    res["hops_" + variant] = np.array(sent + [(0, 0, 0)])
    res["hop_rows_" + variant] = np.array(fn.hop_rows)
    res["ticks_" + variant] = np.array([sched.n_ticks,
                                        sched.utilization()])
np.savez(out, **res)
dist.destroy_process_group()
"""


def _reference(root):
    """The reference's results, in this process: its sequence-parallel
    backbone with ``_mesh_axis`` patched, and ``run_stack`` per
    micro-batch of the prefill case."""
    import jax.numpy as jnp
    import repro.models.layers as JL
    from repro.models import lm as jlm
    want = {}
    real = JL._mesh_axis
    for name, layers in MODELS.items():
        cfg, params = _ref_params(name, layers)
        _, x, pos = _inputs(cfg, params)
        for mm in (2, 4):
            for cb, sr in VARIANTS:
                c = dataclasses.replace(cfg, attn_shard="seq",
                                        causal_bound=cb, seq_residual=sr)
                JL._mesh_axis = lambda n, mm=mm: mm if n == "model" else 1
                try:
                    h, a, _ = jlm.backbone(c, params, jnp.asarray(x),
                                           jnp.asarray(pos))
                finally:
                    JL._mesh_axis = real
                tag = f"{name}_{mm}_{int(cb)}{int(sr)}"
                want["h_" + tag] = np.asarray(h)
                want["aux_" + tag] = np.asarray(a)
        want.update(_reference_grads(name, cfg, params, x, pos))
    cfg, params = _ref_params("llama3.2-3b", PF["layers"],
                              q_chunk=PF["q_chunk"])
    toks = np.load(root / "prefill_tokens.npz")["tokens"]
    b_m, s = PF["batch"] // PF["micro"], PF["seq"]
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b_m, s))
    want["prefill"] = np.stack([np.asarray(jlm.run_stack(
        cfg, params["positions"], params["embed"][jnp.asarray(toks[m])],
        pos)[:, -1]) for m in range(PF["micro"])])
    return want


def _reference_grads(name, cfg, params, x, pos):
    """The reference's gradients of the two calls the ranks make under
    ``attn_shard="seq"`` at mm = 2: the loss's, by parameter (laid out as
    the port's parameters), and x's of ``sum(backbone(x) * w)``."""
    import jax
    import jax.numpy as jnp
    import repro.models.layers as JL
    from repro.models import build_model
    from repro.models import lm as jlm
    from repro_torch.configs.base import smoke_config as tsmoke
    from repro_torch.models.convert import params_from_reference
    c = dataclasses.replace(cfg, attn_shard="seq")
    tokens, w = _inputs(cfg, params)[0], _cotangent(cfg)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    real = JL._mesh_axis
    JL._mesh_axis = lambda n: 2 if n == "model" else 1
    try:
        (loss, _), g = jax.value_and_grad(
            lambda p: build_model(c).loss(p, batch), has_aux=True)(params)
        xg = jax.grad(lambda x_: jnp.sum(jlm.backbone(
            c, params, x_, jnp.asarray(pos))[0] * w))(jnp.asarray(x))
    finally:
        JL._mesh_axis = real
    tcfg = dataclasses.replace(tsmoke(name), n_layers=cfg.n_layers)
    port = params_from_reference(jax.tree.map(np.asarray, g), tcfg, "cpu")
    return {"cp_loss_" + name: np.asarray(loss),
            "cp_xg_" + name: np.asarray(xg),
            **{f"cp_g_{name}__{n}": t.detach().numpy()
               for n, t in port.named_parameters()}}


def _cotangent(cfg, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results (one spawn of four gloo ranks) and the
    reference's, computed here while the ranks run."""
    root = tmp_path_factory.mktemp("seqpar")
    for name, layers in MODELS.items():
        cfg, params = _ref_params(name, layers)
        np.savez(root / f"params_{name}.npz", **_flat(params))
        tokens, x, pos = _inputs(cfg, params)
        np.savez(root / f"inputs_{name}.npz", tokens=tokens, x=x, pos=pos,
                 w=_cotangent(cfg))
    cfg, params = _ref_params("llama3.2-3b", PF["layers"],
                              q_chunk=PF["q_chunk"])
    b_m = PF["batch"] // PF["micro"]
    np.savez(root / "prefill_tokens.npz", tokens=np.random.default_rng(
        0).integers(0, cfg.vocab_size, (PF["micro"], b_m, PF["seq"])))
    script = _RANK % dict(models=MODELS, variants=VARIANTS, b=B, s=S,
                          pf=PF)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    cmds = [[sys.executable, "-c", script, str(r), str(WORLD),
             str(root / "rendezvous"), str(root / f"rank{r}.npz"),
             str(root)] for r in range(WORLD)]
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        want = _reference(root)
    finally:
        _wait(procs)
    got = [dict(np.load(root / f"rank{r}.npz")) for r in range(WORLD)]
    return got, want


def _wait(procs):
    """Wait for every rank within ``RANK_TIMEOUT_S``; kill and fail those
    that are late or fail."""
    outs, late = [], []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                late.append(p.args[-3])
                outs.append("")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not late, f"late: {late}"
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("mm", [2, 4])
@pytest.mark.parametrize("cb,sr", VARIANTS)
def test_context_parallel_matches_reference(ranks, name, mm, cb, sr):
    got, want = ranks
    tag = f"{name}_{mm}_{int(cb)}{int(sr)}"
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["h_" + tag], want["h_" + tag],
                                   **TOL)
        np.testing.assert_allclose(got[r]["aux_" + tag],
                                   want["aux_" + tag], **TOL)


def test_moe_groups_change_the_function(ranks):
    """The sequence-parallel MoE budgets capacity per (B mm, S/mm) group,
    so under a blocked residual it is another function than the unsharded
    model's (the reference's too); without the blocked residual it is the
    same."""
    got, want = ranks
    name = "qwen2-moe-a2.7b"
    blocked = want[f"h_{name}_2_01"]
    replicated = want[f"h_{name}_2_00"]
    assert np.abs(blocked - replicated).max() > 1e-2
    np.testing.assert_allclose(got[0][f"h_{name}_2_00"], replicated, **TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_without_context_parallelism_nothing_changes(ranks, name):
    got, _ = ranks
    for r in range(WORLD):
        assert got[r]["unchanged_" + name].all()


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("sr", [True, False])
def test_prefill_under_cp_fills_the_whole_cache(ranks, name, sr):
    """The prefill's logits are the CP backbone's; its cache (every layer's
    K/V or Mamba states, the whole sequence) and logits equal the one-rank
    prefill's wherever CP computes the same function (not the blocked
    residual's MoE groups)."""
    got, _ = ranks
    tag = f"{name}_{int(sr)}"
    same_function = not (sr and name in WITH_MOE)
    for r in range(WORLD):
        own, one_rank, scale = got[r]["prefill_logits_" + tag]
        assert own <= 1e-5 * max(1.0, scale)
        assert (got[r]["prefill_length_" + tag] == S).all()
        if same_function:
            assert one_rank <= 1e-4 * max(1.0, scale)
            assert (got[r]["prefill_cache_" + tag] <= 1e-4).all()


@pytest.mark.parametrize("name", list(MODELS))
def test_cp_loss_and_backward_match_reference(ranks, name):
    """``lm_loss`` and a recorded backward of ``backbone`` under CP, every
    data rank holding the whole batch: the loss, every parameter's
    gradient and x's gradient equal the reference's, on every rank, at
    1e-4 x max(1, max|g|)."""
    got, want = ranks
    keys = [k for k in want if k.startswith(f"cp_g_{name}__")]
    assert keys
    for r in range(WORLD):
        for k in keys + [f"cp_loss_{name}", f"cp_xg_{name}"]:
            w = want[k]
            np.testing.assert_allclose(
                got[r][k], w, rtol=1e-4,
                atol=1e-4 * max(1.0, np.abs(w).max()), err_msg=k)


@pytest.mark.parametrize("variant", ["baseline", "seq_causal"])
def test_pipelined_prefill_matches_reference_run_stack(ranks, variant):
    got, want = ranks
    pods = 4 if variant == "baseline" else 2
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["prefill_" + variant],
                                   want["prefill"], rtol=2e-4, atol=2e-4)
        ticks, util = got[r]["ticks_" + variant]
        assert ticks == PF["micro"] + pods - 1
        assert util == pytest.approx(PF["micro"] / ticks)


@pytest.mark.parametrize("variant", ["baseline", "seq_causal"])
def test_pipelined_prefill_hops_a_ranks_rows(ranks, variant):
    """A hop carries a micro-batch's (b_m, rows, d): the whole sequence at
    4 x 1, under the blocked residual of 2 x 2 only the rank's S/2 rows (no
    gather at a stage's end); every stage but the last sends one a
    micro-batch."""
    got, _ = ranks
    pods, rows = (4, PF["seq"]) if variant == "baseline" else \
        (2, PF["seq"] // 2)
    b_m = PF["batch"] // PF["micro"]
    for r in range(WORLD):
        sent = [tuple(h) for h in got[r]["hops_" + variant][:-1]]
        assert int(got[r]["hop_rows_" + variant]) == rows
        last = r // (WORLD // pods) == pods - 1
        assert sent == ([] if last else [(b_m, rows, 64)] * PF["micro"])


@pytest.mark.parametrize("variant,arch", [("baseline", "llama3.2-3b"),
                                          ("seq_causal", "qwen2-moe-a2.7b")])
def test_pipeline_prefill_main_under_torchrun(tmp_path, variant, arch):
    """``python -m repro_torch.launch.pipeline_prefill`` under ``torchrun``
    on four CPU ranks: one JSON record with the reference's keys and the
    measured ones, also written under ``--out``."""
    import json
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.pipeline_prefill",
         "--arch", arch, "--reduced", "--depth", "1", "--device", "cpu",
         "--seq-len", "16", "--batch", "4", "--micro", "2", "--variant",
         variant, "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    rec = json.loads([line for line in res.stdout.splitlines()
                      if line.startswith("{")][-1])
    pods = 4 if variant == "baseline" else 2
    assert rec["arch"] == arch and rec["mode"] == "pipelined_prefill"
    assert rec["variant"] == variant and rec["n_stages"] == pods
    assert rec["schedule_ticks"] == 2 + pods - 1
    assert rec["schedule_utilization"] == pytest.approx(2 / (1 + pods))
    assert rec["out_shape"] == [2, 2, 64] and rec["out_finite"]
    rows = 16 if variant == "baseline" else 16 // 2     # blocked: S / mm
    assert rec["backend"] == "gloo" and rec["hop_bytes"] == 2 * rows * 64 * 4
    assert rec["profile_per_rank"] == [None] * 4       # the card's only
    assert rec["ms_per_prefill"] > 0 and rec["tokens_per_s"] > 0
    written = tmp_path / f"{arch}_pipeline_{variant}_m2.json"
    assert json.loads(written.read_text())["n_micro"] == 2


# -------------------------------------------------- striped plain attention
@pytest.mark.parametrize("mm", [2, 4])
@pytest.mark.parametrize("striped", [False, True])
def test_plain_attention_by_rank_matches_seq_parallel_attention(mm, striped):
    """Each rank's rows through ``flash_attention`` (its plain version on
    CPU tensors) over the keys up to its last row, reassembled, equal the
    reference's ``_seq_parallel_attention`` (blocked, or striped with
    ``q_stride`` mm)."""
    import jax.numpy as jnp
    import repro.models.layers as JL
    from repro.configs.base import smoke_config
    from repro_torch.kernels import flash_attn
    # static_unroll: the reference's chunks concatenated in order (its
    # lax.map path misorders them, test_reference_lax_map_misorders_rows)
    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), q_chunk=4,
                              causal_bound=striped, attn_shard="seq",
                              static_unroll=True)
    rng = np.random.default_rng(7)
    b, s, hq, hkv, d = 2, 32, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    kpos = np.broadcast_to(np.arange(s)[None], (b, s))
    want = np.asarray(JL._seq_parallel_attention(
        cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kpos), 1.0 / np.sqrt(d), jnp.float32, mm))
    got = np.empty_like(want)
    sl = s // mm
    for g in range(mm):
        rows = np.arange(g, s, mm) if striped else \
            np.arange(g * sl, (g + 1) * sl)
        n = rows[-1] + 1
        tq, tk, tv = (torch.from_numpy(a).transpose(1, 2)
                      for a in (q[:, rows], k[:, :n], v[:, :n]))
        o = flash_attn.flash_attention(tq, tk, tv, causal=True,
                                       q_stride=mm if striped else 1)
        got[:, rows] = o.transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("striped", [False, True])
def test_reference_lax_map_misorders_rows(striped):
    """A fact of the reference, not of the port: with more than one query
    chunk a rank and ``static_unroll=False``, ``_seq_parallel_attention``
    reassembles ``lax.map``'s (N, B, mm, qc, H, D) by ``moveaxis(o, 0, 3)``
    into (B, mm, qc, N, H, D) and reads it as (B, mm, N, qc, H, D): rows
    land in the wrong places.  Its unrolled path is right (the reference
    runs the unrolled one in its dry runs only)."""
    import jax.numpy as jnp
    import repro.models.layers as JL
    from repro.configs.base import smoke_config
    rng = np.random.default_rng(3)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 32, 4, 16)), jnp.float32)
               for _ in range(3))
    kpos = jnp.broadcast_to(jnp.arange(32)[None], (1, 32))
    out = {}
    for unroll in (False, True):
        cfg = dataclasses.replace(smoke_config("llama3.2-3b"), q_chunk=4,
                                  causal_bound=striped, attn_shard="seq",
                                  n_kv_heads=4, static_unroll=unroll)
        out[unroll] = np.asarray(JL._seq_parallel_attention(
            cfg, q, k, v, kpos, 0.25, jnp.float32, 2))
    assert np.abs(out[False] - out[True]).max() > 0.1


def test_stride_one_mask_is_the_lower_triangle():
    from repro_torch.kernels import ref
    for sq, sk in ((5, 5), (3, 7), (7, 3), (1, 4)):
        want = torch.ones((sq, sk), dtype=torch.bool).tril(diagonal=sk - sq)
        assert torch.equal(ref.causal_mask(sq, sk), want)
    # stride 3, 4 rows over 11 keys: rows at 1, 4, 7, 10
    m = ref.causal_mask(4, 11, 3)
    assert m.sum(1).tolist() == [2, 5, 8, 11]


@pytest.mark.parametrize("q_stride,sk", [(0, 8), (2, 6), (3, 9)])
def test_a_stride_the_keys_cannot_hold_raises(q_stride, sk):
    from repro_torch.kernels import flash_attn
    q = torch.zeros((1, 2, 4, 16))
    kv = torch.zeros((1, 2, sk, 16))
    with pytest.raises(ValueError):
        flash_attn.flash_attention(q, kv, kv, causal=True, q_stride=q_stride)


@pytest.mark.parametrize("q_stride", [2, 4])
def test_strided_attention_backward_matches_autograd(q_stride):
    """``flash_attention`` under autograd at ``q_stride``
    (``FlashAttention``, the plain backward on CPU tensors) gives
    autograd's gradients of the plain ``attention_ref`` at the same
    stride."""
    from repro_torch.kernels import flash_attn, ref
    rng = np.random.default_rng(q_stride)
    q = torch.from_numpy(rng.standard_normal((1, 2, 4, 16),
                                             dtype=np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 2, 3 * q_stride + 1, 16),
                                              dtype=np.float32))
    do = torch.from_numpy(rng.standard_normal((1, 2, 4, 16),
                                              dtype=np.float32))
    got, want = ([t.clone().requires_grad_(True) for t in (q, kv)]
                 for _ in range(2))
    flash_attn.flash_attention(got[0], got[1], got[1], causal=True,
                               q_stride=q_stride).backward(do)
    ref.attention_ref(want[0], want[1], want[1], causal=True,
                      q_stride=q_stride).backward(do)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.grad, w.grad, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ imports
_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch.core.pipeline, repro_torch.distributed.comm
import repro_torch.launch.mesh, repro_torch.launch.pipeline_prefill
import repro_torch.launch.flash_stride_check
import repro_torch.launch.train_step_times, repro_torch.train.loop
import repro_torch.train.graphs, repro_torch.capture
import repro_torch.kernels.flash_attn, repro_torch.kernels.ref
import repro_torch.models.lm, repro_torch.models.layers
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_new_modules_import_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("q_stride", [2, 4, 8])
def test_striped_kernel_matches_plain(cuda_device, dtype, d, q_stride):
    from repro_torch.kernels import flash_attn
    gen = torch.Generator(device=cuda_device).manual_seed(q_stride * d)
    b, hq, hkv, sq = 2, 4, 2, 70
    for g in (0, q_stride - 1):
        sk = (sq - 1) * q_stride + g + 1
        q = torch.randn((b, hq, sq, d), generator=gen, device=cuda_device)
        k = torch.randn((b, hkv, sk, d), generator=gen, device=cuda_device)
        v = torch.randn((b, hkv, sk, d), generator=gen, device=cuda_device)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        got = flash_attn.flash_attention(q, k, v, q_stride=q_stride)
        want = flash_attn.flash_attention_plain(q, k, v, q_stride=q_stride)
        tol = 2e-3 if dtype == torch.float32 else 5e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        one = flash_attn.flash_attention(q, k, v)
        assert torch.equal(one, flash_attn.flash_attention(q, k, v,
                                                           q_stride=1))
