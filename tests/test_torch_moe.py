"""The port's MoE layer and MoE models against the JAX package's.

``repro_torch.models.layers.moe`` (capacity-based top-k dispatch through a
scatter into a buffer with a sentinel row, expert products, gather combine,
shared experts behind a sigmoid gate, the Switch-style aux loss) agrees with
``repro.models.layers.moe`` at rtol = atol = 1e-4 in f32, with and without
dropped tokens and shared experts; the qwen2-moe-a2.7b and
qwen3-moe-235b-a22b smoke models (weights from the reference's init) give
the reference's prefill and decode logits at 1e-4 and its greedy tokens.
The router's probabilities come from random float logits, so ``torch.topk``
and ``jax.lax.top_k`` meet no ties to break differently.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs.base import smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro_torch.configs.base import get_arch as tget_arch
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.models import layers as TL
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)

TOL = dict(rtol=1e-4, atol=1e-4)
_CACHE = {}


def _t(x):
    return torch.from_numpy(np.array(x))


def _moe_params(cfg, seed):
    p = jax.tree.map(np.asarray, JL.init_moe(cfg, jax.random.key(seed)))

    def to_t(d):
        return {k: to_t(v) if isinstance(v, dict) else _t(v)
                for k, v in d.items()}
    return p, to_t(p)


def _dropped(cfg, tp, x, c):
    """How many (token, k) slots exceed their expert's capacity ``c``."""
    probs = torch.softmax(x.float() @ tp["router"], dim=-1)
    idx = torch.topk(probs, cfg.moe.top_k, dim=-1).indices
    n = 0
    for g in range(x.shape[0]):
        counts = torch.bincount(idx[g].reshape(-1),
                                minlength=cfg.moe.n_experts)
        n += int(torch.clamp(counts - c, min=0).sum())
    return n


@pytest.mark.parametrize("name,shape,capacity", [
    ("qwen2-moe-a2.7b", (2, 13, 64), None),       # shared experts
    ("qwen2-moe-a2.7b", (3, 16, 64), 2),          # capacity drops tokens
    ("qwen3-moe-235b-a22b", (2, 9, 64), None),    # no shared experts
    ("qwen3-moe-235b-a22b", (1, 5, 64), 1),       # a decode group, drops
    ("jamba-1.5-large-398b", (2, 7, 64), None),
])
def test_moe_matches_reference(name, shape, capacity):
    cfg = jsmoke(name)
    jp, tp = _moe_params(cfg, shape[1])
    x = np.random.default_rng(shape[1]).normal(size=shape).astype(np.float32)
    jy, jaux = JL.moe(cfg, jp, x, capacity=capacity)
    ty, taux = TL.moe(cfg, tp, _t(x), capacity=capacity)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    assert ("shared" in tp) == bool(cfg.moe.n_shared)
    if capacity is not None:
        assert _dropped(cfg, tp, _t(x), capacity) > 0


@pytest.mark.parametrize("t", [1, 5, 16, 512, 4096])
def test_capacity_is_the_references(t):
    for name in ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
                 "jamba-1.5-large-398b"):
        cfg = tget_arch(name)
        m = cfg.moe
        want = max(1, min(t * m.top_k, int(np.ceil(t * m.top_k / m.n_experts
                                                  * m.capacity_factor))))
        assert TL.moe_capacity(cfg, t) == want


def _pair(name, kv="compute", **over):
    key = (name, kv, tuple(sorted(over.items())))
    if key not in _CACHE:
        jcfg = dataclasses.replace(jsmoke(name), kv_dtype=kv, **over)
        tcfg = dataclasses.replace(tsmoke(name), kv_dtype=kv, **over)
        jm = jbuild(jcfg)
        params = jm.init(jax.random.key(0))
        tm = params_from_reference(jax.tree.map(np.asarray, params), tcfg,
                                   "cpu")
        _CACHE[key] = (jm, params, tm)
    return _CACHE[key]


@pytest.mark.parametrize("name,kv", [("qwen2-moe-a2.7b", "compute"),
                                     ("qwen3-moe-235b-a22b", "compute"),
                                     ("qwen3-moe-235b-a22b", "int8")])
def test_prefill_and_decode_match_reference(name, kv):
    jm, params, tm = _pair(name, kv)
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (3, 11)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, 24))(
        params, toks)
    tt = torch.as_tensor(toks, dtype=torch.int64)
    tl, tc = tm.prefill(tt, 24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tm.prefill(tt, 24, use_kernel=False)[0].numpy(),
                               np.asarray(jl), **TOL)
    jdec = jax.jit(jm.decode_step)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(4):
        assert (tl.numpy().argmax(-1) == tok).all()
        jl, jc = jdec(params, jc, tok)
        tl, tc = tm.decode_step(tc, torch.as_tensor(tok, dtype=torch.int64))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert (tl.numpy().argmax(-1) == tok).all()
    for je, te in zip(jc["layers"], tc["layers"]):
        if kv == "int8":
            for c, s in (("k", "k_scale"), ("v", "v_scale")):
                np.testing.assert_allclose(
                    te[c].float().numpy() * te[s].numpy(),
                    np.asarray(je[c], np.float32) * np.asarray(je[s]),
                    rtol=1e-2, atol=1e-4)
        else:
            for c in ("k", "v"):
                np.testing.assert_allclose(te[c].numpy(),
                                           np.asarray(je[c]), **TOL)


def test_backbone_aux_loss_matches_reference():
    """The forward's summed aux loss, as the reference's ``backbone``."""
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm
    jm, params, tm = _pair("qwen2-moe-a2.7b")
    toks = np.random.default_rng(3).integers(0, jm.cfg.vocab_size, (2, 8))
    pos = np.broadcast_to(np.arange(8)[None], (2, 8)).copy()
    _, jaux, _ = jlm.backbone(jm.cfg, params,
                              params["embed"][toks], pos)
    tt = torch.as_tensor(toks)
    h, taux, caches = tlm.backbone(tm.cfg, tm, tm.embed[tt],
                                   torch.as_tensor(pos))
    assert caches is None and tuple(h.shape) == (2, 8, tm.cfg.d_model)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


@pytest.mark.parametrize("name,dtype", [("qwen2-moe-a2.7b", "float32"),
                                        ("qwen2-moe-a2.7b", "bfloat16"),
                                        ("qwen3-moe-235b-a22b", "bfloat16")])
def test_converter_round_trip_is_bit_equal(name, dtype):
    jm, params, tm = _pair(name, param_dtype=dtype, compute_dtype=dtype)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_reference(tm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    moe = tm.layers[0].moe
    assert moe["router"].dtype == torch.float32
    if name.startswith("qwen2"):
        assert moe["shared_gate"].dtype == torch.float32
        assert set(moe["shared"]) == {"gate", "up", "down"}
    bad = jax.tree.map(lambda a: a, tree)
    del bad["positions"][0]["moe"]["w_up"]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(bad, tm.cfg, "cpu")


def _f32_readings(flips):
    """Two MoE layers' routing readings (``chip_smoke._flip_readings``) on 2
    rows of 4 tokens, top-2 of 4 experts: the plain path routes every token
    to experts 0 and 1, the kernel path to 0 and 2 at ``flips`` ({(layer,
    row, token): both paths' margin there}); margins elsewhere 0.1, the
    router probabilities 1e-7 apart."""
    import chip_smoke
    routes = {"k": [], "p": []}
    marg = {"k": [], "p": []}
    for layer in range(2):
        plain = torch.tensor([0, 1]).expand(2, 4, 2)
        kern, m = plain.clone(), torch.full((2, 4), 0.1)
        for (at, g, t), margin in flips.items():
            if at == layer:
                kern[g, t, 1], m[g, t] = 2, margin
        probs = torch.full((2, 4, 4), 0.25)
        routes["k"].append(kern)
        routes["p"].append(plain)
        marg["k"].append((probs + 1e-7, m))
        marg["p"].append((probs, m.clone()))
    return chip_smoke._flip_readings(routes["k"], routes["p"], marg["k"],
                                     marg["p"])


@pytest.mark.parametrize("flips,loss_k,want", [
    ({}, 12.0, []),
    ({(0, 0, 1): 1e-7}, 12.0, []),                        # a near tie
    ({(0, 1, 2): 0.2}, 12.0, ["MoE layer 0"]),            # far from a tie
    ({(0, 0, 1): 1e-7, (1, 0, 3): 0.2}, 12.0, []),        # carried by row 0
    ({(1, 1, 0): 0.2}, 12.0, ["MoE layer 1"]),
    ({}, 12.01, ["loss"]),
], ids=["agree", "near-tie", "far", "carried", "far-layer-1", "loss-apart"])
def test_f32_routing_faults_are_what_f32_rounding_is_not(flips, loss_k, want):
    """``chip_smoke.py``'s hold on qwen2-moe's f32 routing: a fresh flip
    with a margin past ``MOE_F32_TIE``, or losses past
    ``MOE_F32_LOSS_REL``, fails; a near tie, and what an earlier flip of the
    row carries, pass."""
    import chip_smoke
    got = chip_smoke._f32_routing_faults(loss_k, 12.0, _f32_readings(flips))
    assert len(got) == len(want)
    assert all(g.startswith(w) for g, w in zip(got, want)), got
