"""The port's dense LM against the JAX package's, on the same weights.

Weights come from the reference's own init (``jax.random.key(0)``), carried
across through numpy by ``repro_torch.models.convert``.  On the smoke
configs of the four dense archs, and llama3.2-3b with an int8 KV cache, the
port's ``prefill`` logits and four ``decode_step`` logits agree with
``repro.models`` at rtol = atol = 1e-4 in f32 (both sum the same f32
products in different orders; the logits are O(1)), and the greedy tokens
are equal.  The converter's round trip is bit-equal.  Layers are held one by
one at the same tolerance, and bit for bit where the arithmetic is the
same (int8 KV codes and scales, the decode cache write).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs import archs as jarchs
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro_torch.configs import archs as tarchs
from repro_torch.configs.base import get_arch as tget_arch
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)

TOL = dict(rtol=1e-4, atol=1e-4)
CASES = [("llama3.2-3b", "compute"), ("gemma-2b", "compute"),
         ("qwen2-7b", "compute"), ("phi3-medium-14b", "compute"),
         ("llama3.2-3b", "int8")]
_CACHE = {}


def _pair(name, kv="compute", **over):
    """(JAX model, JAX params, port model) for a smoke config."""
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


def _t(x):
    return torch.from_numpy(np.array(x))


def test_configs_are_the_references():
    assert tarchs.ALL == jarchs.ALL
    for name in jarchs.ALL:
        assert dataclasses.asdict(tget_arch(name)) == \
            dataclasses.asdict(jget_arch(name))
        assert dataclasses.asdict(tsmoke(name)) == \
            dataclasses.asdict(jsmoke(name))


@pytest.mark.parametrize("name,kv", CASES)
def test_prefill_and_decode_match_reference(name, kv):
    jm, params, tm = _pair(name, kv)
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, 24))(
        params, toks)
    tl, tc = tm.prefill(torch.as_tensor(toks, dtype=torch.int64), 24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["length"].tolist() == [11, 11]
    jdec = jax.jit(jm.decode_step)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(4):
        assert (tl.numpy().argmax(-1) == tok).all()
        jl, jc = jdec(params, jc, tok)
        tl, tc = tm.decode_step(tc, torch.as_tensor(tok, dtype=torch.int64))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert (tl.numpy().argmax(-1) == tok).all()
    assert tc["length"].tolist() == [15, 15]
    # the caches hold the same K/V (int8: the same dequantized values)
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


@pytest.mark.parametrize("over", [{"qk_norm": True}, {"norm": "layernorm"},
                                  {"qkv_bias": True, "qk_norm": True}])
def test_config_variants_match_reference(over):
    """Options of the dense family that no smoke config sets: QK-norm, a
    LayerNorm model, biases with QK-norm (random, not zero, biases)."""
    jm, params, tm = _pair("llama3.2-3b", **over)
    if "bq" in params["positions"][0]["attn"]:
        rng = np.random.default_rng(6)
        params = jax.tree.map(lambda a: a, params)      # fresh containers
        attn = params["positions"][0]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.normal(
                size=attn[name].shape).astype(np.float32) * 0.1)
        tm = params_from_reference(jax.tree.map(np.asarray, params), tm.cfg,
                                   "cpu")
    toks = np.random.default_rng(7).integers(
        0, jm.cfg.vocab_size, (2, 9)).astype(np.int32)
    jl, jc = jm.prefill(params, {"tokens": toks}, 16)
    tl, tc = tm.prefill(torch.as_tensor(toks, dtype=torch.int64), 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    jl, _ = jm.decode_step(params, jc, tok)
    tl, _ = tm.decode_step(tc, torch.as_tensor(tok, dtype=torch.int64))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_decode_continues_prefill():
    """Prefill of S tokens then one decode step gives the logits of a
    prefill over S + 1 tokens (the cache is what the forward computes)."""
    _, _, tm = _pair("qwen2-7b")
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (3, 9)), dtype=torch.int64)
    _, cache = tm.prefill(toks[:, :8], 16)
    step, _ = tm.decode_step(cache, toks[:, 8])
    full, _ = tm.prefill(toks, 16)
    np.testing.assert_allclose(step.numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("name,dtype", [("llama3.2-3b", "float32"),
                                        ("gemma-2b", "float32"),
                                        ("qwen2-7b", "bfloat16")])
def test_converter_round_trip_is_bit_equal(name, dtype):
    jm, params, tm = _pair(name, param_dtype=dtype, compute_dtype=dtype)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_reference(tm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="keys"):
        params_from_reference({**tree, "extra": tree["embed"]}, tm.cfg,
                              "cpu")


def test_norms_rope_mlp_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(TL.rmsnorm(_t(x), _t(scale)).numpy(),
                               np.asarray(JL.rmsnorm(x, scale)), **TOL)
    np.testing.assert_allclose(
        TL.layernorm(_t(x), _t(scale), _t(bias)).numpy(),
        np.asarray(JL.layernorm(x, scale, bias)), **TOL)
    pos = np.broadcast_to(np.arange(5)[None] * 37, (2, 5))
    np.testing.assert_allclose(
        TL.apply_rope(_t(x), _t(pos), 500_000.0).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 500_000.0)), **TOL)
    for name in ("gemma-2b", "llama3.2-3b"):           # GeGLU, SwiGLU
        cfg = jsmoke(name)
        p = {k: rng.normal(size=s).astype(np.float32) / 8 for k, s in
             (("gate", (64, 128)), ("up", (64, 128)), ("down", (128, 64)))}
        h = rng.normal(size=(2, 3, 64)).astype(np.float32)
        np.testing.assert_allclose(
            TL.mlp(cfg, {k: _t(v) for k, v in p.items()}, _t(h)).numpy(),
            np.asarray(JL.mlp(cfg, p, h)), **TOL)


def test_kv_quantize_is_bit_equal():
    x = np.random.default_rng(4).normal(size=(3, 7, 2, 16)).astype(
        np.float32)
    x[0, 0, 0] = 0.0                                    # absmax 0: scale 1
    q8, sc = TL.kv_quantize(_t(x))
    jq8, jsc = JL.kv_quantize(jnp.asarray(x))
    assert np.array_equal(q8.numpy(), np.asarray(jq8))
    assert np.array_equal(sc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        TL.kv_dequantize(q8, sc, torch.float32).numpy(),
        np.asarray(JL.kv_dequantize(jq8, jsc, jnp.float32)))


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_attention_decode_writes_the_cache_in_place(kv):
    """The port's in-place write at ``length`` equals the reference's
    one-hot blend bit for bit, a row at the cache's end included (its write
    is dropped); the attention output agrees at 1e-4."""
    cfg = dataclasses.replace(jsmoke("llama3.2-3b"), kv_dtype=kv)
    jm, params, tm = _pair("llama3.2-3b", kv)
    p = jax.tree.map(lambda a: a[0], params["positions"][0]["attn"])
    rng = np.random.default_rng(5)
    b, s = 3, 8
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    length = np.array([0, 5, s], np.int32)
    kshape = (b, s, cfg.n_kv_heads, cfg.hd)
    if kv == "int8":
        ck, cv = (rng.integers(-127, 128, kshape).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(0.01, 0.1, kshape[:-1] + (1,)).astype(
            np.float32) for _ in range(2))
        jy, *jnew = JL.attention_decode(cfg, p, x, ck, cv, length, ks, vs)
        tc = [_t(a) for a in (ck, cv, ks, vs)]
        ty = TL.attention_decode(cfg, tm.layers[0].attn, _t(x), tc[0], tc[1],
                                 _t(length), tc[2], tc[3])
    else:
        ck, cv = (rng.normal(size=kshape).astype(np.float32)
                  for _ in range(2))
        jy, *jnew = JL.attention_decode(cfg, p, x, ck, cv, length)
        tc = [_t(a) for a in (ck, cv)]
        ty = TL.attention_decode(cfg, tm.layers[0].attn, _t(x), tc[0], tc[1],
                                 _t(length))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    olds = (ck, cv, ks, vs) if kv == "int8" else (ck, cv)
    for j, (got, want, old) in enumerate(zip(tc, jnew, olds)):
        want = np.asarray(want)
        # the new entry: the same K/V up to f32 rounding, so an int8 code
        # may sit one step away at a rounding boundary
        tol = dict(rtol=0, atol=1) if kv == "int8" and j < 2 else TOL
        for i, li in enumerate(length):
            keep = np.arange(s) != li
            assert np.array_equal(got.numpy()[i, keep], want[i, keep])
            assert np.array_equal(got.numpy()[i, keep], old[i, keep])
            if li < s:
                np.testing.assert_allclose(got.numpy()[i, li].astype(
                    np.float32), want[i, li].astype(np.float32), **tol)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(tsmoke("llama3.2-3b"))
