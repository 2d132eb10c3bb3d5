"""The port's VLM (qwen2-vl's family: embedding inputs, M-RoPE) against the
JAX package's, on the same weights.

Weights come from the reference's own init (``jax.random.key(0)``),
carried across through numpy by ``repro_torch.models.convert``; embeddings
and tokens are numpy draws from a seed.  ``apply_mrope`` is held with
three *distinct* (t, h, w) position streams, where the band selection
shows (the served path feeds three equal streams, and M-RoPE then equals
RoPE value for value), also where the sections do not sum to D/2.  On the
smoke config of qwen2-vl-7b (f32, qkv bias, M-RoPE (2, 3, 3)) the port's
prefill from embeddings and four decode steps, fed token ids or (B, d)
embeddings, agree with ``repro.models.lm`` at rtol = atol = 1e-4 (the
tolerance of ``tests/test_torch_lm.py``) with a float and an int8 KV
cache, and ``ServeEngine.generate`` gives the reference engine's greedy
tokens.  The converter's round trip is bit-equal in f32 and bf16.  The
batcher takes token prompts only, as the reference's.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs.base import smoke_config as jsmoke
from repro.models import build_model as jbuild
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.models import LM
from repro_torch.models import layers as TL
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.serve import ContinuousBatcher, ServeEngine

ARCH = "qwen2-vl-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
_CACHE = {}


def _pair(kv="compute", **over):
    """(JAX model, JAX params, port model on the CPU) for the smoke
    config."""
    key = (kv, tuple(sorted(over.items())))
    if key not in _CACHE:
        jm = jbuild(dataclasses.replace(jsmoke(ARCH), kv_dtype=kv, **over))
        params = jm.init(jax.random.key(0))
        tm = params_from_reference(
            jax.tree.map(np.asarray, params),
            dataclasses.replace(tsmoke(ARCH), kv_dtype=kv, **over), "cpu")
        _CACHE[key] = (jm, params, tm)
    return _CACHE[key]


def _embeds(cfg, b=2, s=11, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("hd,sections", [(16, (2, 3, 3)), (32, (2, 3, 3)),
                                         (16, (4, 6, 8)), (32, (4, 4, 0)),
                                         (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(hd, sections):
    """Distinct t/h/w streams: each band must read its own stream.  The
    sections sum to D/2, fall short of it (the last stream drives the
    rest, also where its own section is 0) or pass it (cut); qwen2-vl-7b's
    own (16, 24, 24) at D = 128."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, hd)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (3, 2, 5)).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    got = TL.apply_mrope(_t(x), _t(pos3), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # each stream that drives a band moves the result (with (4, 6, 8) at
    # D = 16 the cut leaves the w stream none)
    for i in range(3 if sum(sections) <= hd // 2 else 2):
        other = pos3.copy()
        other[i] += 1
        assert not np.allclose(
            TL.apply_mrope(_t(x), _t(other), 1e6, sections).numpy(),
            got.numpy())


def test_positional_rotate_broadcasts_a_text_position():
    """A (B, S) position drives all three streams, as the reference's
    ``positional_rotate``; with equal streams M-RoPE is RoPE."""
    cfg = jsmoke(ARCH)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 2, cfg.hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5)[None] * 37, (2, 5)).astype(np.int32)
    got = TL.positional_rotate(tsmoke(ARCH), _t(x), _t(pos))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JL.positional_rotate(cfg, jnp.asarray(x),
                                                     jnp.asarray(pos))),
        **TOL)
    np.testing.assert_allclose(
        got.numpy(), TL.apply_rope(_t(x), _t(pos), cfg.rope_theta).numpy(),
        **TOL)


@pytest.mark.parametrize("kv", ["compute", "int8"])
@pytest.mark.parametrize("feed", ["tokens", "embeds"])
def test_prefill_from_embeds_and_decode_match_reference(kv, feed):
    """Prefill from (B, S, d) embeddings, then four decode steps fed the
    greedy token as an id (B,) or as its embedding (B, d)."""
    jm, params, tm = _pair(kv)
    assert isinstance(tm, LM)
    embeds = _embeds(jm.cfg)
    jl, jc = jax.jit(lambda p, e: jm.prefill(p, {"embeds": e}, 24))(
        params, embeds)
    tl, tc = tm.prefill(_t(embeds), 24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdec = jax.jit(jm.decode_step)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(4):
        assert (tl.numpy().argmax(-1) == tok).all()
        if feed == "embeds":
            jin = params["embed"][tok]
            tin = tm.embed[torch.as_tensor(tok, dtype=torch.int64)]
            np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
        else:
            jin, tin = tok, torch.as_tensor(tok, dtype=torch.int64)
        jl, jc = jdec(params, jc, jin)
        tl, tc = tm.decode_step(tc, tin)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert tc["length"].tolist() == [15, 15]
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


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_generate_tokens_equal_reference(kv):
    """The engine prefills from the embeddings and feeds its decode steps
    the embeddings of its tokens, as the reference's."""
    jm, params, tm = _pair(kv)
    jeng = JEngine(jm.cfg, max_len=32, params=params)
    embeds = _embeds(jm.cfg, b=3, s=9, seed=4)
    prompts = np.zeros((3, 9), np.int32)       # unused: the VLM takes embeds
    want = jeng.generate(prompts, 6, embeds=embeds)
    eng = ServeEngine(tm.cfg, max_len=32, params=tm, device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 6, embeds=embeds),
                                  want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trip_is_bit_equal(dtype):
    _, params, tm = _pair(param_dtype=dtype, compute_dtype=dtype)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_reference(tm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_batcher_refuses_embedding_inputs():
    with pytest.raises(ValueError, match="token prompts only"):
        ContinuousBatcher(tsmoke(ARCH), n_slots=2, max_len=16, device="cpu")
