"""The port's encoder-decoder (seamless-m4t's family) against the JAX
package's, on the same weights.

Weights come from the reference's own init (``jax.random.key(0)``),
carried across through numpy by ``repro_torch.models.convert``; frame
embeddings and tokens are numpy draws from a seed.  On the smoke config of
seamless-m4t-large-v2 (f32, layernorm, 2 + 2 layers) the port's
``encode``, ``encdec_prefill`` logits and cache, and four
``encdec_decode_step`` logits and caches agree with ``repro.models.encdec``
at rtol = atol = 1e-4 (the tolerance of ``tests/test_torch_lm.py``), and
``ServeEngine.generate`` gives the reference engine's greedy tokens.  The
cross-attention is held on its own with Sq = 1 (the decode step's flash
decode) and Sq > 1, Sq != S_enc (prefill's non-causal flash attention),
and the plain non-causal flash attention with Sq != Sk at head dim 64
against the Pallas kernel in interpret mode.  The converter's round trip
is bit-equal in f32 and bf16.  The reference has no int8 cache for this
family and its batcher takes token prompts only, so both raise.
``python -m repro_torch.launch.serve --arch <arch> --reduced --device cpu``
runs with ``jax`` and ``repro`` blocked, for seamless-m4t-large-v2 and for
the VLM qwen2-vl-7b (whose other tests are in ``tests/test_torch_vlm.py``).
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

import repro.models.encdec as JE
import repro.models.layers as JL
from repro.configs.base import smoke_config as jsmoke
from repro.kernels.flash_attn import flash_attention as pallas_flash
from repro.models import build_model as jbuild
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.kernels import flash_attn
from repro_torch.models import EncDec, build_model, encdec
from repro_torch.models import layers as TL
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.serve import ContinuousBatcher, ServeEngine

ARCH = "seamless-m4t-large-v2"
TOL = dict(rtol=1e-4, atol=1e-4)
REPO = pathlib.Path(__file__).resolve().parent.parent
_CACHE = {}


def _pair(**over):
    """(JAX model, JAX params, port model on the CPU) for the smoke
    config."""
    key = tuple(sorted(over.items()))
    if key not in _CACHE:
        jm = jbuild(dataclasses.replace(jsmoke(ARCH), **over))
        params = jm.init(jax.random.key(0))
        tm = params_from_reference(jax.tree.map(np.asarray, params),
                                   dataclasses.replace(tsmoke(ARCH), **over),
                                   "cpu")
        _CACHE[key] = (jm, params, tm)
    return _CACHE[key]


def _inputs(cfg, b=2, s_enc=13, s_dec=7, seed=1):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, s_dec)).astype(np.int32)
    return embeds, toks


def _t(x):
    return torch.from_numpy(np.array(x))


def test_build_model_gives_an_encdec():
    tm = _pair()[2]
    assert isinstance(tm, EncDec) and tm.device.type == "cpu"
    assert len(tm.encoder) == 2 and len(tm.decoder) == 2
    assert "bq" not in tm.decoder[0].cross


@pytest.mark.parametrize("s", [1, 5])
def test_cross_attention_matches_reference(s):
    """Sq = 1 (a decode step: the split-KV decode over every frame) and
    Sq = 5 over 9 frames (prefill: non-causal flash attention, Sq != Sk),
    with the plain versions beside the CPU wrappers."""
    jm, params, tm = _pair()
    cfg = jm.cfg
    p = jax.tree.map(lambda a: a[0], params["decoder"]["cross"])
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jkv = JL.cross_kv(cfg, p, enc)
    jy = JL.cross_attention(cfg, p, x, jkv)
    tp = tm.decoder[0].cross
    tkv = TL.cross_kv(cfg, tp, _t(enc))
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for use in (True, False):
        ty = TL.cross_attention(cfg, tp, _t(x), tkv, use_kernel=use)
        assert ty.shape == (2, s, cfg.d_model)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("sq,sk", [(16, 48), (48, 16)])
def test_plain_noncausal_flash_attention_matches_pallas(sq, sk):
    """The CPU wrapper (the plain version) of non-causal flash attention
    with Sq != Sk at head dim 64 (seamless-m4t's) against the Pallas
    kernel in interpret mode, at 2e-3 (``tests/test_kernels.py``'s)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, sq, 64)).astype(np.float32)
    k = rng.standard_normal((2, 2, sk, 64)).astype(np.float32)
    v = rng.standard_normal((2, 2, sk, 64)).astype(np.float32)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=False, interpret=True)
    got = flash_attn.flash_attention(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_encode_prefill_and_decode_match_reference():
    jm, params, tm = _pair()
    cfg = jm.cfg
    embeds, toks = _inputs(cfg)
    np.testing.assert_allclose(
        encdec.encode(cfg, tm, _t(embeds)).numpy(),
        np.asarray(JE.encode(cfg, params, embeds)), **TOL)
    jl, jc = jax.jit(lambda p, e, t: jm.prefill(
        p, {"embeds": e, "tokens": t}, 16))(params, embeds, toks)
    tl, tc = tm.prefill(_t(embeds), torch.as_tensor(toks, dtype=torch.int64),
                        16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdec = jax.jit(jm.decode_step)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    length = tc["length"]
    for _ in range(4):
        assert (tl.numpy().argmax(-1) == tok).all()
        jl, jc = jdec(params, jc, tok)
        tl, tc = tm.decode_step(tc, torch.as_tensor(tok, dtype=torch.int64))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert tc["length"] is length                  # advanced in place
    assert tc["length"].tolist() == np.asarray(jc["length"]).tolist() == \
        [11, 11]
    for name in ("k", "v", "xk", "xv"):
        assert tc[name].shape == jc[name].shape
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def test_prefill_into_a_reset_cache_equals_a_fresh_one():
    """What the captured step needs: a prefill into a dirtied cache that
    ``reset_cache`` has reset gives a fresh prefill's logits and cache bit
    for bit; a cache of other frames is refused."""
    tm = _pair()[2]
    cfg = tm.cfg
    embeds, toks = _inputs(cfg, seed=4)
    toks = torch.as_tensor(toks, dtype=torch.int64)
    want, fresh = tm.prefill(_t(embeds), toks, 16)
    cache = tm.init_cache(2, 16, embeds.shape[1])
    for leaf in cache.values():
        leaf.fill_(3)
    encdec.reset_cache(cache)
    got, same = tm.prefill(_t(embeds), toks, 16, cache=cache)
    assert same is cache and torch.equal(got, want)
    for name, leaf in fresh.items():
        assert torch.equal(cache[name], leaf), name
    with pytest.raises(ValueError, match="frames"):
        tm.prefill(_t(embeds), toks, 16, cache=tm.init_cache(2, 16, 5))


def test_generate_tokens_equal_reference():
    jm, params, tm = _pair()
    jeng = JEngine(jm.cfg, max_len=24, params=params)
    embeds, toks = _inputs(jm.cfg, b=3, seed=5)
    want = jeng.generate(toks, 6, embeds=embeds)
    eng = ServeEngine(tm.cfg, max_len=24, params=tm, device="cpu")
    np.testing.assert_array_equal(eng.generate(toks, 6, embeds=embeds), want)
    with pytest.raises(ValueError, match="embeds"):
        eng.generate(toks, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trip_is_bit_equal(dtype):
    _, params, tm = _pair(param_dtype=dtype, compute_dtype=dtype)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_reference(tm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="keys"):
        params_from_reference({**tree, "extra": tree["embed"]}, tm.cfg,
                              "cpu")


def test_int8_cache_and_the_batcher_are_refused():
    """The reference has neither: its enc-dec cache is always in the
    compute dtype, and its batcher takes token prompts only."""
    cfg = tsmoke(ARCH)
    with pytest.raises(ValueError, match="no such path"):
        build_model(dataclasses.replace(cfg, kv_dtype="int8"), device="cpu")
    with pytest.raises(ValueError, match="token prompts only"):
        ContinuousBatcher(cfg, n_slots=2, max_len=16, device="cpu")


_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import runpy
sys.argv = ["repro_torch.launch.serve"] + sys.argv[1:]
try:
    runpy.run_module("repro_torch.launch.serve", run_name="__main__")
finally:
    assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                   for m in sys.modules if sys.modules[m] is not None)
"""


@pytest.mark.parametrize("arch", [ARCH, "qwen2-vl-7b"])
def test_launch_serve_runs_with_jax_and_repro_blocked(arch):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced
    --device cpu`` with neither ``jax`` nor ``repro`` importable: the
    engine draws the reference's embeddings for both families."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED, "--arch", arch, "--reduced",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--gen-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith(f"{arch}: prefill ")
    assert "tok/s (batch=2, prompt=8)" in res.stdout
