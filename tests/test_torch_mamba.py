"""The port's selective scan and Mamba layers against the JAX package's.

On CPU tensors ``repro_torch.kernels.mamba_scan.selective_scan`` runs its
plain PyTorch version, the oracle ``ref.selective_scan_ref``; both are held
to the Pallas ``selective_scan`` (interpret mode) on the cases of
``tests/test_kernels.py`` at its 2e-3, and the final state to the model's
``_ssm_scan_chunked`` at 1e-5 (both sum the same f32 products; the state is
O(1)).  The Mamba block (kernel and plain chunked scan), its decode step and
the falcon-mamba-7b and jamba-1.5-large-398b models (weights from the
reference's init, carried across by ``repro_torch.models.convert``) agree
with ``repro.models`` at rtol = atol = 1e-4 in f32, greedy tokens equal.
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
from repro.kernels.mamba_scan import selective_scan as pallas_scan
from repro.models import build_model as jbuild
from repro_torch.configs.base import smoke_config as tsmoke
from repro_torch.kernels import mamba_scan, ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)

TOL = dict(rtol=1e-4, atol=1e-4)
RNG = np.random.default_rng(0)
_CACHE = {}


def _t(x):
    return torch.from_numpy(np.array(x))


def _scan_inputs(b, l, d, n, u_scale=0.5, dt_scale=0.1, seed=None):
    rng = RNG if seed is None else np.random.default_rng(seed)
    u = rng.normal(size=(b, l, d)).astype(np.float32) * u_scale
    dt = np.abs(rng.normal(size=(b, l, d))).astype(np.float32) * dt_scale
    a = -np.abs(rng.normal(size=(d, n))).astype(np.float32)
    bb = rng.normal(size=(b, l, n)).astype(np.float32)
    cc = rng.normal(size=(b, l, n)).astype(np.float32)
    dsk = rng.normal(size=(d,)).astype(np.float32)
    return u, dt, a, bb, cc, dsk


# ---------------------------------------------------------------- the scan
@pytest.mark.parametrize("b,l,d,n,bd,bl,us,ds", [
    (1, 64, 32, 8, 16, 16, 0.5, 0.1),
    (2, 128, 64, 16, 32, 64, 0.5, 0.1),
    (1, 32, 16, 4, 16, 32, 0.5, 0.1),
    (1, 256, 16, 4, 16, 32, 0.3, 0.05),       # 8 chunks carry the state
])
def test_scan_plain_and_wrapper_match_pallas(b, l, d, n, bd, bl, us, ds):
    args = _scan_inputs(b, l, d, n, us, ds)
    want = np.asarray(pallas_scan(*args, bd=bd, bl=bl))
    before = dict(mamba_scan.LAUNCHES)
    got = mamba_scan.selective_scan(*map(_t, args))
    assert mamba_scan.LAUNCHES == before          # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tref.selective_scan_ref(*map(_t, args)).numpy(),
                               want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        ops.mamba_scan(*map(_t, args), use_kernel=False)[0].numpy(), want,
        rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("b,l,d,n,chunk", [
    (2, 24, 16, 4, 8), (1, 19, 32, 16, 8), (3, 1, 8, 4, 8)])
def test_scan_state_matches_chunked_scan(b, l, d, n, chunk):
    """The final state the kernel's wrapper returns is the model's
    ``_ssm_scan_chunked`` hT (ragged L and L = 1 included); the port's own
    chunked scan gives both y and hT."""
    u, dt, a, bb, cc, dsk = _scan_inputs(b, l, d, n, seed=l)
    jy, jh = JL._ssm_scan_chunked(jnp.asarray(u), jnp.asarray(dt),
                                  jnp.asarray(a), jnp.asarray(bb),
                                  jnp.asarray(cc), chunk)
    y, h = ops.mamba_scan(*map(_t, (u, dt, a, bb, cc, dsk)))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy) + dsk * u,
                               rtol=1e-5, atol=1e-5)
    ty, th = TL._ssm_scan_chunked(*map(_t, (u, dt, a, bb, cc)), chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


def test_scan_reads_strided_b_and_c():
    """B and C as column slices of one (B, L, R) projection, the model's
    layout, give the result of contiguous copies."""
    u, dt, a, bb, cc, dsk = _scan_inputs(2, 40, 24, 4, seed=3)
    proj = np.concatenate([RNG.normal(size=(2, 40, 5)).astype(np.float32),
                           bb, cc], axis=-1)
    tp = _t(proj)
    bs, cs = tp[..., 5:9], tp[..., 9:]
    assert not bs.is_contiguous()
    got = mamba_scan.selective_scan(_t(u), _t(dt), _t(a), bs, cs, _t(dsk))
    want = tref.selective_scan_ref(*map(_t, (u, dt, a, bb, cc, dsk)))
    assert torch.equal(got, want)


def test_scan_refuses_bad_operands():
    u, dt, a, bb, cc, dsk = map(_t, _scan_inputs(1, 8, 4, 2, seed=4))
    with pytest.raises(ValueError, match="shapes"):
        mamba_scan.selective_scan(u, dt, a, bb[:, :4], cc, dsk)
    with pytest.raises(TypeError, match="share"):
        mamba_scan.selective_scan(u, dt.double(), a, bb, cc, dsk)


# ------------------------------------------------------------------ layers
def _mamba_params(cfg, seed):
    p = JL.init_mamba(cfg, jax.random.key(seed))
    p = jax.tree.map(np.asarray, p)
    # a random conv bias, so that every term is exercised
    rng = np.random.default_rng(seed)
    p["conv_b"] = rng.normal(size=p["conv_b"].shape).astype(np.float32) * 0.1
    return p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("s", [2, 19, 24])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_mamba_block_matches_reference(s, use_kernel):
    """L = 24 is three chunks of 8, L = 19 one ragged chunk, L = 2 shorter
    than the conv window: there the reference's conv state has only L rows
    and the port's is zero-padded in front to K - 1."""
    cfg = jsmoke("falcon-mamba-7b")
    jp, tp = _mamba_params(cfg, s)
    x = np.random.default_rng(s).normal(size=(2, s, cfg.d_model)).astype(
        np.float32)
    jy, (jconv, jh) = JL.mamba(cfg, jp, jnp.asarray(x), return_state=True)
    ty, (tconv, th) = TL.mamba(cfg, tp, _t(x), return_state=True,
                               use_kernel=use_kernel)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    k1 = cfg.ssm.conv - 1
    assert tuple(tconv.shape) == (2, k1, 2 * cfg.d_model)
    rows = min(s, k1)
    np.testing.assert_allclose(tconv[:, k1 - rows:].numpy(),
                               np.asarray(jconv), **TOL)
    assert not tconv[:, :k1 - rows].any()
    np.testing.assert_allclose(
        TL.mamba(cfg, tp, _t(x), use_kernel=use_kernel).numpy(),
        np.asarray(jy), **TOL)


def test_mamba_decode_matches_reference():
    cfg = jsmoke("falcon-mamba-7b")
    jp, tp = _mamba_params(cfg, 7)
    rng = np.random.default_rng(7)
    din = cfg.ssm.expand * cfg.d_model
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(3, cfg.ssm.conv - 1, din)).astype(np.float32)
    ssm = rng.normal(size=(3, din, cfg.ssm.state)).astype(np.float32)
    jy, jconv, jh = JL.mamba_decode(cfg, jp, x, conv, ssm)
    ty, tconv, th = TL.mamba_decode(cfg, tp, _t(x), _t(conv), _t(ssm))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tconv.numpy(), np.asarray(jconv))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_causal_conv_and_zero_width_mlp():
    """The conv is the reference's sum of shifted products; falcon-mamba-7b's
    full-width MLP has width 0 and adds an exact zero, as the reference's."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    np.testing.assert_allclose(TL._causal_conv1d(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(JL._causal_conv1d(x, w, b)), **TOL)
    from repro_torch.configs.base import get_arch
    cfg = dataclasses.replace(get_arch("falcon-mamba-7b"), d_model=8)
    gen = torch.Generator().manual_seed(0)
    p = TL.init_mlp(cfg, gen)
    assert tuple(p["gate"].shape) == (8, 0)
    assert tuple(p["down"].shape) == (0, 8)
    y = TL.mlp(cfg, p, torch.ones(2, 3, 8, dtype=torch.bfloat16))
    assert tuple(y.shape) == (2, 3, 8) and not y.any()


@pytest.mark.parametrize("n_layers", [1, 2])
def test_attention_free_full_config_serves(n_layers):
    """falcon-mamba-7b's own config, narrowed: no attention heads
    (``n_heads=0``, so ``cfg.hd`` is undefined) and an MLP of width 0.
    Prefill, decode and the batcher's cache take it."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousBatcher, Request
    cfg = dataclasses.replace(get_arch("falcon-mamba-7b"), n_layers=n_layers,
                              d_model=32, vocab_size=64,
                              param_dtype="float32", compute_dtype="float32")
    assert cfg.n_heads == 0 and cfg.d_ff == 0
    model = build_model(cfg, "cpu")
    toks = torch.as_tensor(np.random.default_rng(9).integers(0, 64, (2, 7)))
    logits, cache = model.prefill(toks, 16)
    assert set(cache["layers"][0]) == {"conv", "ssm"}
    step, cache = model.decode_step(cache, logits.argmax(-1))
    full, _ = model.prefill(torch.cat([toks, logits.argmax(-1)[:, None]], 1),
                            16)
    np.testing.assert_allclose(step.numpy(), full.numpy(), **TOL)
    cb = ContinuousBatcher(cfg, n_slots=2, max_len=32, params=model,
                           device="cpu")
    req = Request(rid=0, prompt=np.arange(5, dtype=np.int32), max_new=3)
    cb.submit(req)
    cb.run_until_drained()
    assert req.done and len(req.out) == 3


# ------------------------------------------------------------------ models
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


def _check_model(name, kv, over, s=11):
    jm, params, tm = _pair(name, kv, **over)
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (2, s)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, 24))(
        params, toks)
    tt = torch.as_tensor(toks, dtype=torch.int64)
    plain, _ = tm.prefill(tt, 24, use_kernel=False)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jl), **TOL)
    tl, tc = tm.prefill(tt, 24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdec = jax.jit(jm.decode_step)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(4):
        assert (tl.numpy().argmax(-1) == tok).all()
        jl, jc = jdec(params, jc, tok)
        tl, tc = tm.decode_step(tc, torch.as_tensor(tok, dtype=torch.int64))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert (tl.numpy().argmax(-1) == tok).all()
    assert tc["length"].tolist() == [s + 4] * 2
    for je, te in zip(jc["layers"], tc["layers"]):
        assert set(je) == set(te)
        for c in te:
            assert te[c].dtype == getattr(torch, np.asarray(je[c]).dtype.name)
            if kv == "int8" and c in ("k", "v"):
                sc = c + "_scale"
                np.testing.assert_allclose(
                    te[c].float().numpy() * te[sc].numpy(),
                    np.asarray(je[c], np.float32) * np.asarray(je[sc]),
                    rtol=1e-2, atol=1e-4)
            else:
                np.testing.assert_allclose(te[c].numpy(), np.asarray(je[c]),
                                           **TOL)


@pytest.mark.parametrize("name,kv,over", [
    ("falcon-mamba-7b", "compute", {}),
    ("falcon-mamba-7b", "compute", {"n_layers": 3}),
    ("jamba-1.5-large-398b", "compute", {}),
    ("jamba-1.5-large-398b", "int8", {}),
])
def test_prefill_and_decode_match_reference(name, kv, over):
    _check_model(name, kv, over)


def test_decode_continues_prefill():
    """Prefill of S tokens then one decode step gives the logits of a
    prefill over S + 1 tokens (the conv and SSM states are what the forward
    computes)."""
    _, _, tm = _pair("falcon-mamba-7b", n_layers=3)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (3, 9)), dtype=torch.int64)
    _, cache = tm.prefill(toks[:, :8], 16)
    step, _ = tm.decode_step(cache, toks[:, 8])
    full, _ = tm.prefill(toks, 16)
    np.testing.assert_allclose(step.numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trip_is_bit_equal(name, dtype):
    jm, params, tm = _pair(name, param_dtype=dtype, compute_dtype=dtype)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_reference(tm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    blk = tm.layers[0].mamba
    assert blk["A_log"].dtype == blk["D"].dtype == blk["dt_b"].dtype == \
        torch.float32
