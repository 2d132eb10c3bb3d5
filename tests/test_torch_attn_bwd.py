"""Flash attention's backward in the port: its plain versions against
``jax.vjp`` of the JAX package's attention oracle, ``FlashAttention``'s
gradients by ``gradcheck``, and the guard of the kernels without a backward.

``ref.attention_lse_ref`` (output and log-sum-exp) and
``ref.attention_bwd_ref`` (the FlashAttention-2 formulas written out, what
the backward kernels of ``csrc/flash_attn_bwd.cu`` compute) are held to
``jax.vjp`` of ``repro.kernels.ref.attention_ref`` at 1e-5 x max(1,
max|g|) in f32 (the two sum the same f32 products in other orders): causal
and not, G = 1, 2, 4, 7, ragged lengths, Sq < Sk, D 16 / 32 / 64; lse
against ``jax.nn.logsumexp`` of the same scaled, masked scores.  On CPU
tensors ``FlashAttention`` runs these plain versions with the saved tensors
the card's kernels get; ``gradcheck`` holds its gradients in f64.  The card's
kernels are held against the same plain versions by the ``cuda`` tests of
``tests/test_torch_kernels_cuda.py`` and by ``chip_smoke.py``.  The bf16
tensor-core kernels' arithmetic (P and dS rounded to bf16 before their
products) is emulated in plain torch and held to ``jax.vjp`` within the
bf16 bound the card's kernels are held to, 2^-6 x max|g|, which two planted
faults miss.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import (_tensors, decode_attn, flash_attn, mxv,
                                 ops, ref)

RNG = np.random.default_rng(11)

CASES = [  # b, hq, hkv, sq, sk, d, causal
    (2, 4, 4, 16, 16, 16, True),       # G = 1
    (1, 4, 2, 33, 33, 32, True),       # G = 2, ragged
    (2, 8, 2, 77, 77, 64, True),       # G = 4, ragged over 64-wide tiles
    (1, 7, 1, 20, 20, 16, True),       # G = 7
    (2, 4, 2, 24, 24, 32, False),      # non-causal
    (1, 8, 2, 5, 40, 16, False),       # Sq < Sk, non-causal
    (1, 4, 2, 9, 31, 32, True),        # Sq < Sk, causal (the last 9)
    (2, 14, 2, 17, 17, 64, False),     # G = 7, non-causal, ragged
]


def _inputs(b, hq, hkv, sq, sk, d):
    q = RNG.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = RNG.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = RNG.normal(size=(b, hkv, sk, d)).astype(np.float32)
    do = RNG.normal(size=(b, hq, sq, d)).astype(np.float32)
    return q, k, v, do


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _jax_lse(q, k, causal):
    d, sq, sk = q.shape[-1], q.shape[2], k.shape[2]
    kr = jnp.repeat(k, q.shape[1] // k.shape[1], axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, kr) / (d ** 0.5)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((sq, sk), bool), k=sk - sq), s,
                      -1e30)
    return jax.nn.logsumexp(s, axis=-1)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", CASES)
def test_backward_formulas_match_jax_vjp(b, hq, hkv, sq, sk, d, causal):
    q, k, v, do = _inputs(b, hq, hkv, sq, sk, d)
    out, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(a, b_, c, causal),
                       q, k, v)
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = ref.attention_lse_ref(tq, tk, tv, causal)
    _close(o, out)
    _close(lse, _jax_lse(q, k, causal))
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
    dq, dk, dv = ref.attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got, want)
    # the same through the Function (the CPU path of the card's kernels)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o2 = flash_attn.flash_attention(*leaves, causal=causal)
    assert o2.grad_fn is not None and torch.equal(o2, o)
    o2.backward(tdo)
    for leaf, want in zip(leaves, (dq, dk, dv)):
        assert torch.equal(leaf.grad, want)


def test_bf16_gradients_keep_their_dtype():
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(1, 4, 2, 12, 12, 32))
    o, lse = ref.attention_lse_ref(q, k, v, True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    grads = ref.attention_bwd_ref(q, k, v, o, lse, do, True)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3


@pytest.mark.parametrize("causal,sq,sk,hq,hkv", [
    (True, 7, 7, 4, 2), (False, 5, 9, 6, 2), (True, 5, 9, 4, 1),
    (False, 9, 4, 3, 3)])
def test_function_gradcheck_f64(causal, sq, sk, hq, hkv):
    gen = torch.Generator().manual_seed(sq * 10 + sk)
    args = [torch.randn(2, h, s, 16, dtype=torch.float64, generator=gen,
                        requires_grad=True)
            for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_attn.FlashAttention.apply(a, b, c, causal),
        args)


def test_model_layout_views_get_gradients_in_their_layout():
    """The model passes (B, S, H, D) projections as transposed views; the
    gradients come back to them as autograd of the plain version gives."""
    q, k, v, do = _inputs(2, 6, 2, 19, 19, 16)
    base = [torch.from_numpy(x.transpose(0, 2, 1, 3).copy())
            .requires_grad_(True) for x in (q, k, v)]
    o = ops.attention(*(t.transpose(1, 2) for t in base))
    o.backward(torch.from_numpy(do))
    plain = [t.detach().clone().requires_grad_(True) for t in base]
    ref.attention_ref(*(t.transpose(1, 2) for t in plain)).backward(
        torch.from_numpy(do))
    for got, want in zip(base, plain):
        _close(got.grad, want.grad.numpy())


def test_no_backward_for_rows_before_the_first_key():
    q = torch.randn(1, 2, 9, 16, requires_grad=True)
    k = torch.randn(1, 2, 4, 16)
    with pytest.raises(ValueError, match="no backward"):
        flash_attn.flash_attention(q, k, k, causal=True)
    with torch.no_grad():            # serving still takes it: mean of V
        flash_attn.flash_attention(q, k, k, causal=True)
    flash_attn.flash_attention(q, k, k, causal=False).sum().backward()


def test_backward_checks_its_operands():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 8, 8, 16))
    o, lse = ref.attention_lse_ref(q, k, v, True)
    with pytest.raises(ValueError, match="lse"):
        flash_attn.flash_attention_bwd(q, k, v, o, lse[:, :, :4], do)
    with pytest.raises(ValueError, match="must match q"):
        flash_attn.flash_attention_bwd(q, k, v, o, lse, do[:, :, :4])
    before = dict(flash_attn.LAUNCHES)
    flash_attn.flash_attention_bwd(q, k, v, o, lse, do)
    assert flash_attn.LAUNCHES == before          # CPU tensors: no launch


def test_guard_of_the_kernels_without_backward():
    """The wrappers with no backward raise on CUDA tensors where autograd
    would record them; this is the shared condition, checked here on CPU
    tensors, where the wrappers run their differentiable plain versions."""
    x = torch.randn(3, 4)
    w = torch.randn(3, 4, requires_grad=True)
    assert not _tensors.grad_needed(x)
    assert _tensors.grad_needed(x, w)
    with torch.no_grad():
        assert not _tensors.grad_needed(x, w)
        _tensors.check_no_grad("k", x, w)
    assert not _tensors.grad_needed(x, w.detach(), None, 3)
    with pytest.raises(RuntimeError, match="k: the CUDA kernel has no "
                                           "backward"):
        _tensors.check_no_grad("k", x, w)
    # the plain versions on the CPU stay differentiable
    wq, sc = ref.quantize_crossbar(torch.randn(5, 4))
    mxv.crossbar_mxv(x.requires_grad_(True), wq, sc).sum().backward()
    assert x.grad is not None
    q = torch.randn(2, 4, 8, requires_grad=True)
    kv = torch.randn(2, 2, 6, 8)
    decode_attn.flash_decode(q, kv, kv, 4).sum().backward()
    assert q.grad is not None


def _attention_bwd_bf16(q, k, v, o, lse, do, causal, bt=64):
    """(dq, dk, dv) of bf16 q, k, v, o, dO as the tensor-core backward
    kernels compute them: f32 products of the bf16 inputs; P and dS rounded
    to bf16 before the dV, dK and dQ products; f32 sums in the kernels'
    tile order (dK and dV by tile of ``bt`` keys, over the G query heads,
    then the query tiles from the causal diagonal on; dQ by tile of ``bt``
    queries, over the key tiles up to the diagonal); each gradient rounded
    once to bf16."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g, off, scale = hq // hkv, sk - sq, d ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1, keepdim=True)          # preprocess
    kr, vr = (t.repeat_interleave(g, 1) for t in (kf, vf))
    p = torch.exp(qf @ kr.transpose(-1, -2) * scale - lse[..., None])
    if causal:
        ik = torch.arange(sk)[None]
        p = torch.where(ik <= torch.arange(sq)[:, None] + off, p, 0.0)
    ds = p * (dof @ vr.transpose(-1, -2) - delta)
    # (B, Hkv, G, ...) views: query head h is KV head h // G's h % G
    pb, dsb = (x.bfloat16().float().view(b, hkv, g, sq, sk) for x in (p, ds))
    qg, dog = (x.view(b, hkv, g, sq, d) for x in (qf, dof))
    dk, dv = torch.zeros(b, hkv, sk, d), torch.zeros(b, hkv, sk, d)
    for k0 in range(0, sk, bt):
        ks = slice(k0, k0 + bt)
        t_first = max(0, k0 - off) // bt if causal else 0
        for gi in range(g):
            for q0 in range(t_first * bt, sq, bt):
                qs = slice(q0, q0 + bt)
                dv[:, :, ks] += pb[:, :, gi, qs, ks].transpose(-1, -2) \
                    @ dog[:, :, gi, qs]
                dk[:, :, ks] += dsb[:, :, gi, qs, ks].transpose(-1, -2) \
                    @ qg[:, :, gi, qs]
    dsq = dsb.view(b, hq, sq, sk)
    dq = torch.zeros(b, hq, sq, d)
    for q0 in range(0, sq, bt):
        qs = slice(q0, q0 + bt)
        kv_end = min(sk, min(q0 + bt, sq) + off) if causal else sk
        for k0 in range(0, kv_end, bt):
            dq[:, :, qs] += dsq[:, :, qs, k0:k0 + bt] @ kr[:, :, k0:k0 + bt]
    return ((dq * scale).bfloat16(), (dk * scale).bfloat16(),
            dv.bfloat16())


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", [
    (1, 24, 8, 128, 128, True),       # llama3.2-3b's heads
    (1, 24, 8, 512, 128, True),
    (1, 16, 16, 128, 64, False),      # seamless-m4t's encoder heads
])
def test_bf16_backward_arithmetic_stays_within_the_cards_bound(
        b, hq, hkv, s, d, causal):
    """The tensor-core backward's arithmetic, emulated in plain torch on
    the CPU, against ``jax.vjp`` of the JAX package's attention oracle on
    the same bf16-rounded inputs: dq, dk and dv within 2^-6 x max|g|, the
    bound the card's bf16 backward is held to (``chip_smoke._bwd_limit``);
    both of ``chip_smoke._bwd_faults``' planted faults (query head 0 left
    out, queries 64-127 left out: dO zeroed there) miss it."""
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(b, hq, hkv, s, s, d))
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(a, b_, c, causal),
                     *(x.float().numpy() for x in (q, k, v)))
    want = vjp(jnp.asarray(do.float().numpy()))
    o, lse = ref.attention_lse_ref(q, k, v, causal)
    got = _attention_bwd_bf16(q, k, v, o, lse, do, causal)
    head, tile = do.clone(), do.clone()
    head[:, 0] = 0
    tile[:, :, 64:128] = 0
    faults = [ref.attention_bwd_ref(q, k, v, o, lse, x, causal)
              for x in (head, tile)]
    for i, (g, w) in enumerate(zip(got, want)):
        w = torch.from_numpy(np.array(w))
        limit = 2.0 ** -6 * w.abs().max().item()
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert (g.float() - w).abs().max().item() <= limit
        for f in faults:
            assert (f[i].float() - w).abs().max().item() > limit
