"""The port's attention kernels' plain versions against the JAX package's
Pallas kernels (interpret mode, CPU), on the cases of ``tests/test_kernels.py``.

On CPU tensors ``repro_torch.kernels.{flash_attn,decode_attn,
decode_attn_int8}`` run their plain PyTorch versions; these tests hold them,
through the wrappers and through ``kernels.ops``, to the Pallas kernels at
the tolerances ``tests/test_kernels.py`` states for those kernels against
their oracle: 2e-3 in f32 and 5e-2 in bf16 (flash attention, flash decode),
2e-5 (int8 decode against dequantize-then-decode) and 0.05 (int8 decode
against the unquantized decode).  The port's own extensions, the model's
(B, S, H, D) layout read through strides and one length per row, are held
row by row against the reference's ``decode_ref``.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.conv2d import crossbar_conv2d as pallas_conv2d
from repro.kernels.decode_attn import flash_decode as pallas_decode
from repro.kernels.decode_attn_int8 import flash_decode_int8 as pallas_int8
from repro.kernels.flash_attn import flash_attention as pallas_flash
from repro_torch.configs.base import smoke_config
from repro_torch.kernels import (_tensors, adamw, conv2d, decode_attn,
                                 decode_attn_int8, flash_attn, mamba_scan,
                                 mxv, ops)
from repro_torch.models import layers

REPO = pathlib.Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _quant(x):
    am = np.abs(x).max(axis=-1, keepdims=True)
    sc = np.where(am > 0, am / 127.0, 1.0).astype(np.float32)
    return np.clip(np.round(x / sc), -127, 127).astype(np.int8), sc


# -------------------------------------------------------------- flash attn
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,bq,bk", [
    (1, 4, 4, 128, 128, 64, 64, 64),      # MHA
    (2, 8, 2, 256, 256, 32, 128, 128),    # GQA 4:1
    (1, 4, 1, 128, 128, 64, 64, 32),      # MQA
    (2, 4, 2, 64, 256, 32, 64, 64),       # cross/kv-longer (decode-chunk)
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(b, hq, hkv, sq, sk, d, bq, bk,
                                              causal):
    q = RNG.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = RNG.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = RNG.normal(size=(b, hkv, sk, d)).astype(np.float32)
    want = pallas_flash(q, k, v, causal=causal, bq=bq, bk=bk)
    before = dict(flash_attn.LAUNCHES)
    got = flash_attn.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert flash_attn.LAUNCHES == before       # CPU tensors: no launch
    _close(got, want, 2e-3)
    _close(ops.attention(_t(q), _t(k), _t(v), causal=causal,
                         use_kernel=False), want, 2e-3)


def test_flash_attention_plain_bf16_matches_pallas():
    q = RNG.normal(size=(1, 4, 128, 64))
    k = RNG.normal(size=(1, 2, 128, 64))
    v = RNG.normal(size=(1, 2, 128, 64))
    want = pallas_flash(jnp.asarray(q, jnp.bfloat16),
                        jnp.asarray(k, jnp.bfloat16),
                        jnp.asarray(v, jnp.bfloat16), causal=True,
                        bq=64, bk=64)
    got = flash_attn.flash_attention(
        *(_t(x.astype(np.float32)).to(torch.bfloat16) for x in (q, k, v)),
        causal=True)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, 5e-2)


def test_flash_attention_reads_the_models_layout():
    """(B, S, H, D) tensors passed as transposed views give the result of
    the contiguous (B, H, S, D) call; the output keeps q's layout."""
    b, s, hq, hkv, d = 2, 40, 6, 2, 16
    q = RNG.normal(size=(b, s, hq, d)).astype(np.float32)
    k = RNG.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = RNG.normal(size=(b, s, hkv, d)).astype(np.float32)
    got = ops.attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                        _t(v).transpose(1, 2), causal=True)
    want = jref.attention_ref(*(np.swapaxes(x, 1, 2) for x in (q, k, v)),
                              causal=True)
    _close(got, want, 2e-3)


def test_flash_attention_refuses_bad_operands():
    q = torch.zeros(1, 4, 8, 16)
    # causal with Sq > Sk is not refused: the rows before the first key get
    # the mean of V over all Sk keys, as the Pallas kernel gives
    rng = np.random.default_rng(11)
    qn, kn, vn = (rng.normal(size=(1, h, s, 16)).astype(np.float32)
                  for h, s in ((4, 8), (2, 4), (2, 4)))
    _close(flash_attn.flash_attention(_t(qn), _t(kn), _t(vn)),
           pallas_flash(qn, kn, vn, causal=True, bq=8, bk=4), 2e-3)
    with pytest.raises(ValueError, match="multiple"):
        flash_attn.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(TypeError):
        flash_attn.flash_attention(q, q.double(), q)


def _attention_p_bf16(q, k, v, causal, bk=64):
    """Online-softmax attention of bf16 q, k, v as the tensor-core kernel
    computes it: f32 scores of the bf16 inputs, running max and sum in f32,
    and P rounded to bf16 before the P.V product, tile by tile of ``bk``
    keys (the kernel's one rounding that the f32 path has not)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(hq // hkv, 1)
    vf = v.float().repeat_interleave(hq // hkv, 1)
    qf = q.float() * d ** -0.5
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    iq = torch.arange(sq)[:, None] + (sk - sq)
    for k0 in range(0, sk, bk):
        s = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        if causal:
            ik = torch.arange(k0, min(k0 + bk, sk))[None]
            s = torch.where(ik <= iq, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, k0:k0 + bk]
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


@pytest.mark.parametrize("s", [64, 128])
def test_bf16_p_rounding_stays_within_the_pallas_kernels_bound(s):
    """The tensor-core kernel's arithmetic, emulated in plain torch on the
    CPU, against the Pallas kernel (interpret mode) on the same bf16 inputs
    at llama3.2-3b's heads (24 query, 8 KV, head dim 128): within 5e-2, the
    bf16 bound the kernel is held to on the card."""
    rng = np.random.default_rng(s)
    q, k, v = (rng.normal(size=(1, h, s, 128)).astype(np.float32)
               for h in (24, 8, 8))
    want = pallas_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                        causal=True, bq=64, bk=64)
    got = _attention_p_bf16(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                            causal=True)
    _close(got.float().numpy(), np.asarray(want, np.float32), 5e-2)
    # and the plain version, which keeps P in f32, agrees with it as closely
    plain = flash_attn.flash_attention(
        *(_t(x).to(torch.bfloat16) for x in (q, k, v)), causal=True)
    _close(got.float().numpy(), plain.float().numpy(), 5e-2)


@pytest.mark.parametrize("n", [4, 8])
def test_aligned_copies_only_what_breaks_the_load_width(n):
    """``_tensors.aligned(t, n)``: ``t`` itself where its data pointer and
    every stride but the last (which is 1) are multiples of n elements, a
    contiguous copy otherwise."""
    base = torch.arange(2 * 40 * 6 * 64, dtype=torch.float32).reshape(
        2, 40, 6, 64).to(torch.bfloat16)
    view = base.transpose(1, 2)                 # the model's layout
    assert _tensors.aligned(view, n) is view
    assert _tensors.aligned(base, n) is base
    flat = torch.zeros(base.numel() + 8, dtype=torch.bfloat16)
    flat[1:1 + base.numel()] = base.reshape(-1)
    shifted = flat[1:1 + base.numel()].view(base.shape)   # pointer + 2 bytes
    wide4 = torch.zeros(2, 40, 6, 68, dtype=torch.bfloat16)
    wide4[..., :64] = base
    narrow4 = wide4[..., :64]                   # h stride 68: 4 | 68, 8 ∤ 68
    wide2 = torch.zeros(2, 40, 6, 66, dtype=torch.bfloat16)
    wide2[..., :64] = base
    cases = [(shifted, True), (narrow4, n == 8), (wide2[..., :64], True),
             (base.transpose(2, 3), True)]      # last stride not 1
    for t, copied in cases:
        out = _tensors.aligned(t, n)
        assert (out is not t) == copied
        assert torch.equal(out, t)
        if copied:
            assert out.is_contiguous()


def test_flash_attention_takes_the_models_views_without_a_copy(monkeypatch):
    """The q, k, v views ``models.layers.attention`` hands the flash kernel
    in bf16, its (B, S, H, D) projections transposed, meet the bf16
    kernel's 8-element rule, so the wrapper reads them in place."""
    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), head_dim=32,
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = layers.init_attention(cfg, gen)
    x = torch.randn(2, 24, cfg.d_model, generator=gen).to(torch.bfloat16)
    pos = torch.arange(24)[None].expand(2, 24)
    seen = []

    def record(q, k, v, causal=True, use_kernel=True):
        seen.append((q, k, v))
        return flash_attn.flash_attention_plain(q, k, v, causal)
    monkeypatch.setattr(ops, "attention", record)
    layers.attention(cfg, p, x, pos)
    (q, k, v), = seen
    assert q.dtype == torch.bfloat16 and q.shape[-1] == 32
    for t in (q, k, v):
        assert not t.is_contiguous()            # a transposed view
        assert _tensors.aligned(t, 8) is t


# ------------------------------------------------------------- decode attn
@pytest.mark.parametrize("b,hq,hkv,s,d,bk,length", [
    (1, 8, 2, 256, 64, 128, 200),
    (4, 4, 4, 512, 32, 128, 512),
    (2, 16, 2, 256, 64, 64, 17),
])
def test_flash_decode_plain_matches_pallas(b, hq, hkv, s, d, bk, length):
    q = RNG.normal(size=(b, hq, d)).astype(np.float32)
    k = RNG.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = RNG.normal(size=(b, hkv, s, d)).astype(np.float32)
    want = pallas_decode(q, k, v, length, bk=bk)
    before = dict(decode_attn.LAUNCHES)
    got = decode_attn.flash_decode(_t(q), _t(k), _t(v), length)
    assert decode_attn.LAUNCHES == before
    _close(got, want, 2e-3)
    _close(ops.decode_attention(_t(q), _t(k), _t(v), length,
                                use_kernel=False), want, 2e-3)


@pytest.mark.parametrize("b,hq,hkv,s,d,lengths", [
    (3, 8, 2, 64, 16, [1, 40, 64]),
    (4, 6, 2, 96, 32, [96, 5, 17, 50]),
    (2, 4, 4, 32, 8, [32, 100]),          # a length past the cache: all S
])
@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_per_row_length_in_model_layout(b, hq, hkv, s, d,
                                                     lengths, quant):
    """The cache in the model's (B, S, Hkv, D) layout, seen through
    transposed views, with one length per row: row i equals the reference's
    ``decode_ref`` on row i alone with its scalar length."""
    q = RNG.normal(size=(b, hq, d)).astype(np.float32)
    k = RNG.normal(size=(b, s, hkv, d)).astype(np.float32) * 2
    v = RNG.normal(size=(b, s, hkv, d)).astype(np.float32)
    length = torch.tensor(lengths, dtype=torch.int32)
    if quant:
        (k8, ks), (v8, vs) = _quant(k), _quant(v)
        tv = [_t(x).transpose(1, 2) for x in (k8, ks, v8, vs)]
        got = ops.decode_attention_int8(_t(q), *tv, length)
        rows = [jref.decode_int8_ref(
            q[i:i + 1], *(np.swapaxes(x[i:i + 1], 1, 2)
                          for x in (k8, ks, v8, vs)), lengths[i])
            for i in range(b)]
        tol = 2e-5
    else:
        got = ops.decode_attention(_t(q), _t(k).transpose(1, 2),
                                   _t(v).transpose(1, 2), length)
        rows = [jref.decode_ref(q[i:i + 1], np.swapaxes(k[i:i + 1], 1, 2),
                                np.swapaxes(v[i:i + 1], 1, 2), lengths[i])
                for i in range(b)]
        tol = 2e-3
    _close(got, np.concatenate([np.asarray(r) for r in rows]), tol)


def test_flash_decode_refuses_bad_lengths():
    q = torch.zeros(2, 4, 8)
    k = torch.zeros(2, 2, 16, 8)
    with pytest.raises(ValueError, match="length"):
        decode_attn.flash_decode(q, k, k, torch.tensor([1, 2, 3]))
    with pytest.raises(TypeError, match="integer"):
        decode_attn.flash_decode(q, k, k, torch.tensor([1.0, 2.0]))


# ----------------------------------------------------- int8 flash decode
@pytest.mark.parametrize("b,hq,hkv,s,d,bk,length", [
    (2, 8, 2, 256, 64, 128, 200),
    (1, 4, 4, 128, 128, 64, 128),
    (3, 6, 2, 512, 32, 128, 1),
])
def test_flash_decode_int8_plain_matches_pallas(b, hq, hkv, s, d, bk,
                                                length):
    q = RNG.normal(size=(b, hq, d)).astype(np.float32)
    k8, ks = _quant(RNG.normal(size=(b, hkv, s, d)).astype(np.float32) * 2)
    v8, vs = _quant(RNG.normal(size=(b, hkv, s, d)).astype(np.float32))
    want = pallas_int8(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(ks),
                       jnp.asarray(v8), jnp.asarray(vs), length, bk=bk)
    before = dict(decode_attn_int8.LAUNCHES)
    got = decode_attn_int8.flash_decode_int8(_t(q), _t(k8), _t(ks), _t(v8),
                                             _t(vs), length)
    assert decode_attn_int8.LAUNCHES == before
    _close(got, want, 2e-5)


def test_flash_decode_int8_tracks_the_float_decode():
    """Within quantization noise of the unquantized decode (0.05, the
    reference's bound for its Pallas kernel)."""
    b, hq, hkv, s, d = 2, 8, 2, 256, 64
    q = RNG.normal(size=(b, hq, d)).astype(np.float32)
    k = RNG.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = RNG.normal(size=(b, hkv, s, d)).astype(np.float32)
    (k8, ks), (v8, vs) = _quant(k), _quant(v)
    got = decode_attn_int8.flash_decode_int8(_t(q), _t(k8), _t(ks), _t(v8),
                                             _t(vs), 256)
    _close(got, jref.decode_ref(q, k, v, 256), 0.05)


def test_unported_kernels_name_their_roadmap_item():
    """Every function of the JAX package that reaches ``pl.pallas_call`` has
    a counterpart in the port (a ``LAUNCHES`` counter of the same name), or
    else ROADMAP.md names it as still to port; the port's only kernels that
    replace none are the backwards of flash attention and of the selective
    scan (the reference differentiates its plain attention and its plain
    chunked scan) and AdamW's (``kernels/adamw.py``: the reference's
    ``adamw_update`` is plain ``jnp``, fused by XLA under its step's
    ``jax.jit``).  Since ``ops.conv2d``, the
    last to be ported, no longer raises, it is held here against the Pallas
    ``crossbar_conv2d`` (interpret mode) at its 1e-4 bound."""
    kdir = REPO / "src" / "repro" / "kernels"
    pallas = set()
    for path in kdir.glob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.FunctionDef) and "pl.pallas_call" in \
                    ast.get_source_segment(path.read_text(), node):
                pallas.add(node.name)
    assert len(pallas) == 7, pallas
    ported = set()
    for mod in (adamw, conv2d, decode_attn, decode_attn_int8, flash_attn,
                mamba_scan, mxv):
        ported |= set(mod.LAUNCHES)
    roadmap = (REPO / "ROADMAP.md").read_text()
    for name in sorted(pallas - ported):
        assert f"`{name}`" in roadmap, f"{name}: unported, not in ROADMAP"
    assert ported - pallas == {"flash_attention_bwd", "selective_scan_bwd",
                               "adamw"}, ported - pallas

    c, h, w, fl = 2, 5, 5, 3
    x = RNG.normal(size=(c, h, w)).astype(np.float32)
    wq, sc = (np.array(a) for a in
              jref.quantize_crossbar(RNG.normal(size=(fl, c * 9))
                                     .astype(np.float32)))
    want = np.asarray(pallas_conv2d(x, wq, sc, pad=1))
    y = ops.conv2d(_t(x), _t(wq), _t(sc), pad=1)
    assert tuple(y.shape) == (fl, h, w)
    _close(y.numpy(), want, 1e-4)
