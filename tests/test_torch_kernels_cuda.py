"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports neither ``jax`` nor ``repro``, so it runs on the GPU machine:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Elsewhere every test skips.  Crossbar float kernel: rtol 1e-5 and atol
1e-5 x max(1, max|output|): it sums in ascending k and cuBLAS in its own
order, so the rounding error scales with the terms, not the result.  Int8
crossbar kernel: bit-equal (exact integer sums, then the same two f32
multiplies).  Attention kernels: the tolerances of ``tests/test_kernels.py``
for their Pallas twins, 2e-3 in f32 and 5e-2 in bf16 (flash attention and
flash decode; the output rounds once to bf16), 2e-5 for the int8 decode
against dequantize-then-plain in f32.  Selective scan: y and the final
state within 2e-3 x max(1, max|output|), the tolerance of
``tests/test_kernels.py`` for its Pallas twin scaled by the output's
magnitude (the kernel sums the state's columns in other orders, fuses
multiply-adds, and takes exp(x) as 2^(x log2 e) on the special-function
unit).
The bf16 flash attention kernel runs on the tensor cores (wgmma) and rounds
P to bf16 before the P.V product; it is held to the same 5e-2.
Listing-1 conv: rtol 1e-4 and atol 1e-4 x max(1, max|y|), the bound of
``tests/test_kernels.py`` for its Pallas twin scaled the same way.  Flash
attention's backward kernels: dq, dk, dv within 2e-3 x max(1, max|g|) of
``ref.attention_bwd_ref`` in f32 (the gradients sum over keys and query
heads, so the rounding error scales with their magnitude) and 2^-6 x
max|g| in bf16 (two bf16 steps at the largest value: the tensor-core
kernels round P and dS to bf16 before their products, and the output once;
``_grad_close``), and the forward's lse within 1e-5 x max(1, |lse|).  The
selective scan's backward kernels: du, ddt, dA, dB, dC, dD within 2e-3 x
max|g| of ``ref.selective_scan_bwd_ref`` in f32 and 2^-6 x max|g| in bf16
(``_scan_grad_close``: both sum in f32 and round once; scaled by max|g|
itself, since scan gradients can be far below 1).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import mxv, ref

SHAPES = [(1, 9, 4), (7, 36, 8), (64, 252, 28), (5, 200, 10), (3, 130, 129),
          (1024, 256, 256), (3, 1, 5), (9, 3, 33), (4, 64, 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    return torch.device("cuda", 0)


def _inputs(b, n, m, seed, dev):
    rng = np.random.default_rng(seed)
    wq, ws = ref.quantize_crossbar(torch.from_numpy(
        rng.normal(size=(m, n)).astype(np.float32)))
    x = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32))
    return x.to(dev), wq.to(dev), ws.to(dev)


def _assert_float_close(got, want):
    atol = 1e-5 * max(1.0, want.abs().max().item()) if want.numel() else 1e-5
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", SHAPES)
def test_kernels_match_plain(cuda_device, b, n, m):
    x, wq, ws = _inputs(b, n, m, n, cuda_device)
    before = dict(mxv.LAUNCHES)
    _assert_float_close(mxv.crossbar_mxv(x, wq, ws),
                        mxv.crossbar_mxv_plain(x, wq, ws))
    xq, xs = ref.quantize_vec(x)
    assert torch.equal(mxv.crossbar_mxv_int8(xq, xs, wq, ws),
                       mxv.crossbar_mxv_int8_plain(xq, xs, wq, ws))
    assert mxv.LAUNCHES["crossbar_mxv"] == before["crossbar_mxv"] + 1
    assert mxv.LAUNCHES["crossbar_mxv_int8"] == \
        before["crossbar_mxv_int8"] + 1


@pytest.mark.cuda
def test_strided_misaligned_bf16_and_empty(cuda_device):
    x, wq, ws = _inputs(64, 130, 28, 0, cuda_device)
    # weights one byte past 4-byte alignment: the rows go as one region and
    # are unpacked in shared memory
    buf = torch.empty(wq.numel() + 1, dtype=torch.int8, device=cuda_device)
    wmis = buf[1:].view(wq.shape)
    wmis.copy_(wq)
    xt = x.T.contiguous().T
    assert not xt.is_contiguous()
    want = mxv.crossbar_mxv_plain(x, wq, ws)
    for w in (wq, wmis):
        _assert_float_close(mxv.crossbar_mxv(xt, w, ws), want)
        xq, xs = ref.quantize_vec(x)
        assert torch.equal(mxv.crossbar_mxv_int8(xq, xs, w, ws),
                           mxv.crossbar_mxv_int8_plain(xq, xs, wq, ws))
    xb = x.to(torch.bfloat16)
    yb = mxv.crossbar_mxv(xb, wq, ws)
    assert yb.dtype == torch.bfloat16
    wb = mxv.crossbar_mxv_plain(xb, wq, ws).float()
    torch.testing.assert_close(yb.float(), wb, rtol=5e-2,
                               atol=5e-2 * max(1.0, wb.abs().max().item()))
    before = dict(mxv.LAUNCHES)
    assert tuple(mxv.crossbar_mxv(x[:0], wq, ws).shape) == (0, 28)
    assert mxv.LAUNCHES == before


@pytest.mark.cuda
def test_main_path_on_torch_plane(cuda_device):
    """lenet on the default plane (TorchPlane on the card): one float kernel
    launch per plane call, counters equal to the numpy plane's."""
    from repro_torch.core import (NumpyPlane, Simulator, build_lenet_like,
                                  compile_model, dequantize_int8, make_chip)
    chip = make_chip(8, "banded")
    prog = compile_model(build_lenet_like(), chip, quantizer=dequantize_int8)
    rng = np.random.default_rng(0)
    images = [rng.normal(size=(1, 12, 12)).astype(np.float32)
              for _ in range(3)]
    o_np, s_np = Simulator(prog, chip, compute_plane=NumpyPlane()).run(images)
    sim = Simulator(prog, chip)
    mxv.reset_launches()
    o_t, s_t = sim.run(images)
    assert sim.plane.name == "torch" and sim.plane.device.type == "cuda"
    assert mxv.LAUNCHES["crossbar_mxv"] > 0
    assert (s_t.cycles, s_t.messages) == (s_np.cycles, s_np.messages)
    for a, b in zip(o_np, o_t):
        for v in a:
            np.testing.assert_allclose(b[v], a[v], rtol=1e-5, atol=2e-5)


def _plan_boundaries(n, m, dtype, limit=4400):
    """Batch sizes on either side of each B below ``limit`` at which
    ``mxv_plan``'s layout (rows a block, k parts, threads) changes."""
    plan = mxv.mxv_plan.__wrapped__
    out, prev = {1}, None
    for b in range(1, limit):
        p = plan(b, n, m, dtype)
        key = (p.mt, p.rows, p.ks, p.kc, p.threads)
        if prev is not None and key != prev:
            out |= {b - 1, b}
        prev = key
    return sorted(out)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 8, 10, 28])
@pytest.mark.parametrize("n", [252, 256, 300])
def test_kernels_across_plan_boundaries(cuda_device, n, m):
    """Both kernels on either side of every batch size where the launch
    plan changes its layout (N = 256: 16-byte rows; 252 and 300: the float
    kernel's crossbar slice as one region, the int8 kernel's rows by 4-byte
    copies): the float kernel within its bound of the plain version, the
    int8 kernel bit-equal, and each bit-equal to itself over two
    launches."""
    for dtype in (torch.float32, torch.int8):
        for b in _plan_boundaries(n, m, dtype):
            x, wq, ws = _inputs(b, n, m, b + n, cuda_device)
            if dtype == torch.int8:
                xq, xs = ref.quantize_vec(x)
                y = mxv.crossbar_mxv_int8(xq, xs, wq, ws)
                assert torch.equal(y, mxv.crossbar_mxv_int8_plain(xq, xs, wq,
                                                                  ws)), b
                assert torch.equal(y, mxv.crossbar_mxv_int8(xq, xs, wq, ws))
            else:
                y = mxv.crossbar_mxv(x, wq, ws)
                _assert_float_close(y, mxv.crossbar_mxv_plain(x, wq, ws))
                assert torch.equal(y, mxv.crossbar_mxv(x, wq, ws)), b


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(64, 3000, 28), (4, 5000, 3),
                                   (2, 5001, 3), (3, 2001, 9)])
def test_kernels_take_k_in_chunks(cuda_device, b, n, m):
    """N past one chunk of the plan's shared memory, or one chunk above 48
    KB (the kernels' dynamic limit is raised); N = 5001 and 2001 give rows
    that are not 4-byte aligned, staged byte by byte over several chunks
    and as one region in one chunk."""
    x, wq, ws = _inputs(b, n, m, n, cuda_device)
    assert mxv.mxv_plan(b, n, m).chunk < n or \
        mxv.mxv_plan(b, n, m).smem_bytes > 48 * 1024
    _assert_float_close(mxv.crossbar_mxv(x, wq, ws),
                        mxv.crossbar_mxv_plain(x, wq, ws))
    xq, xs = ref.quantize_vec(x)
    assert torch.equal(mxv.crossbar_mxv_int8(xq, xs, wq, ws),
                       mxv.crossbar_mxv_int8_plain(xq, xs, wq, ws))


# ------------------------------------------------------------ attention
def _attn_close(got, want, dtype):
    tol = 2e-3 if dtype == torch.float32 else 5e-2
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _randn(rng, shape, dev, dtype=torch.float32, scale=1.0):
    return (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            * scale).to(dev, dtype)


def _bshd(rng, b, s, h, d, dev, dtype):
    """A (B, H, S, D) view of a contiguous (B, S, H, D) tensor: the model's
    layout as the kernels read it."""
    return _randn(rng, (b, s, h, d), dev, dtype).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (1, 4, 4, 128, 128, 64), (2, 8, 2, 256, 256, 32), (1, 4, 1, 128, 128, 64),
    (2, 4, 2, 64, 256, 32),                       # the test_kernels.py cases
    (1, 24, 8, 1, 1, 128), (2, 24, 8, 17, 17, 128), (1, 24, 8, 130, 130, 128),
    (2, 24, 8, 33, 100, 128), (1, 8, 1, 70, 70, 256),
    # Sq > Sk: causal rows before the first key get the mean of V
    (2, 24, 8, 100, 33, 128), (1, 4, 2, 64, 1, 64), (1, 8, 1, 130, 70, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain(cuda_device, b, hq, hkv, sq, sk, d,
                                       dtype, causal):
    from repro_torch.kernels import flash_attn
    rng = np.random.default_rng(sq * 1000 + sk)
    q = _bshd(rng, b, sq, hq, d, cuda_device, dtype)
    k = _bshd(rng, b, sk, hkv, d, cuda_device, dtype)
    v = _bshd(rng, b, sk, hkv, d, cuda_device, dtype)
    before = flash_attn.LAUNCHES["flash_attention"]
    got = flash_attn.flash_attention(q, k, v, causal=causal)
    assert flash_attn.LAUNCHES["flash_attention"] == before + 1
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    # the output keeps q's (B, S, H, D) memory layout
    assert got.transpose(1, 2).is_contiguous()
    _attn_close(got, want, dtype)


def _cache(rng, b, s, hkv, d, dev, dtype, quant):
    k = _randn(rng, (b, s, hkv, d), dev, scale=2.0)
    v = _randn(rng, (b, s, hkv, d), dev)
    if not quant:
        return k.to(dtype).transpose(1, 2), v.to(dtype).transpose(1, 2)

    def q8(x):
        am = x.abs().amax(-1, keepdim=True)
        sc = torch.where(am > 0, am / 127.0, torch.ones_like(am))
        return (torch.clamp(torch.round(x / sc), -127, 127).to(torch.int8)
                .transpose(1, 2), sc.transpose(1, 2))
    return q8(k) + q8(v)


# lengths 0 (every position masked: the mean of V over all S), 1,
# chunk - 1, chunk, chunk + 1 (the split kernel's 64-position chunks),
# S - 1, S and past S; G in {1, 3, 4, 7, 8, 16} and every head dim
DECODE_CASES = [
    (8, 24, 8, 2048, 128, [0, 1, 63, 64, 65, 2047, 2048, 3000]),  # llama
    (8, 24, 8, 2048, 128, [1, 17, 128, 512, 2048, 2047, 600, 33]),
    (2, 16, 16, 300, 128, [0, 300]),               # G = 1 (qwen2-moe)
    (1, 8, 2, 256, 64, [200]),                     # G = 4
    (2, 16, 2, 256, 64, [17, 256]),                # G = 8
    (4, 4, 4, 512, 32, [512, 1, 300, 77]),         # G = 1, D = 32
    (2, 6, 2, 96, 32, [0, 64]),                    # G = 3, D = 32
    (2, 40, 10, 130, 128, [65, 129]),              # G = 4 (phi3-medium)
    (2, 28, 4, 300, 128, [300, 299]),              # G = 7
    (1, 8, 1, 64, 256, [64]),                      # gemma's MQA, D = 256
    (2, 8, 1, 200, 256, [0, 199]),
    (3, 32, 2, 100, 64, [5, 100, 1000]),           # G = 16: two head groups
    (1, 32, 2, 64, 256, [64])]                     # G = 16, D = 256


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d,lengths", DECODE_CASES)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_matches_plain(cuda_device, b, hq, hkv, s, d, lengths,
                                    quant, dtype):
    """The split-KV kernels against the plain version, over the model's
    (B, S, Hkv, D) cache views read without a copy; one launch count per
    call; a second call bit-equal to the first (the merge adds the
    partials in a fixed order); a third through ``launch`` on a workspace
    filled with NaN, bit-equal too (the merge reads only the partials the
    split kernel wrote) and not counted, whose written blocks are those
    whose chunk starts below the row's length (all S for a length <= 0)."""
    from repro_torch.kernels import _tensors, decode_attn, decode_attn_int8
    rng = np.random.default_rng(s + b)
    q = _randn(rng, (b, hq, d), cuda_device, dtype)
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    if quant:
        k8, ks, v8, vs = _cache(rng, b, s, hkv, d, cuda_device, dtype, True)
        mod, name = decode_attn_int8, "flash_decode_int8"
        args = (q, k8, ks, v8, vs, length)
        cache = (k8, v8)
        call = decode_attn_int8.flash_decode_int8
        want = decode_attn_int8.flash_decode_int8_plain(*args)
    else:
        k, v = _cache(rng, b, s, hkv, d, cuda_device, dtype, False)
        mod, name = decode_attn, "flash_decode"
        args = (q, k, v, length)
        cache = (k, v)
        call = decode_attn.flash_decode
        want = decode_attn.flash_decode_plain(*args)
    for t in cache:                 # the (B, S, Hkv, D) layout, in place
        assert t.stride(2) == hkv * d and t.stride(1) == d
        assert _tensors.aligned(t, 16 // t.element_size()) is t
    before = mod.LAUNCHES[name]
    got = call(*args)
    again = call(*args)
    plan = decode_attn.decode_plan(b, hq, hkv, s, d)
    ws = torch.full(plan.workspace, float("nan"), device=cuda_device)
    nan_ws = mod.launch(*args, workspace=ws)
    torch.cuda.synchronize()
    assert mod.LAUNCHES[name] == before + 2
    assert torch.equal(got, again) and torch.equal(got, nan_ws)
    rows = [s if n <= 0 else min(n, s) for n in lengths]
    assert decode_attn.written_blocks(plan, ws) == \
        sum(-(-n // plan.chunk) for n in rows) * hkv * plan.groups
    if quant and dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        _attn_close(got, want, dtype)


@pytest.mark.cuda
def test_flash_decode_scalar_and_zero_length(cuda_device):
    """A scalar length, and rows of length 0 held to the plain version:
    every position masked gives the mean of V over all S positions, as the
    Pallas kernel and the plain version give."""
    from repro_torch.kernels import decode_attn
    rng = np.random.default_rng(5)
    q = _randn(rng, (3, 8, 64), cuda_device)
    k, v = _cache(rng, 3, 96, 2, 64, cuda_device, torch.float32, False)
    _attn_close(decode_attn.flash_decode(q, k, v, 50),
                decode_attn.flash_decode_plain(q, k, v, 50), torch.float32)
    _attn_close(decode_attn.flash_decode(q, k, v, 0),
                decode_attn.flash_decode_plain(q, k, v, 0), torch.float32)
    lengths = torch.tensor([0, 7, -3], dtype=torch.int32, device=cuda_device)
    zero = decode_attn.flash_decode(q, k, v, lengths)
    _attn_close(zero, decode_attn.flash_decode_plain(q, k, v, lengths),
                torch.float32)
    mean_v = v.float().mean(2).repeat_interleave(4, 1)
    _attn_close(zero[0], mean_v[0], torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,sq,sk", [
    (1, 3, 1, 100, 100),      # G = 3; 2 query blocks, far below 132 SMs
    (2, 8, 8, 77, 203),       # G = 1; Sq < Sk, causal offset 126
    (1, 16, 2, 1, 65),        # G = 8; one query after 64 keys
    (2, 24, 3, 130, 131),     # G = 8; 3 query blocks, ragged Sq and Sk
    (1, 8, 2, 150, 40)])      # G = 4; Sq > Sk: 110 rows before the first key
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_tensor_cores(cuda_device, d, b, hq, hkv, sq,
                                           sk, causal):
    """The tensor-core kernel at every built head dim, on lengths that are
    not multiples of its 64-query and 64- or 32-key tiles, and with more
    queries than keys."""
    from repro_torch.kernels import flash_attn
    rng = np.random.default_rng(d * 1000 + sq + sk)
    dt = torch.bfloat16
    q = _bshd(rng, b, sq, hq, d, cuda_device, dt)
    k = _bshd(rng, b, sk, hkv, d, cuda_device, dt)
    v = _bshd(rng, b, sk, hkv, d, cuda_device, dt)
    before = flash_attn.LAUNCHES["flash_attention"]
    got = flash_attn.flash_attention(q, k, v, causal=causal)
    assert flash_attn.LAUNCHES["flash_attention"] == before + 1
    want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()
    _attn_close(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_copies_only_misaligned_operands(cuda_device, dtype):
    """16-byte loads need the data pointer and the b, h, s strides to be
    multiples of 16 bytes: a view that breaks this is copied, and gives the
    plain result; the model's (B, S, H, D) projections are read in place."""
    from repro_torch.kernels import _tensors, flash_attn
    rng = np.random.default_rng(3)
    b, s, hq, hkv, d = 2, 70, 8, 2, 64
    n = 16 // torch.empty((), dtype=dtype).element_size()
    # the model's layout: projections reshaped to (B, S, H, D), transposed
    x = _randn(rng, (b, s, 96), cuda_device, dtype)
    wq = _randn(rng, (96, hq * d), cuda_device, dtype, 0.1)
    wk = _randn(rng, (96, hkv * d), cuda_device, dtype, 0.1)
    wv = _randn(rng, (96, hkv * d), cuda_device, dtype, 0.1)
    q, k, v = ((x @ w).reshape(b, s, -1, d).transpose(1, 2)
               for w in (wq, wk, wv))
    for t in (q, k, v):
        assert _tensors.aligned(t, n) is t
    want = flash_attn.flash_attention_plain(q, k, v, causal=True)
    _attn_close(flash_attn.flash_attention(q, k, v), want, dtype)
    # a data pointer off by half the load width, and a head stride that is
    # not a multiple of it
    buf = torch.empty(q.numel() + n, dtype=dtype, device=cuda_device)
    q_off = buf[n // 2:n // 2 + q.numel()].view(b, s, hq, d)
    q_off.copy_(q.transpose(1, 2))
    q_off = q_off.transpose(1, 2)
    wide = torch.zeros(b, s, hkv, d + n // 2, dtype=dtype,
                       device=cuda_device)
    wide[..., :d] = k.transpose(1, 2)
    k_wide = wide[..., :d].transpose(1, 2)
    for t in (q_off, k_wide):
        assert _tensors.aligned(t, n) is not t
    _attn_close(flash_attn.flash_attention(q_off, k_wide, v), want, dtype)


@pytest.mark.cuda
def test_flash_attention_tensor_core_kernel_fits_its_registers(cuda_device):
    """ptxas's report of the built library: the tensor-core kernel at every
    head dim keeps to the 255 registers a thread has, with no spills."""
    from repro_torch.kernels import _build
    _build.load()
    usage = {n: u for n, u in _build.resource_usage().items()
             if "flash_attention_wgmma_kernel" in n}
    assert len(usage) == 4, usage
    for name, (regs, spill_st, spill_ld) in usage.items():
        assert regs <= 255 and spill_st == 0 and spill_ld == 0, (name, regs)


@pytest.mark.cuda
def test_attention_kernels_refuse_unbuilt_head_dims(cuda_device):
    from repro_torch.kernels import decode_attn, flash_attn
    q = torch.zeros((1, 2, 4, 16), device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        flash_attn.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dims"):
        decode_attn.flash_decode(q[:, :, 0], q, q, 1)


def _grad_close(got, want, dtype, same_o=True):
    """The backward's bound: 2e-3 x max(1, max|g|) in f32.  In bf16, where
    the plain version had the kernel's own o and lse (``same_o``), two bf16
    steps at the largest value, 2^-6 x max|g|: both work in f32 and round
    once.  Against autograd of the plain attention, whose o lacks the
    forward kernel's P rounded to bf16, the forward's 5e-2 x max(1,
    max|g|)."""
    m = want.float().abs().max().item()
    if dtype == torch.float32:
        tol = 2e-3 * max(1.0, m)
    else:
        tol = 2.0 ** -6 * m if same_o else 5e-2 * max(1.0, m)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal", [
    (1, 4, 2, 77, 77, True),       # G = 2, ragged over the 64 (32) tiles
    (2, 8, 8, 64, 64, True),       # G = 1, one tile (two at D = 256)
    (1, 3, 1, 70, 130, True),      # G = 3, Sq < Sk: the last 70 positions
    (1, 6, 2, 16, 200, False),     # non-causal, Sq < Sk
    (1, 4, 4, 100, 33, False)])    # non-causal, Sq > Sk
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_matches_plain(cuda_device, d, b, hq, hkv, sq,
                                           sk, causal, dtype):
    """The forward's lse against ``attention_lse_ref`` (1e-5 x max(1,
    |lse|)), its output bit-equal to the serving call's (no lse), and the
    three backward kernels against ``attention_bwd_ref`` on the same o, lse
    and dO, twice, bit-equal (no atomics)."""
    from repro_torch.kernels import flash_attn, ref
    rng = np.random.default_rng(d * 1000 + sq + sk)
    q = _bshd(rng, b, sq, hq, d, cuda_device, dtype)
    k = _bshd(rng, b, sk, hkv, d, cuda_device, dtype)
    v = _bshd(rng, b, sk, hkv, d, cuda_device, dtype)
    do = _bshd(rng, b, sq, hq, d, cuda_device, dtype)
    o, lse = flash_attn.flash_attention_fwd(q, k, v, causal)
    assert torch.equal(o, flash_attn.flash_attention(q, k, v, causal=causal))
    _, want_lse = ref.attention_lse_ref(q, k, v, causal)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5 * max(
        1.0, want_lse.abs().max().item()))
    before = flash_attn.LAUNCHES["flash_attention_bwd"]
    got = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = flash_attn.flash_attention_bwd(q, k, v, o, lse, do, causal)
    assert flash_attn.LAUNCHES["flash_attention_bwd"] == before + 2
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for g, a, w, x in zip(got, again, want, (q, k, v)):
        assert torch.equal(g, a)
        assert g.stride() == torch.empty_like(x).stride()
        _grad_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_on_the_card(cuda_device, dtype):
    """Under autograd ``flash_attention`` launches the forward kernel (with
    lse) and, in the backward, the three backward kernels once; the
    gradients reach the model's (B, S, H, D) projections, as autograd of the
    plain version gives them."""
    from repro_torch.kernels import flash_attn, ref
    rng = np.random.default_rng(4)
    leaves = [_randn(rng, (2, 90, h, 64), cuda_device, dtype)
              .requires_grad_(True) for h in (8, 2, 2)]
    do = _bshd(rng, 2, 90, 8, 64, cuda_device, dtype)
    before = dict(flash_attn.LAUNCHES)
    out = flash_attn.flash_attention(*(t.transpose(1, 2) for t in leaves))
    assert out.grad_fn is not None
    out.backward(do)
    assert flash_attn.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert flash_attn.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    plain = [t.detach().clone().requires_grad_(True) for t in leaves]
    ref.attention_ref(*(t.transpose(1, 2) for t in plain)).backward(do)
    for got, want in zip(leaves, plain):
        _grad_close(got.grad, want.grad, dtype, same_o=False)


@pytest.mark.cuda
def test_kernels_without_backward_raise_under_autograd(cuda_device):
    """A kernel with no backward on CUDA tensors that autograd would record
    raises, instead of returning a tensor without ``grad_fn``; under
    ``torch.no_grad()`` it launches.  The selective scan has a backward
    now: recorded, it returns a tensor with ``grad_fn``, and only
    ``return_state=True`` (no gradient into hT) raises."""
    from repro_torch.kernels import (conv2d, decode_attn, flash_attn,
                                     mamba_scan, mxv, ref)
    dev = cuda_device
    q = torch.randn(2, 4, 32, device=dev, requires_grad=True)
    kv = torch.randn(2, 2, 16, 32, device=dev)
    x = torch.randn(3, 8, device=dev, requires_grad=True)
    wq, sc = ref.quantize_crossbar(torch.randn(5, 8, device=dev))
    img = torch.randn(2, 6, 6, device=dev, requires_grad=True)
    cw, csc = ref.quantize_crossbar(torch.randn(3, 18, device=dev))
    u = torch.randn(1, 8, 16, device=dev, requires_grad=True)
    a = -torch.rand(16, 4, device=dev)
    bc = torch.randn(1, 8, 4, device=dev)
    calls = [lambda: decode_attn.flash_decode(q, kv, kv, 8),
             lambda: mxv.crossbar_mxv(x, wq, sc),
             lambda: conv2d.crossbar_conv2d(img, cw, csc, pad=1),
             lambda: flash_attn.flash_attention(
                 torch.randn(1, 2, 9, 32, device=dev, requires_grad=True),
                 kv[:1, :, :4], kv[:1, :, :4], causal=True)]
    for call in calls[:-1]:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    with pytest.raises(ValueError, match="no backward"):
        calls[-1]()
    scan = [u, u.abs(), a, bc, bc, torch.ones(16, device=dev)]
    assert mamba_scan.selective_scan(*scan).grad_fn is not None
    with pytest.raises(ValueError, match="return_state"):
        mamba_scan.selective_scan(*scan, return_state=True)
    with torch.no_grad():
        mamba_scan.selective_scan(*scan, return_state=True)


@pytest.mark.cuda
def test_flash_attention_bwd_kernels_do_not_spill(cuda_device):
    """ptxas's report: every backward kernel at every head dim and dtype it
    is built for, with no spills."""
    from repro_torch.kernels import _build
    _build.load()
    usage = {n: u for n, u in _build.resource_usage().items()
             if "attn_bwd_" in n}
    # the preprocess per dtype; the CUDA-core dK/dV and dQ in f32 at four
    # head dims and in bf16 at D 256; the tensor-core pair in bf16 at D 32,
    # 64 and 128
    assert len(usage) == 2 + 2 * (4 + 1) + 2 * 3, usage
    for name, (regs, spill_st, spill_ld) in usage.items():
        assert regs <= 255 and spill_st == 0 and spill_ld == 0, (name, regs)


@pytest.mark.cuda
def test_flash_attention_bwd_bf16_kernels_run_on_wgmma(cuda_device):
    """``cuobjdump -sass`` of the built library: the bf16 backward's dK/dV
    and dQ kernels at D 32, 64 and 128 hold warpgroup tensor-core
    instructions (HGMMA), and a bf16 call at those head dims routes to
    them."""
    from repro_torch.kernels import _build, flash_attn
    _build.load()
    hgmma = {n: c["HGMMA"] for n, c in _build.sass_counts(("HGMMA",)).items()}
    for name in ("attn_bwd_dkdv_wgmma_kernel", "attn_bwd_dq_wgmma_kernel"):
        for d in (32, 64, 128):
            assert name in flash_attn.bwd_kernels(torch.bfloat16, d)
            found = [n for n in hgmma if name in n and f"ILi{d}E" in n]
            assert len(found) == 1 and hgmma[found[0]] > 0, (name, d, found)


# ---------------------------------------------------------- selective scan
def _scan_args(rng, b, l, d, n, dev, dtype, strided=False):
    u = _randn(rng, (b, l, d), dev, dtype, 0.5)
    dt = (_randn(rng, (b, l, d), dev).abs() * 0.1).to(dtype)
    a = -_randn(rng, (d, n), dev).abs()
    if strided:          # B and C as column slices of one projection
        proj = _randn(rng, (b, l, 7 + 2 * n), dev, dtype)
        bm, cm = proj[..., 7:7 + n], proj[..., 7 + n:]
    else:
        bm, cm = _randn(rng, (b, l, n), dev, dtype), \
            _randn(rng, (b, l, n), dev, dtype)
    return u, dt, a, bm, cm, _randn(rng, (d,), dev)


def _scan_close(got, want):
    tol = 2e-3 * max(1.0, want.abs().max().item())
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=2e-3, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,n,strided", [
    (1, 64, 32, 8, False), (2, 128, 64, 16, False), (1, 256, 16, 4, False),
    (1, 1, 100, 16, False), (1, 1000, 8192, 16, True), (3, 33, 130, 5, True),
    (8, 512, 1024, 16, True),
    # B = 1 at 8 lanes a channel over many steps, a ragged last round;
    # N = 1 and 2; D not a block's
    (1, 1024, 1024, 16, True), (1, 333, 136, 4, True), (1, 100, 24, 1, False),
    (2, 70, 333, 2, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_matches_plain(cuda_device, b, l, d, n, strided,
                                      dtype):
    from repro_torch.kernels import mamba_scan
    rng = np.random.default_rng(l + d)
    args = _scan_args(rng, b, l, d, n, cuda_device, dtype, strided)
    before = mamba_scan.LAUNCHES["selective_scan"]
    y, h = mamba_scan.selective_scan(*args, return_state=True)
    assert mamba_scan.LAUNCHES["selective_scan"] == before + 1
    wy, wh = ref.selective_scan_ref(*args, return_state=True)
    torch.cuda.synchronize()
    _scan_close(y, wy)
    _scan_close(h, wh)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 32, 64])
def test_selective_scan_takes_large_states(cuda_device, n):
    """N > 16 runs in groups of 16 columns (the Pallas kernel takes any
    N): y and hT against the plain version."""
    from repro_torch.kernels import mamba_scan
    args = _scan_args(np.random.default_rng(n), 1, 300, 136, n, cuda_device,
                      torch.bfloat16, strided=True)
    y, h = mamba_scan.selective_scan(*args, return_state=True)
    wy, wh = ref.selective_scan_ref(*args, return_state=True)
    torch.cuda.synchronize()
    assert mamba_scan.scan_plan(1, 300, 136, n, torch.bfloat16).groups > 1
    _scan_close(y, wy)
    _scan_close(h, wh)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d", [(8, 512, 8192), (1, 1024, 1024)])
def test_selective_scan_is_deterministic_and_never_synchronises(
        cuda_device, b, l, d):
    """Two launches give the same bits (no atomics; the groups' and the
    lanes' sums in a fixed order), and the wrapper makes no host
    synchronisation (CUDA's sync debug mode raises on one)."""
    from repro_torch.kernels import mamba_scan
    args = _scan_args(np.random.default_rng(1), b, l, d, 16, cuda_device,
                      torch.bfloat16, strided=True)
    mamba_scan.selective_scan(*args, return_state=True)   # built, loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y1, h1 = mamba_scan.selective_scan(*args, return_state=True)
        y2, h2 = mamba_scan.selective_scan(*args, return_state=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def _scan_grad_close(got, want, dtype):
    """The scan backward's bound: 2e-3 x max|g| in f32, 2^-6 x max|g| in
    bf16 (two bf16 steps at the largest value: kernels and plain version sum
    in f32 and round once), scaled by max|g| itself."""
    tol = (2e-3 if dtype == torch.float32 else 2.0 ** -6) * \
        want.float().abs().max().item()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,n,strided", [
    (2, 512, 8192, 16, True), (2, 300, 1024, 4, True), (2, 200, 2000, 17, True),
    (1, 700, 520, 64, False), (2, 1, 100, 16, False), (2, 77, 1024, 16, True),
    (1, 1000, 1024, 16, True), (4, 129, 1001, 16, True), (8, 32, 128, 4, True),
    (1, 16, 33, 1, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_bwd_matches_plain(cuda_device, b, l, d, n, strided,
                                          dtype):
    """The three backward kernels against ``ref.selective_scan_bwd_ref``,
    twice, bit-equal (no atomics), one launch counted a call."""
    from repro_torch.kernels import mamba_scan
    rng = np.random.default_rng(l * 7 + d)
    args = _scan_args(rng, b, l, d, n, cuda_device, dtype, strided)
    dy = _randn(rng, (b, l, d), cuda_device)
    before = mamba_scan.LAUNCHES["selective_scan_bwd"]
    got = mamba_scan.selective_scan_bwd(*args, dy)
    again = mamba_scan.selective_scan_bwd(*args, dy)
    assert mamba_scan.LAUNCHES["selective_scan_bwd"] == before + 2
    want = ref.selective_scan_bwd_ref(*args, dy)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _scan_grad_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_autograd_on_the_card(cuda_device, dtype):
    """Under autograd ``selective_scan`` launches the forward kernel once
    and, in the backward, the backward kernels once; B and C as column
    slices of one projection get their gradients through the slices, as
    autograd of the plain version gives them."""
    from repro_torch.kernels import mamba_scan
    rng = np.random.default_rng(9)
    b, l, d, n = 2, 150, 256, 16
    leaves = [_randn(rng, (b, l, d), cuda_device, dtype),
              torch.nn.functional.softplus(
                  _randn(rng, (b, l, d), cuda_device) - 2).to(dtype),
              -torch.exp(_randn(rng, (d, n), cuda_device)),
              _randn(rng, (b, l, 8 + 2 * n), cuda_device, dtype),
              _randn(rng, (d,), cuda_device)]
    leaves = [t.requires_grad_(True) for t in leaves]
    dy = _randn(rng, (b, l, d), cuda_device)

    def run(fn, u, dt, a, proj, dsk):
        return fn(u, dt, a, proj[..., 8:8 + n], proj[..., 8 + n:], dsk)
    before = dict(mamba_scan.LAUNCHES)
    y = run(mamba_scan.selective_scan, *leaves)
    assert y.grad_fn is not None
    y.backward(dy)
    assert mamba_scan.LAUNCHES["selective_scan"] == \
        before["selective_scan"] + 1
    assert mamba_scan.LAUNCHES["selective_scan_bwd"] == \
        before["selective_scan_bwd"] + 1
    plain = [t.detach().clone().requires_grad_(True) for t in leaves]
    run(ref.selective_scan_ref, *plain).backward(dy)
    torch.cuda.synchronize()
    for got, want in zip(leaves, plain):
        _scan_grad_close(got.grad, want.grad, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_bwd_reverse_walk_keeps_16_warps(cuda_device, dtype):
    """The reverse walk (``scan_bwd_kernel``: 256 threads, its shared
    memory and registers) keeps at least 16 warps an SM resident, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` counts them."""
    from repro_torch.kernels import mamba_scan
    occ = mamba_scan.bwd_occupancy(dtype)
    assert occ["warps"] >= 16 and occ["blocks"] * 8 == occ["warps"], occ


@pytest.mark.cuda
def test_selective_scan_bwd_kernels_do_not_spill(cuda_device):
    """ptxas's report: the three backward kernels in both dtypes, no
    spills."""
    from repro_torch.kernels import _build
    _build.load()
    usage = {n: u for n, u in _build.resource_usage().items()
             if "scan_bwd_" in n}
    assert len(usage) == 6, usage
    for name, (regs, spill_st, spill_ld) in usage.items():
        assert regs <= 255 and spill_st == 0 and spill_ld == 0, (name, regs)


# (C, H, W, FL, FH, FW, stride, pad): the CM zoo's convs, the Pallas
# kernel's test cases, a full 256-wide crossbar, a 3x3 conv over 256
# channels whose weights take several chunks, and a strided non-square one
CONV_SHAPES = [(28, 16, 16, 28, 3, 3, 1, 1), (1, 28, 28, 4, 3, 3, 1, 0),
               (4, 13, 13, 8, 3, 3, 1, 0), (4, 8, 8, 4, 3, 3, 1, 1),
               (8, 4, 1, 16, 1, 1, 1, 0), (3, 8, 8, 8, 3, 3, 1, 1),
               (4, 12, 12, 16, 3, 3, 2, 0), (1, 6, 6, 4, 1, 1, 1, 0),
               (2, 9, 7, 8, 3, 3, 1, 2), (256, 32, 32, 256, 1, 1, 1, 0),
               (256, 8, 8, 256, 3, 3, 1, 1),    # K = 2304: weights in chunks
               (6, 11, 17, 10, 3, 3, 2, 1)]     # stride 2, non-square


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w,fl,fh,fw,stride,pad", CONV_SHAPES)
@pytest.mark.parametrize("wdtype", ["int8", "f32"])
def test_crossbar_conv2d_matches_plain(cuda_device, c, h, w, fl, fh, fw,
                                       stride, pad, wdtype):
    """rtol 1e-4 and atol 1e-4 x max(1, max|y|): ``tests/test_kernels.py``'s
    bound, scaled by the output's magnitude as for the crossbar kernel (the
    kernel sums in ascending k, the plain version dequantizes first and
    cuBLAS sums in its own order)."""
    from repro_torch.kernels import conv2d
    rng = np.random.default_rng(c * h + fl)
    wf = torch.from_numpy(rng.normal(size=(fl, c * fh * fw)).astype(
        np.float32))
    if wdtype == "int8":
        wq, sc = ref.quantize_crossbar(wf)
    else:
        wq = wf
        sc = torch.from_numpy(rng.uniform(0.5, 1.5, fl).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(c, w, h)).astype(np.float32))
    wq, sc = wq.to(cuda_device), sc.to(cuda_device)
    for xx in (x.transpose(1, 2).contiguous().to(cuda_device),
               x.to(cuda_device).transpose(1, 2)):          # strided x
        before = conv2d.LAUNCHES["crossbar_conv2d"]
        y = conv2d.crossbar_conv2d(xx, wq, sc, stride=stride, pad=pad,
                                   fh=fh, fw=fw)
        assert conv2d.LAUNCHES["crossbar_conv2d"] == before + 1
        want = conv2d.crossbar_conv2d_plain(xx, wq, sc, stride, pad, fh, fw)
        torch.cuda.synchronize()
        atol = 1e-4 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(y, want, rtol=1e-4, atol=atol)
