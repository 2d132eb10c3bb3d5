"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports neither ``jax`` nor ``repro``, so it runs on the GPU machine:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Elsewhere every test skips.  Float kernel: rtol 1e-5 and atol 1e-5 x
max(1, max|output|): it sums in ascending k and cuBLAS in its own order, so
the rounding error scales with the terms, not the result.  Int8 kernel:
bit-equal (exact integer sums, then the same two f32 multiplies).
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
    # weights one byte past 4-byte alignment: every row takes the scalar
    # head and tail around its aligned words
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
