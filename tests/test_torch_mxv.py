"""The port's crossbar MxV (``repro_torch.kernels``) against the JAX package.

On the CPU the wrappers run their plain PyTorch versions; the same numpy
inputs go through the JAX Pallas kernels in interpret mode.  Float path:
rtol = atol = 1e-5 (f32 sums in different orders), the bound of
``tests/test_kernels.py``.  Int8 path: 1e-6 (an exact integer sum, then the
same two f32 multiplies).  The quantizers must give int8 codes and f32
scales identical to both numpy twins and both JAX oracles, since every
plane consumes those codes.  ``test_torch_kernels_cuda.py`` holds the
CUDA kernels against the plain versions on a card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.compute_plane import quantize_matrix, quantize_rows
from repro.kernels import mxv as jmxv
from repro.kernels import ref as jref
from repro_torch.kernels import mxv, ref

SHAPES = [(1, 9, 4), (7, 36, 8), (64, 252, 28), (5, 200, 10), (3, 130, 129)]


def _inputs(b, n, m, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(m, n)).astype(np.float32)
    x = rng.normal(size=(b, n)).astype(np.float32)
    wq, ws = quantize_matrix(w)
    return x, wq, ws


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_crossbar_mxv_matches_pallas(b, n, m):
    x, wq, ws = _inputs(b, n, m, seed=b * 1000 + n)
    want = np.asarray(jmxv.crossbar_mxv_padded(x, wq, ws, interpret=True))
    before = dict(mxv.LAUNCHES)
    got = mxv.crossbar_mxv(torch.from_numpy(x), torch.from_numpy(wq),
                           torch.from_numpy(ws))
    assert mxv.LAUNCHES == before           # the CPU runs no kernel
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_crossbar_mxv_int8_matches_pallas(b, n, m):
    x, wq, ws = _inputs(b, n, m, seed=b * 1000 + n + 1)
    xq, xs = quantize_rows(x)
    want = np.asarray(jmxv.crossbar_mxv_int8_padded(xq, xs, wq, ws,
                                                    interpret=True))
    got = mxv.crossbar_mxv_int8(*(torch.from_numpy(a)
                                  for a in (xq, xs, wq, ws)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_plain_versions_match_jax_oracles(b, n, m):
    x, wq, ws = _inputs(b, n, m, seed=7 + n)
    xq, xs = quantize_rows(x)
    t = [torch.from_numpy(a) for a in (x, wq, ws, xq, xs)]
    np.testing.assert_allclose(
        ref.crossbar_mxv_ref(t[0], t[1], t[2]).numpy(),
        np.asarray(jref.crossbar_mxv_ref(x, wq, ws)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        ref.crossbar_mxv_int8_ref(t[3], t[4], t[1], t[2]).numpy(),
        np.asarray(jref.crossbar_mxv_int8_ref(xq, xs, wq, ws)))


@pytest.mark.parametrize("shape,scale", [((4, 9), 1.0), ((28, 252), 0.2),
                                         ((10, 200), 30.0), ((3, 1), 1e-3),
                                         ((5, 64), 0.0)])
def test_quantizers_identical_four_ways(shape, scale):
    rng = np.random.default_rng(shape[1])
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    if shape[1] >= 3:
        # row 0 has scale exactly 1.0, so 2.5 and -3.5 are exact ties:
        # round-half-to-even must give 2 and -4 in every implementation
        a[0, :3] = (127.0, 2.5, -3.5)
    ta = torch.from_numpy(a)
    for torch_q, numpy_q, jax_q in (
            (ref.quantize_crossbar, quantize_matrix, jref.quantize_crossbar),
            (ref.quantize_vec, quantize_rows, jref.quantize_vec)):
        tq, ts = torch_q(ta)
        nq, ns = numpy_q(a)
        jq, js = (np.asarray(v) for v in jax_q(a))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        for q, s in ((nq, ns), (jq, js)):
            np.testing.assert_array_equal(tq.numpy(), q)
            np.testing.assert_array_equal(ts.numpy(), s)


def test_strided_and_bf16_inputs():
    x, wq, ws = _inputs(6, 40, 12, seed=3)
    tw, ts = torch.from_numpy(wq), torch.from_numpy(ws)
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).T     # strided view
    assert not xt.is_contiguous()
    np.testing.assert_array_equal(
        mxv.crossbar_mxv(xt, tw, ts).numpy(),
        mxv.crossbar_mxv(torch.from_numpy(x), tw, ts).numpy())
    yb = mxv.crossbar_mxv(torch.from_numpy(x).to(torch.bfloat16), tw, ts)
    assert yb.dtype == torch.bfloat16
    want = np.asarray(jref.crossbar_mxv_ref(x, wq, ws))
    np.testing.assert_allclose(yb.float().numpy(), want, rtol=5e-2,
                               atol=5e-2 * max(1.0, np.abs(want).max()))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, wq, ws = (torch.from_numpy(a) for a in _inputs(2, 8, 4, seed=0))
    with pytest.raises(TypeError):
        mxv.crossbar_mxv(x.double(), wq, ws)
    with pytest.raises(TypeError):
        mxv.crossbar_mxv(x, wq.float(), ws)
    with pytest.raises(ValueError):
        mxv.crossbar_mxv(x[:, :7], wq, ws)
    with pytest.raises(ValueError):
        mxv.crossbar_mxv(x, wq, ws[:3])
    with pytest.raises(ValueError):
        mxv.crossbar_mxv(x, wq.T.contiguous().T, ws)   # strided crossbar
    with pytest.raises(TypeError):
        mxv.crossbar_mxv_int8(x, ws[:2], wq, ws)
    xq, xs = ref.quantize_vec(x)
    with pytest.raises(ValueError):
        mxv.crossbar_mxv_int8(xq, xs[:1], wq, ws)
    assert tuple(mxv.crossbar_mxv(x[:0], wq, ws).shape) == (0, 4)
